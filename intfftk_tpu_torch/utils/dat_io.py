"""Reference-format .dat stimulus/response file IO.

A copy of ``intfftk_tpu/utils/dat_io.py`` (NumPy only), held equal to it
by ``tests/test_torch_utils.py``.

The reference's golden flow exchanges integer samples through whitespace
text files: ``math/fft_single.m:94-96`` writes ``di_single.dat`` as
"%d %d\\n" (re, im) rows; the pair testbench consumes a four-column
``di_double.dat`` and dumps ``dout_pair.dat``
(``src/vhdl/tb/fft_double_test.vhd:129,201``).  These helpers read/write
that format so stimulus and responses interchange with the reference's
Octave/testbench tooling.
"""

from __future__ import annotations

import numpy as np


def write_dat(path: str, *columns) -> None:
    """Write integer columns as whitespace-separated rows.

    ``write_dat(p, re, im)`` produces the ``di_single.dat`` layout;
    four columns produce the two-lane ``di_double.dat`` layout.
    """
    cols = [np.asarray(c).ravel().astype(np.int64) for c in columns]
    n = len(cols[0])
    if any(len(c) != n for c in cols):
        raise ValueError("columns must have equal length")
    data = np.stack(cols, axis=1)
    np.savetxt(path, data, fmt="%d")


def read_dat(path: str):
    """Read a .dat file; returns a tuple of int64 column arrays."""
    data = np.loadtxt(path, dtype=np.int64, ndmin=2)
    return tuple(data[:, i] for i in range(data.shape[1]))
