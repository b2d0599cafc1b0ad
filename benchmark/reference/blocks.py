"""Overlap-save output of chosen blocks of a signal.

``overlap_save_int`` transforms every block of a signal.  A check that
reads a sample of the blocks needs only those: block j's window is the
M - 1 samples before payload j and the payload itself, so its output
depends on nothing else, and the same forward transform, product and
inverse on that window alone give the same integers.
"""

from __future__ import annotations

import numpy as np

from .convolve import ConvSpec, _block_fft
from .int_model import cmult_int


def overlap_save_blocks(x_re, x_im, spectrum, spec: ConvSpec, blocks):
    """Blocks ``blocks`` of the overlap-save output of a 1-D signal x.

    ``spectrum`` is ``taps_spectrum_int(h_re, h_im, spec)``.  Returns
    (y_re, y_im) of shape [len(blocks), payload]: row i is samples
    [j * L, (j + 1) * L) of ``overlap_save_int(x, h, spec)`` for
    j = blocks[i]."""
    n, m, lpay = spec.n, spec.taps_len, spec.payload
    hr, hi = spectrum
    zh = np.zeros(m - 1, dtype=np.int64)
    er = np.concatenate([zh, np.asarray(x_re, dtype=np.int64)])
    ei = np.concatenate([zh, np.asarray(x_im, dtype=np.int64)])
    idx = (np.asarray(blocks)[:, None] * lpay + np.arange(n)[None, :])
    fr, fi = _block_fft(er[idx], ei[idx], spec.fft_cfg, spec)
    pr, pi = cmult_int(fr, fi, hr, hi, spec.product_shift,
                       spec.product_width)
    yr, yi = _block_fft(pr, pi, spec.ifft_cfg, spec, inverse=True)
    return yr[:, m - 1:], yi[:, m - 1:]
