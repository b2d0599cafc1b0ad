"""Two-lane stream-format conversions — the reference's IO buffer suite.

The reference moves data between three stream formats with dedicated RAM
buffers; here each is a pure layout transform (a copy at memory
bandwidth, or a view):

* half/half    — lane A = x[0 : N/2], lane B = x[N/2 : N]
  (``inbuf_half_path.vhd`` splits, ``outbuf_half_path.vhd`` merges)
* interleave-2 — lane A = even samples, lane B = odd samples
  (``iobuf_flow_int2.vhd`` / ``iobuf_wrap_int2.vhd`` corner-turn between
  interleave-2 and half/half, optionally fused with bit-reversal)
* PAIR bit-reversal — reverse all index bits EXCEPT the MSB, the form
  needed when two lanes carry even/odd interleaved data
  (``int_bitrev_order.vhd:82-104``, generic PAIR=TRUE)

All are batched over leading dims; arrays are [..., n] or lane pairs
([..., n/2], [..., n/2]), NumPy arrays or torch tensors.  A copy of
``intfftk_tpu/utils/lanes.py`` whose ``_xp`` picks torch where the JAX one
picks jax.numpy; held equal to it by ``tests/test_torch_utils.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..golden.float_model import bitrev_indices


def split_halves(x):
    """Natural stream -> (lane A, lane B) half/half (inbuf_half_path)."""
    h = x.shape[-1] // 2
    return x[..., :h], x[..., h:]


def _xp(a):
    return torch if isinstance(a, torch.Tensor) else np


def merge_halves(a, b):
    """(lane A, lane B) half/half -> natural stream (outbuf_half_path)."""
    return _xp(a).concatenate([a, b], axis=-1)


def interleave2_to_halves(a, b):
    """(even, odd) lanes -> (first half, second half) lanes — the
    BITREV=FALSE corner turn of ``iobuf_*_int2``."""
    full = _riffle(a, b)
    return split_halves(full)


def halves_to_interleave2(a, b):
    """(first half, second half) -> (even, odd) — the BITREV=TRUE turn."""
    full = merge_halves(a, b)
    return full[..., 0::2], full[..., 1::2]


def _riffle(a, b):
    stacked = _xp(a).stack([a, b], axis=-1)
    return stacked.reshape(a.shape[:-1] + (2 * a.shape[-1],))


def bitrev_pair_indices(n: int) -> np.ndarray:
    """PAIR=TRUE bit-reversal: MSB kept, remaining bits reversed
    (``int_bitrev_order.vhd:82-104``)."""
    h = n // 2
    rev = bitrev_indices(h)
    return np.concatenate([rev, rev + h])


def bitrev_pair(x):
    """Apply the PAIR reorder along the last axis."""
    return x[..., bitrev_pair_indices(x.shape[-1])]
