"""Two-lane structural golden model — the hardware's streaming schedule.

Runs the *same* butterfly arithmetic as ``int_model.py`` but routes data the
way the silicon does: two lanes (A = first half, B = second half,
``int_fftNk.vhd:91-101``), every stage butterflies lane-A[i] against
lane-B[i] elementwise, then the cross-commutation delay network
(``int_delay_line.vhd:60-144``, vectorized in
``float_model.cross_commutate``) reorders lanes for the next stage.

Bit-for-bit equality of this model with the natural-order in-place model is
a standing test: it proves the in-place index algebra used by the TPU
kernels is exactly the dataflow the reference hardware implements.
"""

from __future__ import annotations

import numpy as np

from ..config import FFTConfig
from .float_model import bitrev_indices, cross_commutate, cross_commutate_inv
from .int_model import dif_butterfly_int, dit_butterfly_int, needs_object


def _lane_twiddle_indices(p: int, count: int) -> np.ndarray:
    """Twiddle index of each lane position: the hardware streams k = 0..2^p-1
    repeatedly (``rom_twiddle_int.vhd:187-202``), which is the index form of
    ``fn_twiddleN_dif`` (``math/fn_radix2.m:109-117``)."""
    return np.tile(np.arange(1 << p), count >> p)


def fft_int_lanes(x_re, x_im, cfg: FFTConfig, inverse: bool = False):
    """Integer transform through the explicit two-lane schedule.

    Same contract as ``int_model.fft_int`` (natural in / natural out,
    identical bits)."""
    n, nl = cfg.n, cfg.stages
    dt = object if needs_object(cfg) else np.int64
    xr = np.asarray(x_re, dtype=dt).ravel().copy()
    xi = np.asarray(x_im, dtype=dt).ravel().copy()
    assert xr.size == n

    rev = bitrev_indices(n)
    if not inverse:
        ar, ai = xr[: n // 2], xi[: n // 2]
        br, bi = xr[n // 2 :], xi[n // 2 :]
    else:
        xrr, xri = xr[rev], xi[rev]
        ar, ai = xrr[0::2], xri[0::2]
        br, bi = xrr[1::2], xri[1::2]

    for i in range(1, nl + 1):  # 1-based stage index as in fn_radix2.m
        s = i - 1
        p = cfg.stage_twiddle_order(s, inverse)
        in_w = cfg.stage_input_width(s)
        k = _lane_twiddle_indices(p, n // 2)
        if not inverse:
            oar, oai, obr, obi = dif_butterfly_int(ar, ai, br, bi, k, p,
                                                   cfg, in_w)
            if i < nl:
                ar, br = cross_commutate(oar, obr, i, n)
                ai, bi = cross_commutate(oai, obi, i, n)
            else:
                ar, ai, br, bi = oar, oai, obr, obi
        else:
            oar, oai, obr, obi = dit_butterfly_int(ar, ai, br, bi, k, p,
                                                   cfg, in_w)
            if i < nl:
                ar, br = cross_commutate_inv(oar, obr, i, n)
                ai, bi = cross_commutate_inv(oai, obi, i, n)
            else:
                ar, ai, br, bi = oar, oai, obr, obi

    if not inverse:
        # interleave lanes then bit-reverse to natural (fn_radix2.m:182-189)
        out_r = np.empty(n, dtype=dt)
        out_i = np.empty(n, dtype=dt)
        out_r[0::2], out_r[1::2] = ar, br
        out_i[0::2], out_i[1::2] = ai, bi
        return out_r[rev], out_i[rev]
    return np.concatenate([ar, br]), np.concatenate([ai, bi])
