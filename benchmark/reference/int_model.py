"""Exact integer golden model — the bit-level oracle of the framework.

Reproduces the reference butterfly arithmetic bit-for-bit in NumPy:

* DIF forward butterfly (``reference/src/vhdl/fft/int_dif2_fly.vhd``):
  X = A + B, Y = (A - B) * W, with three numeric paths —
  - TRUNCATE (scaled):  operands are arithmetically >>1 *before* the add
    (``int_dif2_fly.vhd:144-164``: the DSP adder is fed ia(DTW-1 downto 1)),
  - ROUND (scaled):     full-width add, then round-half-up on the LSB
    (``:167-219``: out = (s >> 1) + (s & 1)),
  - UNSCALED:           full-width add, output grows one bit (``:221-241``).
* DIT inverse butterfly (``int_dit2_fly.vhd``): X = A + B*W, Y = A - B*W —
  multiply *before* the add; TRUNCATE drops the LSB of both add operands
  (A and B*W, ``int_dit2_fly.vhd:142-162``); conjugation is realized by
  re/im swap into/out of the forward-twiddle multiplier (``:304-322``),
  which is bit-identical to multiplying by the conjugated integer table.
* Complex multiply renormalization: product >> (TWD-1) for twiddle width
  <= 18, >> (TWD-2) above, slice = floor
  (``int_cmult_dsp48.vhd:189-190,316-317``).
* Trivial-twiddle stages: W order p = 0 -> no multiply; p = 1 -> {1, -j}
  (forward) / {1, +j} (inverse) via re/im swap + guarded two's-complement
  negate: -x for x >= 0, but ~x = -x-1 for x < 0 (the most-negative-value
  guard, ``int_dif2_fly.vhd:281-304``, ``int_dit2_fly.vhd:252-276``).

The model is natural-order in-place; ``lane_model.py`` computes the same
bits through the hardware's two-lane commutation schedule (equality of the
two is a test).  The butterfly primitives below are shared by both and are
the arithmetic spec the TPU kernels implement.
"""

from __future__ import annotations

import numpy as np

from .config import FFTConfig
from .float_model import bitrev_indices
from .twiddle import stage_twiddles_int


def neg_guarded(x: np.ndarray) -> np.ndarray:
    """Two's-complement negate with the reference's most-negative guard:
    positive -> not(x)+1 = -x, negative -> not(x) = -x-1."""
    return np.where(x >= 0, -x, -x - 1)


def round_half_up(v: np.ndarray) -> np.ndarray:
    """Divide by two rounding half toward +inf: (v >> 1) + (v & 1)."""
    return (v >> 1) + (v & 1)


def wrap_width(v: np.ndarray, w: int) -> np.ndarray:
    """Wrap to a signed w-bit register (hardware slice semantics)."""
    if w >= 63:
        return v
    m = np.int64(1) << (w - 1)
    return ((v + m) & ((np.int64(1) << w) - 1)) - m


def needs_object(cfg: FFTConfig) -> bool:
    """int64 suffices unless max data width + twiddle width + 1 > 63."""
    return cfg.output_width + cfg.twiddle_width + 1 > 63


def _stage_tables(p: int, cfg: FFTConfig):
    w_re, w_im = stage_twiddles_int(p, cfg.twiddle_width, cfg.twiddle_gen)
    if needs_object(cfg):
        w_re, w_im = w_re.astype(object), w_im.astype(object)
    return w_re, w_im


def cmult_int(br, bi, c, d, shift: int, out_width: int, wrap: bool = True):
    """Integer complex multiply (B) * (c + jd) with floor renormalization.

    re = (br*c - bi*d) >> shift,  im = (bi*c + br*d) >> shift — the shift is
    applied to the *summed* product (DSP48 PCIN cascade adds full-precision
    partials before the output slice, ``int_cmult18x25_dsp48.vhd:106-225``).
    """
    pr = (br * c - bi * d) >> shift
    pi = (bi * c + br * d) >> shift
    if wrap:
        pr, pi = wrap_width(pr, out_width), wrap_width(pi, out_width)
    return pr, pi


def dif_butterfly_int(ar, ai, br, bi, k, p: int, cfg: FFTConfig, in_w: int):
    """One forward (DIF) butterfly: returns (X, Y) = (A+B, (A-B)*W_k).

    ``k``: integer twiddle indices broadcastable against the operands
    (k in [0, 2^p)).  ``in_w``: data width entering this stage.
    """
    scale, rnd = cfg.scale, cfg.rounding == "round"
    out_w = in_w + 1 - scale
    if scale and not rnd:
        ar, ai, br, bi = ar >> 1, ai >> 1, br >> 1, bi >> 1
        sr, si = ar + br, ai + bi
        dr, di = ar - br, ai - bi
    elif scale and rnd:
        sr, si = round_half_up(ar + br), round_half_up(ai + bi)
        dr, di = round_half_up(ar - br), round_half_up(ai - bi)
    else:
        sr, si = ar + br, ai + bi
        dr, di = ar - br, ai - bi
    sr, si = wrap_width(sr, out_w), wrap_width(si, out_w)
    dr, di = wrap_width(dr, out_w), wrap_width(di, out_w)

    if p == 0:
        yr, yi = dr, di
    elif p == 1:
        odd = (k & 1).astype(bool)
        yr = np.where(odd, di, dr)
        yi = np.where(odd, neg_guarded(dr), di)
    else:
        w_re, w_im = _stage_tables(p, cfg)
        yr, yi = cmult_int(dr, di, w_re[k], w_im[k], cfg.twiddle_shift, out_w)
    return sr, si, yr, yi


def dit_butterfly_int(ar, ai, br, bi, k, p: int, cfg: FFTConfig, in_w: int):
    """One inverse (DIT) butterfly: (A + B*conj(W_k), A - B*conj(W_k))."""
    scale, rnd = cfg.scale, cfg.rounding == "round"
    out_w = in_w + 1 - scale
    if p == 0:
        bwr, bwi = br, bi
    elif p == 1:
        odd = (k & 1).astype(bool)
        bwr = np.where(odd, neg_guarded(bi), br)
        bwi = np.where(odd, br, bi)
    else:
        w_re, w_im = _stage_tables(p, cfg)
        bwr, bwi = cmult_int(br, bi, w_re[k], -w_im[k],
                             cfg.twiddle_shift, in_w)
    if scale and not rnd:
        oar = (ar >> 1) + (bwr >> 1)
        oai = (ai >> 1) + (bwi >> 1)
        obr = (ar >> 1) - (bwr >> 1)
        obi = (ai >> 1) - (bwi >> 1)
    elif scale and rnd:
        oar, oai = round_half_up(ar + bwr), round_half_up(ai + bwi)
        obr, obi = round_half_up(ar - bwr), round_half_up(ai - bwi)
    else:
        oar, oai = ar + bwr, ai + bwi
        obr, obi = ar - bwr, ai - bwi
    return (wrap_width(oar, out_w), wrap_width(oai, out_w),
            wrap_width(obr, out_w), wrap_width(obi, out_w))


def fft_int(x_re, x_im, cfg: FFTConfig, inverse: bool = False):
    """Integer radix-2 transform, natural order in / natural order out.

    Forward: DIF with bit-reversal folded into the output reorder
    (mirrors ``int_fft_single_path``'s inbuf -> fftNk -> bitrev chain).
    Inverse: DIT, bit-reversal applied to the input, *unnormalized*
    (unscaled output is N*x; scaled mode's per-stage /2 supplies 1/N) —
    no 1/N exists anywhere in the reference (SURVEY §2.1).

    x_re, x_im: integer arrays [..., n]. Returns (re, im) int64 (or object
    for > 63-bit configurations).
    """
    n, nl = cfg.n, cfg.stages
    dt = object if needs_object(cfg) else np.int64
    xr = np.asarray(x_re, dtype=dt).copy()
    xi = np.asarray(x_im, dtype=dt).copy()
    assert xr.shape[-1] == n, f"last dim {xr.shape[-1]} != n={n}"

    rev = bitrev_indices(n)
    if inverse:
        xr, xi = xr[..., rev], xi[..., rev]

    if cfg.bypass_fly:
        # USE_FLY=0: arithmetic knocked out, permutation network only
        # (int_fftNk.vhd:259-277): end-to-end = bit-reversal reorder.
        if not inverse:
            xr, xi = xr[..., rev], xi[..., rev]
        return xr, xi

    for s in range(nl):
        p = cfg.stage_twiddle_order(s, inverse)
        h = 1 << p
        in_w = cfg.stage_input_width(s)
        shp = xr.shape[:-1]
        vr = xr.reshape(shp + (-1, 2, h))
        vi = xi.reshape(shp + (-1, 2, h))
        ar, ai = vr[..., 0, :], vi[..., 0, :]
        br, bi = vr[..., 1, :], vi[..., 1, :]
        k = np.arange(h)
        if not inverse:
            sr, si, yr, yi = dif_butterfly_int(ar, ai, br, bi, k, p, cfg, in_w)
            xr = np.stack([sr, yr], axis=-2).reshape(shp + (n,))
            xi = np.stack([si, yi], axis=-2).reshape(shp + (n,))
        else:
            oar, oai, obr, obi = dit_butterfly_int(ar, ai, br, bi, k, p, cfg,
                                                   in_w)
            xr = np.stack([oar, obr], axis=-2).reshape(shp + (n,))
            xi = np.stack([oai, obi], axis=-2).reshape(shp + (n,))

    if not inverse:
        xr, xi = xr[..., rev], xi[..., rev]
    return xr, xi
