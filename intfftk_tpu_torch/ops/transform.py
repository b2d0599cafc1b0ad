"""Staged integer radix-2 transform in eager PyTorch.

Counterpart of ``intfftk_tpu/ops/transform.py`` (``dif_stage``,
``dit_stage``, ``fft_stages``, ``FFTPlan``, ``make_plan``, ``fft``,
``ifft``, ``fft_ifft_pair``, ``WideFFTPlan``).  It runs on int64 tensors
on any device, so one code path carries every data width up to 64 bits:
the wide plan is the same stages, with the products split where one int64
product-sum could overflow (``intmath.cmult_exact``).  It is the CPU path
of the port and the building block of the plain versions the CUDA kernels
are held against.  Bit-identical to ``intfftk_tpu.golden.fft_int``.

Stage structure (forward DIF ``int_fftNk.vhd:184-279``, inverse DIT
``int_ifftNk.vhd``): view [..., blocks, 2, h] -> butterfly lane 0 against
lane 1 -> write back.  The spectrum-side reorder is a transpose of the
log2(n) index-bit axes, the same permutation as the ``bitrev_indices``
gather.  ``pack_tables_2d``/``fft_stages_2d`` are the monolithic
schedule's i1-factor stages with full-size 2-D twiddle tables
(``pallas_fft.py:340-430``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..config import FFTConfig
from ..golden.twiddle import stage_twiddles_int

from .intmath import cmult_exact, neg_guarded, round_half_up, wrap_width


#: The widest data path the port carries: its int64 register.
MAX_WIDTH = 64


def check_width(cfg: FFTConfig):
    """The port carries every data path up to its int64 register; an
    output wider than 64 bits raises NotImplementedError.  (The JAX
    package's two int32 planes hold 56-bit values: ROADMAP §C.)"""
    if cfg.output_width > MAX_WIDTH:
        raise NotImplementedError(
            f"an output of {cfg.output_width} bits does not fit the int64 "
            f"register the port carries (at most {MAX_WIDTH} bits)")


def pack_tables(cfg: FFTConfig):
    """Stage twiddles packed by order into one [n] int32 vector per part:
    order p >= 2 occupies [2^p, 2^(p+1)) (``pallas_fft._pack_tables``;
    orders 0 and 1 need no table)."""
    n = cfg.n
    w_re = np.zeros(n, np.int32)
    w_im = np.zeros(n, np.int32)
    for p in range(2, cfg.stages):
        re, im = stage_twiddles_int(p, cfg.twiddle_width, cfg.twiddle_gen)
        w_re[1 << p: 2 << p] = re
        w_im[1 << p: 2 << p] = im
    return w_re, w_im


def pack_tables_2d(cfg: FFTConfig, n1: int, n2: int):
    """The 2-D stage tables of the monolithic schedule's i1 factor, [n1, n2]
    int32 per part (``pallas_fft._pack_tables_2d``): stage sub-order q of
    the n1 factor is full-size order p = q + log2(n2), whose twiddle index
    k1*n2 + i2 is never trivial, so rows [2^q, 2^(q+1)) hold
    ``stage_twiddles_int(p)`` as [2^q, n2] for every q, 0 and 1 included."""
    ln2 = n2.bit_length() - 1
    w_re = np.zeros((n1, n2), np.int32)
    w_im = np.zeros((n1, n2), np.int32)
    for q in range(n1.bit_length() - 1):
        re, im = stage_twiddles_int(q + ln2, cfg.twiddle_width,
                                    cfg.twiddle_gen)
        w_re[1 << q: 2 << q] = re.reshape(1 << q, n2)
        w_im[1 << q: 2 << q] = im.reshape(1 << q, n2)
    return w_re, w_im


def bitrev_last(x: torch.Tensor) -> torch.Tensor:
    """Bit-reversal permutation of the last axis (a power of two):
    ``out[..., j] = x[..., bitrev(j)]``, as a transpose of its bit axes."""
    n = x.shape[-1]
    nbits = n.bit_length() - 1
    lead = x.dim() - 1
    v = x.reshape(x.shape[:-1] + (2,) * nbits)
    perm = tuple(range(lead)) + tuple(range(lead + nbits - 1, lead - 1, -1))
    return v.permute(perm).reshape(x.shape)


def _sum_diff(ar, ai, br, bi, cfg: FFTConfig, in_w: int):
    """A + B and A - B with the mode's scale and rounding, wrapped to the
    stage's output width: the DIF butterfly and the DIT combine of A with
    B*W are the same arithmetic (golden ``dif_butterfly_int`` /
    ``dit_butterfly_int``)."""
    scale, rnd = cfg.scale, cfg.rounding == "round"
    out_w = in_w + 1 - scale
    if scale and not rnd:
        ar, ai, br, bi = ar >> 1, ai >> 1, br >> 1, bi >> 1
        sr, si, dr, di = ar + br, ai + bi, ar - br, ai - bi
    elif scale:
        sr, si = round_half_up(ar + br), round_half_up(ai + bi)
        dr, di = round_half_up(ar - br), round_half_up(ai - bi)
    else:
        sr, si, dr, di = ar + br, ai + bi, ar - br, ai - bi
    return (wrap_width(sr, out_w), wrap_width(si, out_w),
            wrap_width(dr, out_w), wrap_width(di, out_w))


def dif_stage(ar, ai, br, bi, cfg: FFTConfig, in_w: int, p: int,
              w_re, w_im):
    """One forward stage on int64 lane views; mirrors golden
    ``dif_butterfly_int``.  ``w_re``/``w_im``: the order-p twiddles [2^p]
    (read only for p >= 2)."""
    sr, si, dr, di = _sum_diff(ar, ai, br, bi, cfg, in_w)
    if p == 0:
        yr, yi = dr, di
    elif p == 1:
        # W in {1, -j}: the odd lane takes (re, im) = (im, neg_guarded(re))
        yr = torch.stack([dr[..., 0], di[..., 1]], dim=-1)
        yi = torch.stack([di[..., 0], neg_guarded(dr[..., 1])], dim=-1)
    else:
        yr, yi = cmult_exact(dr, di, w_re, w_im, cfg.twiddle_shift,
                             in_w + 1 - cfg.scale,
                             twiddle_width=cfg.twiddle_width)
    return sr, si, yr, yi


def dit_stage(ar, ai, br, bi, cfg: FFTConfig, in_w: int, p: int,
              w_re, w_im):
    """One inverse stage on int64 lane views; mirrors golden
    ``dit_butterfly_int``: B times the conjugate order-p twiddle, wrapped
    to ``in_w``, then the same sum and difference as the forward."""
    if p == 0:
        bwr, bwi = br, bi
    elif p == 1:
        # conj(W) in {1, j}: the odd lane takes (neg_guarded(im), re)
        bwr = torch.stack([br[..., 0], neg_guarded(bi[..., 1])], dim=-1)
        bwi = torch.stack([bi[..., 0], br[..., 1]], dim=-1)
    else:
        bwr, bwi = cmult_exact(br, bi, w_re, w_im, cfg.twiddle_shift, in_w,
                               conj=True, twiddle_width=cfg.twiddle_width)
    return _sum_diff(ar, ai, bwr, bwi, cfg, in_w)


def fft_stages(x_re, x_im, cfg: FFTConfig, w_re, w_im, inverse=False,
               natural=True):
    """Transform along the last axis: integer [..., n] -> int64 [..., n].
    The time side is natural order; the spectrum side is natural order,
    or bit-reversed with ``natural=False`` (the raw core contract: the
    forward emits it, the inverse consumes it).  ``w_re``/``w_im``: the
    packed stage tables of ``pack_tables`` (the same for both
    directions)."""
    n = cfg.n
    xr, xi = x_re.long(), x_im.long()
    if xr.shape[-1] != n:
        raise ValueError(f"last dim {xr.shape[-1]} != n={n}")
    # the DIT stages consume a bit-reversed spectrum, the DIF stages emit
    # one (bypass_fly: the permutation network alone, int_fftNk.vhd:259-277)
    if inverse and natural:
        xr, xi = bitrev_last(xr), bitrev_last(xi)
    if not cfg.bypass_fly:
        shp = xr.shape[:-1]
        stage = dit_stage if inverse else dif_stage
        for s in range(cfg.stages):
            p = cfg.stage_twiddle_order(s, inverse)
            h = 1 << p
            vr = xr.reshape(shp + (-1, 2, h))
            vi = xi.reshape(shp + (-1, 2, h))
            sr, si, yr, yi = stage(
                vr[..., 0, :], vi[..., 0, :], vr[..., 1, :], vi[..., 1, :],
                cfg, cfg.stage_input_width(s), p,
                w_re[h: 2 * h], w_im[h: 2 * h])
            xr = torch.stack([sr, yr], dim=-2).reshape(shp + (n,))
            xi = torch.stack([si, yi], dim=-2).reshape(shp + (n,))
    if natural and not inverse:
        xr, xi = bitrev_last(xr), bitrev_last(xi)
    return xr, xi


def fft_stages_2d(x_re, x_im, cfg: FFTConfig, t_re, t_im, inverse=False,
                  natural=True):
    """The monolithic schedule's i1-factor stages along the last axis:
    integer [..., C, n] -> int64 [..., C, n], n = cfg.n, with the 2-D
    tables ``t_re``/``t_im`` [n, C] of ``pack_tables_2d`` (column c of the
    tables goes with row c of the data).  Mirrors ``_stage_rows_2d`` /
    ``_transform_rows_2d`` (``pallas_fft.py:379-430``): the butterflies of
    ``fft_stages``, but every stage multiplies, the forward after the
    butterfly at its output width, the inverse before it (conjugate
    twiddle) at its input width.  ``natural``: the spectrum side in natural
    order, else bit-reversed."""
    n = cfg.n
    xr, xi = x_re.long(), x_im.long()
    if xr.shape[-1] != n:
        raise ValueError(f"last dim {xr.shape[-1]} != n={n}")
    if inverse and natural:
        xr, xi = bitrev_last(xr), bitrev_last(xi)
    if not cfg.bypass_fly:
        shp = xr.shape[:-1]
        cols = t_re.shape[1]
        for s in range(cfg.stages):
            h = 1 << cfg.stage_twiddle_order(s, inverse)
            vr = xr.reshape(shp + (-1, 2, h))
            vi = xi.reshape(shp + (-1, 2, h))
            # [h, C] -> [C, 1, h], against [..., C, blocks, h]
            wr = t_re[h: 2 * h].t().reshape(cols, 1, h)
            wi = t_im[h: 2 * h].t().reshape(cols, 1, h)
            in_w = cfg.stage_input_width(s)
            ar, ai = vr[..., 0, :], vi[..., 0, :]
            br, bi = vr[..., 1, :], vi[..., 1, :]
            if inverse:
                br, bi = cmult_exact(br, bi, wr, wi, cfg.twiddle_shift, in_w,
                                     conj=True,
                                     twiddle_width=cfg.twiddle_width)
                sr, si, yr, yi = _sum_diff(ar, ai, br, bi, cfg, in_w)
            else:
                sr, si, dr, di = _sum_diff(ar, ai, br, bi, cfg, in_w)
                yr, yi = cmult_exact(dr, di, wr, wi, cfg.twiddle_shift,
                                     in_w + 1 - cfg.scale,
                                     twiddle_width=cfg.twiddle_width)
            xr = torch.stack([sr, yr], dim=-2).reshape(shp + (n,))
            xi = torch.stack([si, yi], dim=-2).reshape(shp + (n,))
    if natural and not inverse:
        xr, xi = bitrev_last(xr), bitrev_last(xi)
    return xr, xi


class FFTPlan(nn.Module):
    """Transform plan of one config and direction: the packed stage tables
    as buffers.  ``plan(x_re, x_im)``: integer [..., n] -> int64 [..., n],
    natural order in and out, on the device of the input.  The inverse is
    unnormalised, like the reference's."""

    def __init__(self, cfg: FFTConfig, inverse: bool = False,
                 device: torch.device | str | None = None):
        super().__init__()
        check_width(cfg)
        self.cfg, self.inverse = cfg, inverse
        w_re, w_im = pack_tables(cfg)
        self.register_buffer("w_re", torch.as_tensor(w_re, device=device))
        self.register_buffer("w_im", torch.as_tensor(w_im, device=device))

    def forward(self, x_re, x_im):
        return fft_stages(x_re, x_im, self.cfg, self.w_re, self.w_im,
                          inverse=self.inverse)


class WideFFTPlan(FFTPlan):
    """The plan of a data path wider than 32 bits (output 33..64 bits):
    unscaled growth and the widened FFT->IFFT pair input
    (``int_fft_ifft_pair.vhd:261``); counterpart of the JAX
    ``WideFFTPlan`` (``intfftk_tpu/ops/transform.py:329-374``).  The
    stages are ``FFTPlan``'s on int64 tensors; where a product could
    overflow int64, ``cmult_exact`` splits it.  Outputs above 64 bits
    raise NotImplementedError."""


# ----------------------------------------------------------- functional API

def make_plan(cfg: FFTConfig, inverse: bool = False,
              device: torch.device | str | None = None) -> FFTPlan:
    """The staged plan of ``cfg``: ``FFTPlan`` up to 32 bits,
    ``WideFFTPlan`` above (the JAX dispatch, ``transform.py:379-385``)."""
    cls = WideFFTPlan if cfg.output_width > 32 else FFTPlan
    return cls(cfg, inverse=inverse, device=device)


def _run(x_re, x_im, cfg: FFTConfig, inverse: bool):
    xr, xi = torch.as_tensor(x_re), torch.as_tensor(x_im)
    return make_plan(cfg, inverse, device=xr.device)(xr, xi)


def fft(x_re, x_im, cfg: FFTConfig):
    """Forward integer FFT, natural in / natural out."""
    return _run(x_re, x_im, cfg, False)


def ifft(x_re, x_im, cfg: FFTConfig):
    """Inverse integer FFT (unnormalised, like the reference)."""
    return _run(x_re, x_im, cfg, True)


def fft_ifft_pair(x_re, x_im, cfg: FFTConfig, fly_fwd: bool = True,
                  fly_inv: bool = True):
    """FFT -> IFFT roundtrip, mirroring ``int_fft_ifft_pair``: the IFFT's
    input width is widened to the forward's output width
    (``int_fft_ifft_pair.vhd:261``).  ``fly_fwd``/``fly_inv`` are the
    reference's per-core butterfly knockouts FLY_FWD/FLY_INV
    (``int_fft_ifft_pair.vhd:92-93``): False leaves that core's
    permutation network alone, at its configured widths."""
    fwd_cfg = cfg if fly_fwd else dataclasses.replace(cfg, bypass_fly=True)
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width,
                               bypass_fly=not fly_inv or cfg.bypass_fly)
    inv = make_plan(icfg, inverse=True)   # raises before any work if > 64
    yr, yi = _run(x_re, x_im, fwd_cfg, False)
    return inv.to(yr.device)(yr, yi)
