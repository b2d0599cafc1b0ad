"""The FFT -> spectrum product -> IFFT pair in plain PyTorch.

The semantics of the frozen reference's composition, bit for bit:
``four_step_int`` forward on the factors (n1, n2) (``reference/four_step.py``,
each factor the radix-2 ``fft_int`` of ``reference/int_model.py``), the
complex product with a spectrum of natural frequency order
(``cmult_int``: floor-shifted by the product's shift, wrapped to the
forward's output width), and ``four_step_int`` inverse on (n2, n1).  The
reference forms products wider than 63 bits in Python's integers; here
every tensor is int64 and such a product is formed exactly in two limbs
(``cmult``).  It runs on any device, in blocks of frames, so that the
benchmark's check computes it on the card.

A configuration is any object with the frozen ``FFTConfig``'s fields
``n``, ``mode``, ``rounding``, ``data_width``, ``twiddle_width`` and
``twiddle_gen``; what the reference derives from them (widths, the
twiddle shift) is worked out again here.  ``product_sums="mod64"`` forms
the product's and the inverse's product-sums modulo 2^64, the container
below the exact one the configuration states (the control).
"""

from __future__ import annotations

import torch

from benchmark.reference.twiddle import (circle_twiddles_int,
                                         stage_twiddles_int)

#: bits of the low limb of a datum in an exact product
LIMB = 24


def stages(n: int) -> int:
    return n.bit_length() - 1


def scale(cfg) -> int:
    return 1 if cfg.mode == "scaled" else 0


def output_width(cfg, n: int, data_width: int) -> int:
    """Width after an n-point transform of ``data_width``-bit data."""
    return data_width + stages(n) * (1 - scale(cfg))


def twiddle_shift(cfg) -> int:
    """The renormalising shift of a data x twiddle product
    (``int_cmult_dsp48.vhd:189-190, 316-317``)."""
    w = cfg.twiddle_width
    return w - 1 if w < 19 else w - 2


def wrap(v: torch.Tensor, w: int) -> torch.Tensor:
    """``v`` wrapped to a signed w-bit register (identity from 63 bits,
    as the reference's ``wrap_width``)."""
    if w >= 63:
        return v
    m = 1 << (w - 1)
    return ((v + m) & ((1 << w) - 1)) - m


def neg_guarded(x: torch.Tensor) -> torch.Tensor:
    """-x for x >= 0, -x - 1 below (the most-negative guard)."""
    return torch.where(x >= 0, -x, -x - 1)


def round_half_up(v: torch.Tensor) -> torch.Tensor:
    return (v >> 1) + (v & 1)


def cmult(br, bi, c, d, shift: int, width: int, mod64: bool = False):
    """((br*c - bi*d) >> shift, (bi*c + br*d) >> shift), each wrapped to
    ``width`` bits: the floor shift on the exact sum.

    Each datum splits as b = bh * 2^24 + bl with bl in [0, 2^24): the low
    sums (|bl| < 2^24 against factors of at most 25 bits) and the high ones
    (data of at most 48 bits) are exact in int64, and for a shift s <= 24
    floor((2^24 H + L) / 2^s) = 2^(24-s) H + floor(L / 2^s); a result wider
    than 64 bits is read only through the wrap, modulo 2^64.  ``mod64``
    forms the sums in one int64 instead, modulo 2^64 (the control)."""
    if mod64:
        re, im = br * c - bi * d, bi * c + br * d
        return wrap(re >> shift, width), wrap(im >> shift, width)
    if not 0 <= shift <= LIMB:
        raise ValueError(f"shift {shift} outside 0..{LIMB}")
    mask = (1 << LIMB) - 1
    hr, hi = br >> LIMB, bi >> LIMB
    lr, li = br & mask, bi & mask
    up = LIMB - shift
    re = ((hr * c - hi * d) << up) + ((lr * c - li * d) >> shift)
    im = ((hi * c + hr * d) << up) + ((li * c + lr * d) >> shift)
    return wrap(re, width), wrap(im, width)


def bitrev(n: int, device) -> torch.Tensor:
    """The bit-reversal permutation of 0..n-1."""
    k = torch.arange(n, device=device)
    out = torch.zeros_like(k)
    for b in range(stages(n)):
        out |= ((k >> b) & 1) << (stages(n) - 1 - b)
    return out


def _table(pair, device):
    return tuple(torch.as_tensor(t, dtype=torch.int64, device=device)
                 for t in pair)


def fft_int(xr, xi, cfg, n: int, data_width: int, inverse: bool = False,
            mod64: bool = False):
    """The radix-2 ``fft_int`` of ``cfg`` at size n and ``data_width``,
    over the last axis, natural order in and out: forward DIF with the
    output bit-reversed, inverse DIT with the input bit-reversed,
    unnormalised."""
    dev = xr.device
    ns, sc = stages(n), scale(cfg)
    rnd = cfg.rounding == "round"
    rev = bitrev(n, dev)
    if inverse:
        xr, xi = xr[..., rev], xi[..., rev]
    shp = xr.shape[:-1]
    for s in range(ns):
        p = s if inverse else ns - 1 - s
        h = 1 << p
        in_w = data_width + s * (1 - sc)
        out_w = in_w + 1 - sc
        vr, vi = xr.reshape(shp + (-1, 2, h)), xi.reshape(shp + (-1, 2, h))
        ar, ai, br, bi = vr[..., 0, :], vi[..., 0, :], vr[..., 1, :], \
            vi[..., 1, :]
        k = torch.arange(h, device=dev)
        if p >= 2:
            w_re, w_im = _table(stage_twiddles_int(p, cfg.twiddle_width,
                                                   cfg.twiddle_gen), dev)
        if not inverse:
            if sc and not rnd:
                ar, ai, br, bi = ar >> 1, ai >> 1, br >> 1, bi >> 1
            sr, si, dr, di = ar + br, ai + bi, ar - br, ai - bi
            if sc and rnd:
                sr, si, dr, di = (round_half_up(v) for v in (sr, si, dr, di))
            sr, si, dr, di = (wrap(v, out_w) for v in (sr, si, dr, di))
            if p == 0:
                yr, yi = dr, di
            elif p == 1:
                odd = (k & 1).bool()
                yr = torch.where(odd, di, dr)
                yi = torch.where(odd, neg_guarded(dr), di)
            else:
                yr, yi = cmult(dr, di, w_re, w_im, twiddle_shift(cfg),
                               out_w, mod64)
            first, second = (sr, si), (yr, yi)
        else:
            if p == 0:
                bwr, bwi = br, bi
            elif p == 1:
                odd = (k & 1).bool()
                bwr = torch.where(odd, neg_guarded(bi), br)
                bwi = torch.where(odd, br, bi)
            else:
                bwr, bwi = cmult(br, bi, w_re, -w_im, twiddle_shift(cfg),
                                 in_w, mod64)
            if sc and not rnd:
                oar, oai = (ar >> 1) + (bwr >> 1), (ai >> 1) + (bwi >> 1)
                obr, obi = (ar >> 1) - (bwr >> 1), (ai >> 1) - (bwi >> 1)
            else:
                oar, oai, obr, obi = ar + bwr, ai + bwi, ar - bwr, ai - bwi
                if sc:
                    oar, oai, obr, obi = (round_half_up(v)
                                          for v in (oar, oai, obr, obi))
            first = (wrap(oar, out_w), wrap(oai, out_w))
            second = (wrap(obr, out_w), wrap(obi, out_w))
        xr = torch.stack([first[0], second[0]], dim=-2).reshape(shp + (n,))
        xi = torch.stack([first[1], second[1]], dim=-2).reshape(shp + (n,))
    if not inverse:
        xr, xi = xr[..., rev], xi[..., rev]
    return xr, xi


def four_step(xr, xi, cfg, n1: int, n2: int, inverse: bool = False,
              mod64: bool = False):
    """``four_step_int`` of ``cfg`` (size n1 * n2) over the last axis,
    natural order in and out."""
    n = n1 * n2
    if cfg.n != n:
        raise ValueError(f"cfg.n = {cfg.n} is not {n1} x {n2}")
    dev = xr.device
    shp = xr.shape[:-1]
    w1 = output_width(cfg, n1, cfg.data_width)
    a_re = xr.reshape(shp + (n1, n2)).transpose(-1, -2)
    a_im = xi.reshape(shp + (n1, n2)).transpose(-1, -2)
    b_re, b_im = fft_int(a_re, a_im, cfg, n1, cfg.data_width, inverse, mod64)
    m = (torch.arange(n2, device=dev)[:, None]
         * torch.arange(n1, device=dev)[None, :])
    if inverse:
        m = (-m) % n
    w_re, w_im = _table(circle_twiddles_int(n, cfg.twiddle_width,
                                            cfg.twiddle_gen), dev)
    c_re, c_im = cmult(b_re, b_im, w_re[m], w_im[m], twiddle_shift(cfg), w1,
                       mod64)
    d_re, d_im = fft_int(c_re.transpose(-1, -2), c_im.transpose(-1, -2), cfg,
                         n2, w1, inverse, mod64)
    return (d_re.transpose(-1, -2).reshape(shp + (n,)),
            d_im.transpose(-1, -2).reshape(shp + (n,)))


def pair(x_re, x_im, cfg, icfg, spectrum, product_shift: int, factors,
         product_sums: str = "exact", block: int = 8):
    """The pair on frames [F, n] (integer tensors, natural order, on any
    device): ``cfg``'s forward on ``factors`` (n1, n2), the product with
    ``spectrum`` (hr, hi: natural order, length n) shifted down by
    ``product_shift`` and wrapped to ``icfg.data_width``, and ``icfg``'s
    inverse on (n2, n1).  Returns int64 (y_re, y_im) [F, n], computed
    ``block`` frames at a time.  ``product_sums`` is ``"exact"``, or
    ``"mod64"``, which forms the product's and the inverse's product-sums
    modulo 2^64."""
    if product_sums not in ("exact", "mod64"):
        raise ValueError(f"product_sums {product_sums!r} is not 'exact' "
                         "or 'mod64'")
    mod64 = product_sums == "mod64"
    n1, n2 = factors
    dev = x_re.device
    hr, hi = (torch.as_tensor(h, dtype=torch.int64, device=dev)
              for h in spectrum)
    outs = []
    for i in range(0, x_re.shape[0], block):
        xr, xi = (x[i:i + block].to(torch.int64) for x in (x_re, x_im))
        fr, fi = four_step(xr, xi, cfg, n1, n2)
        pr, pi = cmult(fr, fi, hr, hi, product_shift, icfg.data_width,
                       mod64)
        outs.append(four_step(pr, pi, icfg, n2, n1, inverse=True,
                              mod64=mod64))
    return tuple(torch.cat([o[k] for o in outs]) for k in (0, 1))
