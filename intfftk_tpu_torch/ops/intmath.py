"""Exact integer arithmetic of the butterflies on int32 / int64 tensors.

Counterpart of ``intfftk_tpu/ops/intmath.py`` and of the wide product
``wide_cmult`` of ``intfftk_tpu/ops/wideint.py:241``.  The TPU has no
int64, so the JAX modules split complex products into limbs
(``plan_limbs``, ``CmultPlan.data_limbs/twiddle_limbs``,
``_combine_groups``) and carry wide data as two int32 planes.  PyTorch has
int64 on every device: data of at most 35 bits times a twiddle of at most
27 bits fits one int64 product-sum, so the multiply there is that one
product-sum, a floor ``>>`` and a wrap; wider data splits once into a high
and a low part (``cmult_exact``).  The limb planner and the planes have no
counterpart.

``spectrum_product`` is the renormalised frequency-domain product of the
FFT -> product -> IFFT chains: on a CUDA tensor one launch of the
hand-written kernel ``csrc/product.cu``, on a CPU tensor its plain version
``spectrum_product_reference`` (``cmult_exact`` and a cast).

Shifts on torch integer tensors wrap like two's-complement registers
(``<<``) and are arithmetic (``>>``), so every function is exact for every
value of its dtype.  Bit-identical to ``intfftk_tpu.golden.int_model`` and
to the JAX primitives (tests/test_torch_intmath.py).
"""

from __future__ import annotations

import torch

from ..device import stream_handle, use_kernel


def _bits(x: torch.Tensor) -> int:
    return torch.iinfo(x.dtype).bits


def neg_guarded(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement negate with the most-negative guard
    (``int_dif2_fly.vhd:281-304``): -x for x >= 0, -x-1 for x < 0;
    ``(x >> 31) - x`` on int32, exact at INT32_MIN."""
    return (x >> (_bits(x) - 1)) - x


def round_half_up(v: torch.Tensor) -> torch.Tensor:
    """Divide by two rounding half toward +inf: (v >> 1) + (v & 1)."""
    return (v >> 1) + (v & 1)


def add_round_half_up(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """round_half_up(a + b) without forming the wider sum."""
    return (a >> 1) + (b >> 1) + ((a | b) & 1)


def sub_round_half_up(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """round_half_up(a - b) without forming the wider difference."""
    return (a >> 1) - (b >> 1) + ((a & ~b) & 1)


def wrap_width(v: torch.Tensor, w: int) -> torch.Tensor:
    """Wrap to a signed w-bit register; the identity at the dtype's width."""
    bits = _bits(v)
    if w >= bits:
        return v
    sh = bits - w
    return (v << sh) >> sh


def shift_wrap(v: torch.Tensor, s: int, w: int) -> torch.Tensor:
    """``wrap_width(v >> s, w)``: bits [s, s+w) of v, sign at bit s+w-1
    (the DSP48 output slice, ``int_cmult_dsp48.vhd:189-190``)."""
    return wrap_width(v >> s, w)


#: Bits of the low part of a split datum (``cmult_exact``).
SPLIT_BITS = 26


def cmult_exact(br: torch.Tensor, bi: torch.Tensor, w_re: torch.Tensor,
                w_im: torch.Tensor, shift: int, out_width: int,
                conj: bool = False, twiddle_width: int = 27):
    """(br + j*bi) * (w_re + j*w_im) as int64: re = (br*c - bi*d) >> shift,
    im = (bi*c + br*d) >> shift, each wrapped to ``out_width`` <= 64 bits.
    The floor shift applies to the summed full-precision product, as in
    the DSP48 cascade (``int_cmult18x25_dsp48.vhd:106-225``).  ``conj``
    negates the twiddle's imaginary part (the DIT/inverse path,
    ``int_dit2_fly.vhd:304-322``).

    The data are at most ``out_width`` bits wide (every caller's register)
    and the twiddles at most ``twiddle_width`` <= 27.  Where
    ``out_width + twiddle_width + 1 > 63`` (golden ``needs_object``) one
    int64 product-sum can overflow, so each datum splits once,
    b = bh * 2^26 + bl with bl in [0, 2^26): the low sum L = bl_r*c -
    bl_i*d is exact (|L| < 2^53), the high sum H wraps mod 2^64, and
    (H << (26 - shift)) + (L >> shift) is the shifted product mod 2^64 for
    every shift <= 26, which is all a wrap to <= 64 bits reads."""
    br, bi = br.long(), bi.long()
    c, d = w_re.long(), w_im.long()
    if conj:
        d = -d
    if out_width + twiddle_width + 1 <= 63:
        pre = br * c - bi * d
        pim = bi * c + br * d
        return (shift_wrap(pre, shift, out_width),
                shift_wrap(pim, shift, out_width))
    if not 0 <= shift <= SPLIT_BITS or out_width > 64 or twiddle_width > 27:
        raise ValueError(f"no exact int64 product for shift {shift}, "
                         f"{out_width}-bit data, {twiddle_width}-bit "
                         f"twiddles")
    mask = (1 << SPLIT_BITS) - 1
    hr, hi = br >> SPLIT_BITS, bi >> SPLIT_BITS
    lr, li = br & mask, bi & mask
    up = SPLIT_BITS - shift
    pre = ((hr * c - hi * d) << up) + ((lr * c - li * d) >> shift)
    pim = ((hi * c + hr * d) << up) + ((li * c + lr * d) >> shift)
    return wrap_width(pre, out_width), wrap_width(pim, out_width)


def _wide_product(fr: torch.Tensor, out_width: int,
                  spectrum_width: int) -> bool:
    """True where one int64 product-sum could overflow (the rule of
    ``cmult_exact``): the datum, at most ``out_width`` bits and never more
    than its dtype holds, plus the spectrum plus one exceed 63 bits."""
    return min(out_width, _bits(fr)) + spectrum_width + 1 > 63


def _check_product(fr, fi, hr, hi, shift, out_width, spectrum_width,
                   out_dtype) -> torch.dtype:
    if out_dtype is None:
        out_dtype = torch.int32 if out_width <= 32 else torch.int64
    if (fr.dtype not in (torch.int32, torch.int64) or fi.dtype != fr.dtype
            or out_dtype not in (torch.int32, torch.int64)):
        raise TypeError(f"the product takes int32 or int64 data and gives "
                        f"int32 or int64, got {fr.dtype}, {fi.dtype} -> "
                        f"{out_dtype}")
    if not 1 <= out_width <= torch.iinfo(out_dtype).bits:
        raise ValueError(f"{out_dtype} holds no {out_width}-bit result")
    block = tuple(hr.shape)
    if (hi.shape != hr.shape or hr.dtype != torch.int32
            or hi.dtype != torch.int32 or fi.shape != fr.shape
            or fr.dim() < hr.dim() or hr.numel() == 0
            or tuple(fr.shape[fr.dim() - hr.dim():]) != block):
        raise ValueError(f"expected [B, *block] data against an int32 table "
                         f"of shape block, got {tuple(fr.shape)} against "
                         f"{hr.dtype} {block}")
    if not 0 <= shift <= 62 or not 1 <= spectrum_width <= 27:
        raise ValueError(f"bad shift {shift} or spectrum width "
                         f"{spectrum_width}")
    return out_dtype


def spectrum_product_reference(fr, fi, hr, hi, shift: int, out_width: int,
                               spectrum_width: int = 27,
                               out_dtype: torch.dtype | None = None):
    """Plain PyTorch version of ``spectrum_product`` (any device):
    ``cmult_exact`` against the broadcast table, then the output dtype."""
    out_dtype = _check_product(fr, fi, hr, hi, shift, out_width,
                               spectrum_width, out_dtype)
    yr, yi = cmult_exact(fr, fi, hr, hi, shift, out_width,
                         twiddle_width=spectrum_width)
    return yr.to(out_dtype), yi.to(out_dtype)


def spectrum_product(fr: torch.Tensor, fi: torch.Tensor, hr: torch.Tensor,
                     hi: torch.Tensor, shift: int, out_width: int,
                     spectrum_width: int = 27,
                     out_dtype: torch.dtype | None = None):
    """(fr + j*fi) * (hr + j*hi) >> shift, wrapped to ``out_width`` bits,
    for [B, *block] data (contiguous int32 or int64) against a spectrum
    table ``hr``/``hi`` of shape ``block`` (contiguous int32, at most
    ``spectrum_width`` <= 27 bits), broadcast over B.  Each product-sum is
    exact before the floor shift, as ``cmult_exact``, whose contract on the
    data holds here too (int64 data at most ``out_width`` bits wide).
    Returns (re, im) in ``out_dtype``: int32 or int64, by default int32
    where ``out_width`` <= 32.

    A CUDA tensor launches the kernel of ``csrc/product.cu`` on the current
    stream (no synchronisation) and adds one to
    ``spectrum_product.launches``; a CPU tensor runs
    ``spectrum_product_reference``.  ``PreparedProduct`` checks all this
    once for a caller that repeats the call."""
    if not use_kernel(fr.device):
        return spectrum_product_reference(fr, fi, hr, hi, shift, out_width,
                                          spectrum_width, out_dtype)
    return PreparedProduct(fr, fi, hr, hi, shift, out_width, spectrum_width,
                           out_dtype)(fr, fi)


class PreparedProduct:
    """``spectrum_product`` resolved once for data of the shape, dtype and
    CUDA device of ``fr``/``fi`` against the table ``hr``/``hi``: every
    check made once.  A call takes contiguous data of that shape, dtype
    and device (else ValueError; nothing else is checked again), allocates
    re and im as two fresh tensors and makes the one C
    call: one launch, counted in ``spectrum_product.launches``.  It keeps
    the table alive.  ``form`` is the integer its product-sums are formed
    in, ``"long long"`` or, where one could overflow 64 bits
    (``_wide_product``), ``"int128"``.  Raises ValueError on a CPU device:
    the plain version needs no preparing."""

    def __init__(self, fr, fi, hr, hi, shift: int, out_width: int,
                 spectrum_width: int = 27,
                 out_dtype: torch.dtype | None = None):
        dev = fr.device
        if not use_kernel(dev):
            raise ValueError(f"a prepared product launches the kernel; "
                             f"{dev} runs the plain version")
        self.out_dtype = _check_product(fr, fi, hr, hi, shift, out_width,
                                        spectrum_width, out_dtype)
        if any(t.device != dev or not t.is_contiguous()
               for t in (fr, fi, hr, hi)):
            raise ValueError("the product kernel takes contiguous tensors "
                             "on one device")
        self.shape, self.dtype, self.device = fr.shape, fr.dtype, dev
        self.table = (hr, hi)
        wide = _wide_product(fr, out_width, spectrum_width)
        self.form = "int128" if wide else "long long"
        self.ints = (fr.numel(), hr.numel(), fr.element_size(),
                     self.out_dtype.itemsize, int(wide),
                     shift, out_width, dev.index)

    def __call__(self, fr, fi):
        for f in (fr, fi):
            if (f.shape != self.shape or f.dtype != self.dtype
                    or f.device != self.device or not f.is_contiguous()):
                raise ValueError(
                    f"this product was prepared for contiguous "
                    f"{self.dtype} {tuple(self.shape)} data on "
                    f"{self.device}, got {f.dtype} {tuple(f.shape)} on "
                    f"{f.device}")
        yr = torch.empty(self.shape, dtype=self.out_dtype, device=self.device)
        yi = torch.empty(self.shape, dtype=self.out_dtype, device=self.device)
        if fr.numel() == 0:
            return yr, yi
        from . import _build

        lib = _build.library()
        hr, hi = self.table
        err = lib.intfft_spectrum_product(
            fr.data_ptr(), fi.data_ptr(), hr.data_ptr(), hi.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), *self.ints,
            stream_handle(self.device))
        _build.check(lib, err, "spectrum_product launch")
        spectrum_product.launches += 1
        return yr, yi


#: Kernel launches made by ``spectrum_product`` and ``PreparedProduct`` (a
#: plain count; reset it to 0).
spectrum_product.launches = 0
