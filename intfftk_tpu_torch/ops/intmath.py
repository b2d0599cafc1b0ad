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

Shifts on torch integer tensors wrap like two's-complement registers
(``<<``) and are arithmetic (``>>``), so every function is exact for every
value of its dtype.  Bit-identical to ``intfftk_tpu.golden.int_model`` and
to the JAX primitives (tests/test_torch_intmath.py).
"""

from __future__ import annotations

import torch


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
