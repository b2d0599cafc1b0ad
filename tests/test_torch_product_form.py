"""The form of the factor pass's complex products, chosen per pass from the
widths the plan knows (``ops.fused_fft.product_form``): ``"int32"`` on the
int32 tile, and on the int64 tile ``"mod64"`` where every product keeps
bits that fit in 64, else ``"int128"``.  The forms of the plans that run
the int64 tile are pinned here; the identity the modular form rests on is
tested in tests/test_torch_intmath.py, the kernels of both forms against
the plain version on the card in tests/test_torch_cuda.py."""

import dataclasses

import pytest
import torch

from intfftk_tpu_torch.config import FFTConfig
from intfftk_tpu_torch.golden import make_conv_spec
from intfftk_tpu_torch.ops.fused_fft import (PRODUCT_FORMS, LargeFFTPlan,
                                              product_form, products_note)


def _forms(plan):
    """The product form of each pass of a ``LargeFFTPlan``, as its prepared
    chain takes them."""
    return [product_form(cfg, kw["out_dtype"], kw["inverse"],
                         kw.get("epi") is not None
                         or kw.get("synth") is not None)
            for cfg, kw in plan.passes()]


def _conv(product_width):
    spec = make_conv_spec(65536, 8193, twiddle_width=16,
                          max_spectrum_width=25,
                          max_product_width=product_width)
    n1, n2 = spec.factors
    fwd = LargeFFTPlan(spec.fft_cfg, n1, n2, order="raw", device="cpu")
    inv = LargeFFTPlan(spec.ifft_cfg, n2, n1, inverse=True, order="raw",
                       device="cpu")
    return spec, fwd, inv


def _config2():
    cfg = FFTConfig(n=1 << 16, mode="unscaled", data_width=32,
                    twiddle_width=20)
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    fwd = LargeFFTPlan(cfg, order="raw", device="cpu")
    inv = LargeFFTPlan(icfg, fwd.n2, fwd.n1, inverse=True, order="raw",
                       device="cpu")
    return fwd, inv


def test_config4_inverse_is_modular():
    """The 64k convolution of the benchmark (BASELINE config 4, a 44-bit
    product): its inverse is scaled at 44 bits with 16-bit twiddles, so
    every product of both passes keeps 44 bits above a shift of 15, 59 in
    all: both passes modular; the forward runs on the int32 tile."""
    spec, fwd, inv = _conv(44)
    assert (spec.ifft_cfg.data_width, spec.ifft_cfg.twiddle_shift) == (44,
                                                                       15)
    assert _forms(inv) == ["mod64", "mod64"]
    assert _forms(fwd) == ["int32", "int32"]


def test_wider_product_keeps_int128():
    """A 52-bit product (52 + 15 = 67 bits) keeps the exact form."""
    spec, _, inv = _conv(52)
    assert spec.ifft_cfg.data_width == 52
    assert _forms(inv) == ["int128", "int128"]


def test_config2_wide_passes_pinned():
    """BASELINE config 2 (64k unscaled 32-bit forward, 20-bit twiddles:
    shift 18; the inverse scaled at 48 bits): the forward's widening pass 1
    keeps at most its epilogue's 40 bits (58), pass 2 (40 bits in, no
    epilogue) at most its last multiplying stage's 46 (64, the bound
    itself): both modular; the inverse keeps 48 (66) in both: exact."""
    fwd, inv = _config2()
    assert [c.data_width for c, _ in fwd.passes()] == [32, 40]
    assert (fwd.mid_dtype, fwd.out_dtype) == (torch.int64, torch.int64)
    assert _forms(fwd) == ["mod64", "mod64"]
    assert _forms(inv) == ["int128", "int128"]


def test_24bit_widening_pass2():
    """The 64k unscaled 24-bit forward: pass 1 on the int32 tile, pass 2
    widening to int64 at 32 bits in (38 + 15 = 53): modular."""
    plan = LargeFFTPlan(FFTConfig(n=1 << 16, mode="unscaled", data_width=24,
                                  twiddle_width=16), device="cpu")
    assert (plan.mid_dtype, plan.out_dtype) == (torch.int32, torch.int64)
    assert _forms(plan) == ["int32", "mod64"]


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_core_is_int32(inverse):
    """The core's 64k transform runs on the int32 tile: no int64 pass."""
    plan = LargeFFTPlan(FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                                  data_width=16, twiddle_width=16),
                        inverse=inverse, device="cpu")
    assert _forms(plan) == ["int32", "int32"]


@pytest.mark.parametrize("dw,inverse,epilogue,want", [
    (43, False, False, "mod64"),    # DIF: last product at order 2, 49 bits
    (43, True, False, "int128"),    # DIT: order 7 multiplies at 50 bits
    (42, True, False, "mod64"),
    (43, False, True, "int128"),    # the epilogue wraps to 51 bits
    (41, False, True, "mod64"),
    (41, True, True, "mod64"),
])
def test_unscaled_widths_by_direction_and_epilogue(dw, inverse, epilogue,
                                                   want):
    """A 256-row unscaled pass with 16-bit twiddles (shift 15): the forward
    (DIF) wraps its products to the stage's output width and its last
    multiplying stage is order 2, the sixth, so its widest product is dw +
    6; the inverse (DIT) wraps to the input width and multiplies up to
    order 7 (dw + 7); the epilogue wraps to the output width (dw + 8)."""
    cfg = FFTConfig(n=256, mode="unscaled", data_width=dw, twiddle_width=16)
    assert product_form(cfg, torch.int64, inverse, epilogue) == want


@pytest.mark.parametrize("dw,want", [(49, "mod64"), (50, "int128")])
def test_scaled_bound_is_sixty_four(dw, want):
    """Scaled, every product keeps dw bits: 49 + 15 = 64 is modular, 65
    is not."""
    cfg = FFTConfig(n=256, mode="scaled", data_width=dw, twiddle_width=16)
    for inverse in (False, True):
        for epilogue in (False, True):
            assert product_form(cfg, torch.int64, inverse, epilogue) == want


def test_int32_tile_and_bypass():
    """The int32 tile is always "int32"; a bypassed pass multiplies only
    in its epilogue."""
    cfg = FFTConfig(n=256, mode="scaled", data_width=16, twiddle_width=16)
    for dtype in (torch.int16, torch.int32):
        assert product_form(cfg, dtype, True, True) == "int32"
    wide = FFTConfig(n=256, mode="unscaled", data_width=50,
                     twiddle_width=16, bypass_fly=True)
    assert product_form(wide, torch.int64, False, False) == "mod64"
    assert product_form(wide, torch.int64, False, True) == "int128"


def test_products_note():
    """The plan.prepare span's note counts every form, in PRODUCT_FORMS'
    order."""
    assert PRODUCT_FORMS == ("int32", "mod64", "int128")
    assert products_note(("mod64", "mod64")) == \
        "product int32 0 mod64 2 int128 0"
    assert products_note(["int32", "int128"]) == \
        "product int32 1 mod64 0 int128 1"
