"""The form of the factor pass's complex products, chosen per pass from the
widths the plan knows (``ops.fused_fft.product_form``): on the int32 tile
``"mod32"`` where every product keeps bits that fit in 32, else ``"int32"``
(exact); on the int64 tile ``"mod64"`` where they fit in 64, else
``"limb64"`` (exact, in 32-bit limbs; ``"int128"`` is the whole form's).
The forms of the plans are pinned here; the identities the modular and the
limb forms rest on are tested in tests/test_torch_intmath.py, the kernels
of every form against the plain version on the card in
tests/test_torch_cuda.py."""

import dataclasses

import pytest
import torch

from intfftk_tpu_torch.config import FFTConfig
from intfftk_tpu_torch.golden import make_conv_spec
from intfftk_tpu_torch.ops.fused_fft import (PRODUCT_FORMS, LargeFFTPlan,
                                              modular, product_form,
                                              products_note)


def _forms(plan):
    """The product form of each pass of a ``LargeFFTPlan``, as its prepared
    chain takes them."""
    return [product_form(cfg, kw["out_dtype"], kw["inverse"],
                         kw.get("epi") is not None
                         or kw.get("synth") is not None,
                         kw.get("tables_2d") is not None)
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
    all: both passes modular.  The forward runs on the int32 tile,
    unscaled from 16 bits: pass 1's epilogue wraps to 24 bits (39 with the
    shift), pass 2 multiplies up to 32 (47): both exact."""
    spec, fwd, inv = _conv(44)
    assert (spec.ifft_cfg.data_width, spec.ifft_cfg.twiddle_shift) == (44,
                                                                       15)
    assert _forms(inv) == ["mod64", "mod64"]
    assert _forms(fwd) == ["int32", "int32"]


def test_wider_product_keeps_int128():
    """A 52-bit product (52 + 15 = 67 bits) keeps the exact form, in limbs."""
    spec, _, inv = _conv(52)
    assert spec.ifft_cfg.data_width == 52
    assert _forms(inv) == ["limb64", "limb64"]


def test_config2_wide_passes_pinned():
    """BASELINE config 2 (64k unscaled 32-bit forward, 20-bit twiddles:
    shift 18; the inverse scaled at 48 bits): the forward's widening pass 1
    keeps at most its epilogue's 40 bits (58), pass 2 (40 bits in, no
    epilogue) at most its last multiplying stage's 46 (64, the bound
    itself): both modular; the inverse keeps 48 (66) in both: exact, in
    limbs."""
    fwd, inv = _config2()
    assert [c.data_width for c, _ in fwd.passes()] == [32, 40]
    assert (fwd.mid_dtype, fwd.out_dtype) == (torch.int64, torch.int64)
    assert _forms(fwd) == ["mod64", "mod64"]
    assert _forms(inv) == ["limb64", "limb64"]


def test_24bit_widening_pass2():
    """The 64k unscaled 24-bit forward: pass 1 on the int32 tile, pass 2
    widening to int64 at 32 bits in (38 + 15 = 53): modular."""
    plan = LargeFFTPlan(FFTConfig(n=1 << 16, mode="unscaled", data_width=24,
                                  twiddle_width=16), device="cpu")
    assert (plan.mid_dtype, plan.out_dtype) == (torch.int32, torch.int64)
    assert _forms(plan) == ["int32", "mod64"]


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_core_is_int32(inverse):
    """The core's 64k transform runs on the int32 tile (int16 blocks, no
    int64 pass), scaled at 16 bits with 16-bit twiddles: every product
    keeps 16 bits above a shift of 15, the forward's DIF at its output
    width and the inverse's DIT at its input width, 31 in all: both passes
    modulo 2^32."""
    plan = LargeFFTPlan(FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                                  data_width=16, twiddle_width=16),
                        inverse=inverse, device="cpu")
    assert (plan.mid_dtype, plan.out_dtype) == (torch.int16, torch.int16)
    assert _forms(plan) == ["mod32", "mod32"]


@pytest.mark.parametrize("n,mode,dw,want", [
    (1 << 16, "scaled", 16, ["mod32", "mod32"]),
    (1 << 16, "unscaled", 16, ["int32", "int32"]),
    (1024, "unscaled", 8, ["mod32", "mod32"]),
], ids=["scaled16", "unscaled16", "unscaled8_1024"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_monolithic_forms(n, mode, dw, want, inverse):
    """The monolithic schedule reads 2-D stage tables in its i1 factor
    (pass 1 forward, pass 2 inverse), where every stage multiplies, the
    forward's last at the factor's output width: scaled 16-bit fits 32,
    unscaled 16-bit at 256 rows does not (16 + 8 + 15); 8 bits at 32 x
    32 do (8 + 5 + 15, and the second factor's 13 + 3 + 15)."""
    plan = LargeFFTPlan(FFTConfig(n=n, mode=mode, data_width=dw,
                                  twiddle_width=16),
                        schedule="monolithic", inverse=inverse, device="cpu")
    assert _forms(plan) == want


@pytest.mark.parametrize("dw,inverse,epilogue,want", [
    (43, False, False, "mod64"),    # DIF: last product at order 2, 49 bits
    (43, True, False, "limb64"),    # DIT: order 7 multiplies at 50 bits
    (42, True, False, "mod64"),
    (43, False, True, "limb64"),    # the epilogue wraps to 51 bits
    (41, False, True, "mod64"),
    (41, True, True, "mod64"),
], ids=["43-False-False-mod64", "43-True-False-int128",    # the cases'
        "42-True-False-mod64", "43-False-True-int128",     # names from
        "41-False-True-mod64", "41-True-True-mod64"])      # before limb64
def test_unscaled_widths_by_direction_and_epilogue(dw, inverse, epilogue,
                                                   want):
    """A 256-row unscaled pass with 16-bit twiddles (shift 15): the forward
    (DIF) wraps its products to the stage's output width and its last
    multiplying stage is order 2, the sixth, so its widest product is dw +
    6; the inverse (DIT) wraps to the input width and multiplies up to
    order 7 (dw + 7); the epilogue wraps to the output width (dw + 8)."""
    cfg = FFTConfig(n=256, mode="unscaled", data_width=dw, twiddle_width=16)
    assert product_form(cfg, torch.int64, inverse, epilogue) == want


@pytest.mark.parametrize("dw,inverse,epilogue,two_d,want", [
    (11, False, False, False, "mod32"),   # DIF: order 2 at 17 bits, 32
    (12, False, False, False, "int32"),
    (10, True, False, False, "mod32"),    # DIT: order 7 at 17 bits
    (11, True, False, False, "int32"),
    (9, False, True, False, "mod32"),     # the epilogue at 17 bits
    (10, False, True, False, "int32"),
    (10, True, True, False, "int32"),
    (9, False, False, True, "mod32"),     # 2-D: order 0 at 17 bits
    (10, False, False, True, "int32"),
    (10, True, False, True, "mod32"),     # 2-D DIT: order 7 at 17, as 1-D
    (11, True, False, True, "int32"),
])
def test_unscaled_int32_bound_by_direction(dw, inverse, epilogue, two_d,
                                           want):
    """The same 256-row unscaled pass on the int32 tile (out_dtype int32),
    at its bound of 32: the widest product plus the shift of 15 at 32 is
    modular (the fold's left shift is 0), at 33 exact; with the 2-D stage
    tables orders 0 and 1 multiply too, so the forward's widest product is
    at the factor's output width (dw + 8), the inverse's unchanged."""
    cfg = FFTConfig(n=256, mode="unscaled", data_width=dw, twiddle_width=16)
    assert product_form(cfg, torch.int32, inverse, epilogue,
                        two_d) == want


@pytest.mark.parametrize("dw,dtype,want", [
    (49, torch.int64, "mod64"), (50, torch.int64, "limb64"),
    (17, torch.int32, "mod32"), (18, torch.int32, "int32")],
    ids=["49-mod64", "50-int128", "17-mod32", "18-int32"])
def test_scaled_bound_is_sixty_four(dw, dtype, want):
    """Scaled, every product keeps dw bits: on the int64 tile 49 + 15 =
    64 is modular, 65 is not; on the int32 tile 17 + 15 = 32 is, 33 is
    not; in both directions, with and without the epilogue and the 2-D
    tables."""
    cfg = FFTConfig(n=256, mode="scaled", data_width=dw, twiddle_width=16)
    for inverse in (False, True):
        for epilogue in (False, True):
            for two_d in (False, True):
                assert product_form(cfg, dtype, inverse, epilogue,
                                    two_d) == want


@pytest.mark.parametrize("cfg,dtype,epilogue,want", [
    (FFTConfig(n=256, mode="scaled", data_width=16, twiddle_width=16),
     torch.int16, True, "mod32"),
    (FFTConfig(n=256, mode="scaled", data_width=16, twiddle_width=16),
     torch.int32, True, "mod32"),
    (FFTConfig(n=256, mode="unscaled", data_width=50, twiddle_width=16,
               bypass_fly=True), torch.int64, False, "mod64"),
    (FFTConfig(n=256, mode="unscaled", data_width=50, twiddle_width=16,
               bypass_fly=True), torch.int64, True, "limb64"),
    (FFTConfig(n=256, mode="unscaled", data_width=24, twiddle_width=16,
               bypass_fly=True), torch.int32, False, "mod32"),
    (FFTConfig(n=256, mode="unscaled", data_width=24, twiddle_width=16,
               bypass_fly=True), torch.int32, True, "int32"),
    (FFTConfig(n=256, mode="unscaled", data_width=8, twiddle_width=16),
     torch.int32, True, "mod32"),
], ids=["int16_blocks", "int32_blocks", "bypass_int64",
        "bypass_int64_epilogue", "bypass_int32", "bypass_int32_epilogue",
        "unscaled8_256"])
def test_int32_tile_and_bypass(cfg, dtype, epilogue, want):
    """Both int32-tile block types take the int32 tile's forms; a bypassed
    pass multiplies only in its epilogue (24 + 8 + 15 = 47 on the int32
    tile, 50 + 8 + 15 = 73 on the int64 tile: exact); an unscaled 8-bit
    transform of 256 points keeps at most its epilogue's 16 bits, 31 with
    the shift."""
    for inverse in (False, True):
        assert product_form(cfg, dtype, inverse, epilogue) == want


def test_products_note():
    """The plan.prepare span's note counts every form, in PRODUCT_FORMS'
    order; the C entries' flag is 1 for the two modular forms."""
    assert PRODUCT_FORMS == ("int32", "mod32", "mod64", "limb64", "int128")
    assert products_note(("mod64", "mod64")) == \
        "product int32 0 mod32 0 mod64 2 limb64 0 int128 0"
    assert products_note(["int32", "int128"]) == \
        "product int32 1 mod32 0 mod64 0 limb64 0 int128 1"
    assert products_note(("mod32", "mod32")) == \
        "product int32 0 mod32 2 mod64 0 limb64 0 int128 0"
    assert products_note(("limb64", "limb64")) == \
        "product int32 0 mod32 0 mod64 0 limb64 2 int128 0"
    assert [modular(f) for f in PRODUCT_FORMS] == [False, True, True,
                                                   False, False]
