"""The port's OverlapSaveConv (intfftk_tpu_torch.parallel.convolve) against
the JAX OverlapSaveConv (its Pallas engines in interpret mode) and against
golden overlap_save_int: the same numpy-seeded taps and signal, exactly
(tolerance 0).  Each side is handed its own ConvSpec class."""

import numpy as np
import pytest
import torch

from intfftk_tpu.golden import make_conv_spec, overlap_save_int
from intfftk_tpu.parallel.convolve import OverlapSaveConv as JaxConv
from intfftk_tpu_torch.convert import conv_spec_from_jax
from intfftk_tpu_torch.golden.convolve import ConvSpec
from intfftk_tpu_torch.ops.fused_fft import (LargeFFTPlan, fused_pass,
                                              fused_pass_reference)
from intfftk_tpu_torch.ops.intmath import (spectrum_product,
                                           spectrum_product_reference)
from intfftk_tpu_torch.ops.single_pass import FusedAxisFFT
from intfftk_tpu_torch.ops.transform import FFTPlan
from intfftk_tpu_torch.parallel import OverlapSaveConv


def _taps(m, width, seed=0, complex_taps=True):
    rng = np.random.default_rng(seed)
    lim = 1 << (width - 2)
    hr = rng.integers(-lim, lim, m)
    hi = rng.integers(-lim, lim, m) if complex_taps else np.zeros(m, np.int64)
    return hr, hi


def _signal(shape, width, seed=1):
    rng = np.random.default_rng(seed)
    lim = 1 << (width - 2)
    return rng.integers(-lim, lim, shape), rng.integers(-lim, lim, shape)


def _check(spec, h, x, kernel="auto", jax_kw=None, dtype=torch.int32):
    """Port == golden == JAX (when ``jax_kw`` is given) on one input."""
    port = OverlapSaveConv(conv_spec_from_jax(spec), *h, kernel=kernel,
                           device="cpu")
    assert isinstance(port.spec, ConvSpec)
    yr, yi = port(*x)
    assert yr.dtype == yi.dtype == dtype and tuple(yr.shape) == x[0].shape
    gr, gi = overlap_save_int(*x, *h, spec)
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)
    if jax_kw is not None:
        jr, ji = JaxConv(spec, *h, **jax_kw)(*x)
        np.testing.assert_array_equal(yr.numpy(), np.asarray(jr, np.int64))
        np.testing.assert_array_equal(yi.numpy(), np.asarray(ji, np.int64))
    return port


CASES = {
    # n, taps, data/taps width, rounding, batch, payloads
    "n256_complex12": (256, 33, 12, "truncate", (), 3),
    "n256_batched": (256, 17, 10, "truncate", (3,), 4),
    "n512_truncate": (512, 65, 16, "truncate", (), 4),
    "n512_round": (512, 65, 16, "round", (), 4),
}


@pytest.mark.parametrize("kernel", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("case", list(CASES))
def test_conv_vs_jax_and_golden(case, kernel):
    n, m, w, rounding, batch, payloads = CASES[case]
    spec = make_conv_spec(n=n, taps_len=m, data_width=w, taps_width=w,
                          rounding=rounding)
    h = _taps(m, w, seed=n + m)
    x = _signal(batch + (spec.payload * payloads,), w, seed=m)
    jax_kw = dict(kernel=kernel, interpret=True)
    port = _check(spec, h, x, kernel, jax_kw)
    engine = FFTPlan if kernel == "xla" else FusedAxisFFT
    assert isinstance(port.fwd, engine) and isinstance(port.inv, engine)
    assert port.kernel == ("xla" if kernel == "xla" else "pallas")


def test_conv_four_step_engine_wide():
    """The config-4 shape at a small size (tests/test_convolve.py): n =
    2^14, 2^11 + 1 taps, a 44-bit product on the raw-chained four-step
    pair; the forward is narrow int32, the inverse int64."""
    spec = make_conv_spec(n=1 << 14, taps_len=(1 << 11) + 1,
                          twiddle_width=16, max_product_width=44,
                          max_spectrum_width=25)
    assert spec.factors == (128, 128) and spec.product_width == 44
    h = _taps(spec.taps_len, 16)
    x = _signal((spec.payload * 2,), 16)
    port = _check(spec, h, x, jax_kw=dict(mesh=None, interpret=True),
                  dtype=torch.int64)
    assert port.wide and port.large
    assert isinstance(port.fwd, LargeFFTPlan) and port.fwd.order == "raw"
    assert (port.fwd.in_dtype, port.fwd.out_dtype, port.inv.in_dtype,
            port.inv.out_dtype) == (torch.int32, torch.int32, torch.int64,
                                    torch.int64)
    assert port.inv.block_in_shape == port.fwd.block_out_shape == (128, 128)
    assert tuple(port.hr.shape) == (128, 128) and port.hr.dtype == torch.int32
    # the plain version of the four-step engine gives the same bits
    before = fused_pass.launches, spectrum_product.launches
    pr, pi = port(*x, pass_fn=fused_pass_reference,
                  product_fn=spectrum_product_reference)
    yr, yi = port(*x)
    assert torch.equal(pr, yr) and torch.equal(pi, yi)
    # the CPU launches none
    assert (fused_pass.launches, spectrum_product.launches) == before


def test_conv_four_step_engine_narrow():
    """Four-step blocks with a product of at most 32 bits: int32 out."""
    spec = make_conv_spec(n=1 << 13, taps_len=1 << 10)
    assert spec.factors is not None and spec.product_width <= 32
    h = _taps(spec.taps_len, 16, complex_taps=False)
    x = _signal((2, spec.payload * 2), 16)
    port = _check(spec, h, x, jax_kw=dict(interpret=True))
    assert port.large and not port.wide


def test_conv_errors():
    spec = conv_spec_from_jax(make_conv_spec(n=256, taps_len=33))
    h = _taps(33, 16)
    conv = OverlapSaveConv(spec, *h, device="cpu")
    with pytest.raises(ValueError, match="multiple of payload"):
        conv(np.zeros(spec.payload + 1), np.zeros(spec.payload + 1))
    with pytest.raises(ValueError, match="bad kernel"):
        OverlapSaveConv(spec, *h, kernel="mosaic", device="cpu")
    wide = conv_spec_from_jax(make_conv_spec(
        n=1 << 14, taps_len=(1 << 11) + 1, twiddle_width=16,
        max_product_width=44, max_spectrum_width=25))
    hw = _taps(wide.taps_len, 16)
    with pytest.raises(NotImplementedError, match="four-step pallas engine"):
        OverlapSaveConv(wide, *hw, kernel="xla", device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        OverlapSaveConv(spec, *h)                # no card here, none asked


def test_conv_product_goes_through_spectrum_product():
    """The frequency product is one ``spectrum_product`` call per
    convolution, handed the spec's shift and widths and the inverse's
    input dtype; a substitute ``product_fn`` sees exactly that."""
    spec = make_conv_spec(n=1 << 14, taps_len=(1 << 11) + 1,
                          twiddle_width=16, max_product_width=44,
                          max_spectrum_width=25)
    h = _taps(spec.taps_len, 16)
    x = _signal((spec.payload * 2,), 16)
    port = OverlapSaveConv(conv_spec_from_jax(spec), *h, device="cpu")
    seen = []

    def spy(fr, fi, hr, hi, shift, out_width, spectrum_width, out_dtype):
        seen.append((fr.dtype, tuple(fr.shape[1:]), hr.dtype, shift,
                     out_width, spectrum_width, out_dtype))
        return spectrum_product_reference(fr, fi, hr, hi, shift, out_width,
                                          spectrum_width, out_dtype)

    yr, yi = port(*x, product_fn=spy)
    assert seen == [(torch.int32, (128, 128), torch.int32,
                     spec.product_shift, 44, 25, torch.int64)]
    gr, gi = overlap_save_int(*x, *h, spec)
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)
