"""The port's OverlapSaveConv (intfftk_tpu_torch.parallel.convolve) against
the JAX OverlapSaveConv (its Pallas engines in interpret mode) and against
golden overlap_save_int: the same numpy-seeded taps and signal, exactly
(tolerance 0).  Each side is handed its own ConvSpec class."""

import weakref

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
from intfftk_tpu_torch.ops.pair import FFTPairPlan
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
    assert port.wide and port.large and isinstance(port.pair, FFTPairPlan)
    fwd, inv = port.pair.fwd, port.pair.inv
    assert isinstance(fwd, LargeFFTPlan) and fwd.order == "raw"
    assert (fwd.in_dtype, fwd.out_dtype, inv.in_dtype, inv.out_dtype) == (
        torch.int32, torch.int32, torch.int64, torch.int64)
    assert inv.block_in_shape == fwd.block_out_shape == (128, 128)
    assert inv.cfg == conv_spec_from_jax(spec).ifft_cfg
    hr = port.pair.hr
    assert tuple(hr.shape) == (128, 128) and hr.dtype == torch.int32
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
    assert port.pair.inv.cfg == conv_spec_from_jax(spec).ifft_cfg


#: Specs of the four-step engine at a small size: (make_conv_spec's
#: arguments, the edges the chain takes).  A 44-bit product runs the
#: inverse on int64 blocks with products modulo 2^64 (the cut's form); a
#: 32-bit one on int32 blocks (no cut); a lead of no whole rows of 64
#: takes no edge.
EDGE_SPECS = {
    "window_cut": (dict(n=4096, taps_len=129, factors=(64, 64),
                        twiddle_width=16, max_spectrum_width=25,
                        max_product_width=44), ("window", "cut")),
    "window_only": (dict(n=4096, taps_len=129, factors=(64, 64)),
                    ("window",)),
    "lead_not_whole_rows": (dict(n=4096, taps_len=100, factors=(64, 64),
                                 twiddle_width=16, max_spectrum_width=25,
                                 max_product_width=44), ()),
}


def _glue(port):
    """The same convolution with torch's windows and cut (no edges)."""
    port.edges = ()
    return port


@pytest.mark.parametrize("engine", ["edges", "glue"])
def test_conv_frees_its_blocks_before_the_inverse(monkeypatch, engine):
    """Nothing of the signal's size that the convolution made lives while
    P1 and the inverse allocate (on the card, a graph's pool reuses its
    memory).  With the edges no window blocks exist: the forward reads
    views of the caller's signal and the inverse writes the output.  On
    torch's windows and cut (a lead of no whole rows; the mesh), the
    windows cast to the forward's blocks are garbage once the forward has
    read them."""
    kw, sides = EDGE_SPECS["window_cut" if engine == "edges"
                           else "lead_not_whole_rows"]
    spec = make_conv_spec(**kw)
    h = _taps(spec.taps_len, 16)
    port = OverlapSaveConv(conv_spec_from_jax(spec), *h, device="cpu")
    assert port.edges == sides
    x = [torch.as_tensor(v, dtype=torch.int32)
         for v in _signal((2 * spec.payload,), 16)]
    seen, alive, outs = [], [], []
    fwd, inv = port.pair.fwd.apply_blocks, port.pair.inv.apply_blocks

    def forward(xr, xi, pass_fn=None, window=None):
        seen.extend((x.data_ptr(), tuple(x.shape), window) for x in (xr, xi))
        blocks.extend(weakref.ref(x) for x in (xr, xi))
        return fwd(xr, xi, pass_fn=pass_fn, window=window)

    def inverse(xr, xi, pass_fn=None, cut=None):
        alive.extend(b() is not None for b in blocks)
        y = inv(xr, xi, pass_fn=pass_fn, cut=cut)
        outs.extend(v.data_ptr() for v in y)
        return y

    blocks = []
    monkeypatch.setattr(port.pair.fwd, "apply_blocks", forward)
    monkeypatch.setattr(port.pair.inv, "apply_blocks", inverse)
    yr, yi = port(*x)
    if engine == "edges":
        window = seen[0][2]
        assert window is not None and window.lead == spec.taps_len - 1
        # views of the caller's own signal, no copy
        assert [s[:2] for s in seen] == [
            (v.data_ptr(), (1, 2 * spec.payload)) for v in x]
        assert outs == [yr.data_ptr(), yi.data_ptr()]
    else:
        assert [s[2] for s in seen] == [None, None]
    assert alive == [False, False]
    gr, gi = overlap_save_int(*(v.numpy() for v in x), *h, spec)
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)


#: (spec, signal shape in payloads, seed): one payload (block 0's lead of
#: zeros alone), several, a batch of three rows (each row's block 0 its
#: own lead), and the specs that take the window alone or no edge.
EDGE_CASES = {
    "one_payload": ("window_cut", (1,), 1),
    "several_payloads": ("window_cut", (5,), 2),
    "batched_rows": ("window_cut", (3, 2), 3),
    "window_only": ("window_only", (2, 3), 4),
    "lead_not_whole_rows": ("lead_not_whole_rows", (3,), 5),
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_conv_edges_equal_golden_and_glue(case):
    """The four-step engine with the edges (the forward's pass 1 reading
    the signal in place, the inverse's pass 2 writing the output in place;
    the plain ``fused_pass_reference`` applies the kernel's offsets and
    predicates) equals golden ``overlap_save_int`` and torch's windows and
    cut; a spec whose lead is no whole rows takes no edge and keeps the
    glue path."""
    name, shape, seed = EDGE_CASES[case]
    kw, sides = EDGE_SPECS[name]
    spec = make_conv_spec(**kw)
    h = _taps(spec.taps_len, 16, seed=seed)
    x = _signal(shape[:-1] + (shape[-1] * spec.payload,), 16, seed=seed)
    # adversarial full-scale samples on each row's first and last block
    for v in x:
        v[..., :spec.payload:3] = (1 << 15) - 1
        v[..., -spec.payload::5] = -(1 << 15)
    port = OverlapSaveConv(conv_spec_from_jax(spec), *h, device="cpu")
    assert port.edges == sides
    plain = dict(pass_fn=fused_pass_reference,
                 product_fn=spectrum_product_reference)
    yr, yi = port(*x, **plain)
    gr, gi = overlap_save_int(*x, *h, spec)
    assert tuple(yr.shape) == x[0].shape
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)
    qr, qi = _glue(port)(*x, **plain)
    assert torch.equal(qr, yr) and torch.equal(qi, yi)


def test_pair_without_edges_is_unchanged():
    """``FFTPairPlan.apply_blocks`` without edges runs the passes with the
    keyword arguments it always had (no window, no cut) on blocks, and the
    convolution's edges through the same pair give the glue path's bits."""
    kw, _ = EDGE_SPECS["window_cut"]
    spec = make_conv_spec(**kw)
    port = OverlapSaveConv(conv_spec_from_jax(spec), *_taps(129, 16),
                           device="cpu")
    calls = []

    def spy(xr, xi, cfg, **kw):
        calls.append(sorted(kw))
        return fused_pass_reference(xr, xi, cfg, **kw)

    blocks = [torch.zeros((2,) + port.pair.fwd.block_in_shape,
                          dtype=torch.int32) for _ in range(2)]
    yr, _ = port.pair.apply_blocks(*blocks, pass_fn=spy)
    assert yr.shape == (2,) + port.pair.inv.block_out_shape
    assert all("window" not in c and "cut" not in c for c in calls)
    assert len(calls) == 4
    calls.clear()
    x = _signal((spec.payload,), 16)
    port(*x, pass_fn=spy, product_fn=spectrum_product_reference)
    assert ["window" in c for c in calls] == [True, False, False, False]
    assert ["cut" in c for c in calls] == [False, False, False, True]


@pytest.mark.parametrize("name", list(EDGE_SPECS))
def test_conv_build_notes_its_edges(name):
    """The convolution's ``plan.build`` span notes the edges its chain
    takes: "edges window cut" on the four-step engine where the lead and
    the payload are whole rows, "edges none" where torch's windows and cut
    run; an ``FFTPairPlan`` alone notes no edges (it reads and writes
    blocks unless a caller hands it ``Edges``)."""
    from intfftk_tpu_torch.runtime import trace

    kw, sides = EDGE_SPECS[name]
    spec = conv_spec_from_jax(make_conv_spec(**kw))
    with trace.recording() as rec:
        OverlapSaveConv(spec, *_taps(spec.taps_len, 16), device="cpu")
    assert rec.spans[0].name == "plan.build"
    assert rec.spans[0].note == "edges " + (" ".join(sides) or "none")
    with trace.recording() as rec:
        port = OverlapSaveConv(conv_spec_from_jax(make_conv_spec(
            n=256, taps_len=33)), *_taps(33, 16), device="cpu")
    assert not port.large and rec.spans[0].note == "edges none"
    with trace.recording() as rec:
        FFTPairPlan(spec.fft_cfg, (np.zeros(spec.n, np.int64),) * 2,
                    product_shift=spec.product_shift,
                    spectrum_width=spec.spectrum_width,
                    product_width=spec.product_width, factors=spec.factors,
                    device="cpu")
    assert not any("edges" in s.note for s in rec.spans)


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
