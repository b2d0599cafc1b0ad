"""``FFTPairPlan``, the FFT -> spectrum product -> IFFT pair, at the widths
of BASELINE config 2 (32-bit unscaled data, 20-bit twiddles, a 25-bit
spectrum shifted down by 23, the product at the forward's output width,
the inverse scaled with round-half-up): on the CPU the plan equals the
benchmark's plain PyTorch reference (``benchmark/plain/pair.py``), and
both equal the JAX package's golden composition (``four_step_int`` ->
``cmult_int`` -> inverse ``four_step_int``) and the benchmark's frozen
NumPy copy of it, bit for bit, on frames of a carrier with noise and on
uniform frames; the reference's limb product equals Python's integers at
the 64k widths' extremes; the control (product-sums
modulo 2^64) differs where a carrier drives P1's sums past 2^63; a
spectrum wider than its width is refused; against a stub of the kernel
library, a call is the forward chain, one product and the inverse chain
handing each other their tensors, and the ``plan.prepare`` notes give the
forms.  The ``cuda`` tests run the 64k plan on the card, eager and
captured, against the plain reference there; they skip without a card."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.builders.fft_pair import quadratic_phase, tone_frames
from benchmark.plain import pair as plain
from benchmark.reference.int_model import cmult_int
from intfftk_tpu_torch import FFTConfig, FFTPairPlan
from intfftk_tpu_torch.ops import _build, fused_fft, intmath
from intfftk_tpu_torch.ops import pair as pair_module
from intfftk_tpu_torch.ops.fused_fft import fused_pass
from intfftk_tpu_torch.ops.intmath import spectrum_product
from intfftk_tpu_torch.runtime import trace

from test_torch_submit import StubLibrary

SHIFT, SPECTRUM_WIDTH = 23, 25
#: the carrier and noise of the benchmark's traffic ``tone32_b8``
TRAFFIC = {"tone_log2": 30, "noise_bits": 20}


def _config(n):
    return FFTConfig(n=n, mode="unscaled", data_width=32, twiddle_width=20)


def _reference_configs(n):
    cfg = reference.FFTConfig(n=n, mode="unscaled", data_width=32,
                              twiddle_width=20)
    return cfg, dataclasses.replace(cfg, mode="scaled", rounding="round",
                                    data_width=cfg.output_width)


def _frames(kind, n, count, seed, device="cpu"):
    if kind == "carrier":
        return tone_frames(count, n, TRAFFIC, seed, torch.device(device))
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randint(-(1 << 31), 1 << 31, (count, n),
                               generator=gen, dtype=torch.int64).to(device)
                 for _ in range(2))


def _plan(n, factors, device="cpu"):
    return FFTPairPlan(_config(n), quadratic_phase(n, SHIFT),
                       product_shift=SHIFT, spectrum_width=SPECTRUM_WIDTH,
                       factors=factors, device=device)


def _call(plan, xr, xi):
    shape = (xr.shape[0],) + plan.fwd.block_in_shape
    return plan(*(x.to(torch.int32).reshape(shape) for x in (xr, xi)))


def _plain(xr, xi, n, factors, product_sums="exact"):
    cfg, icfg = _reference_configs(n)
    return plain.pair(xr, xi, cfg, icfg, quadratic_phase(n, SHIFT), SHIFT,
                      factors, product_sums=product_sums)


def _frozen(xr, xi, n, factors):
    cfg, icfg = _reference_configs(n)
    n1, n2 = factors
    hr, hi = (h.astype(object) for h in quadratic_phase(n, SHIFT))
    fr, fi = reference.four_step_int(xr.numpy(), xi.numpy(), cfg, n1, n2)
    pr, pi = cmult_int(fr, fi, hr, hi, SHIFT, icfg.data_width)
    return reference.four_step_int(pr, pi, icfg, n2, n1, inverse=True)


def _jax_golden(xr, xi, n, factors):
    """The JAX package's golden pair on the same frames (imported here: the
    ``cuda`` tests of this file run on the card, which has no JAX)."""
    from intfftk_tpu import FFTConfig as JaxConfig
    from intfftk_tpu import golden

    cfg = JaxConfig(n=n, mode="unscaled", data_width=32, twiddle_width=20)
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    n1, n2 = factors
    hr, hi = (h.astype(object) for h in quadratic_phase(n, SHIFT))
    fr, fi = golden.four_step_int(xr.numpy(), xi.numpy(), cfg, n1, n2)
    pr, pi = golden.cmult_int(fr, fi, hr, hi, SHIFT, icfg.data_width)
    return golden.four_step_int(pr, pi, icfg, n2, n1, inverse=True)


@pytest.mark.parametrize("n, factors, kind", [
    (1024, (32, 32), "carrier"), (1024, (32, 32), "uniform"),
    (4096, (64, 64), "carrier"), (4096, (64, 64), "uniform")])
def test_pair_equals_plain_and_frozen_references(n, factors, kind):
    xr, xi = _frames(kind, n, 3, n + len(kind))
    assert xr.abs().max() < 1 << 31 and xi.abs().max() < 1 << 31
    plan = _plan(n, factors)
    assert (plan.fwd.n1, plan.fwd.n2) == factors
    width = plan.product_width
    assert width == plan.inv.cfg.data_width == 31 + n.bit_length()
    got = [y.reshape(3, n) for y in _call(plan, xr, xi)]
    want = _plain(xr, xi, n, factors)
    frozen = _frozen(xr, xi, n, factors)
    jax_golden = _jax_golden(xr, xi, n, factors)
    for g, w, f, j in zip(got, want, frozen, jax_golden):
        assert g.dtype == torch.int64
        assert torch.equal(g, w)
        j = np.asarray(j, dtype=np.int64)
        np.testing.assert_array_equal(g.numpy(), j)
        np.testing.assert_array_equal(w.numpy(), j)
        np.testing.assert_array_equal(np.asarray(f, dtype=np.int64), j)


def _wrap_exact(v, w):
    m = 1 << (w - 1)
    return ((v + m) % (1 << w)) - m


#: data at the 64k pair's widest, 48 bits: both ends and their neighbours
DATA_48 = [-(1 << 47), -(1 << 47) + 1, -(1 << 46) - 3, -(1 << 24) - 1,
           -(1 << 24), -1, 0, 1, (1 << 24) - 1, 1 << 24, (1 << 46) + 5,
           (1 << 47) - 2, (1 << 47) - 1]


@pytest.mark.parametrize("shift, reach", [
    (SHIFT, 1 << 24),            # P1: a 25-bit spectrum, shifted by 23
    (18, 1 << 19)])              # a pass: 20-bit twiddles, shifted by 18
@pytest.mark.parametrize("width", [48, 44])
def test_plain_cmult_is_exact_at_the_64k_extremes(shift, reach, width):
    """``plain.cmult`` against Python's integers: every pair of 48-bit data
    extremes against factors at +-reach and beside it (sums up to
    2^48 * reach, past 64 bits), floor-shifted and wrapped as
    ``cmult_int`` does."""
    factors = [-reach, -reach + 1, -1, 0, 1, reach - 1, reach]
    cases = [(a, b, c, d) for a in DATA_48 for b in DATA_48[::3]
             for c in factors for d in factors]
    br, bi, c, d = (torch.tensor(col, dtype=torch.int64)
                    for col in zip(*cases))
    got = plain.cmult(br, bi, c, d, shift, width)
    assert max(abs(a * c - b * d) for a, b, c, d in cases) == \
        (1 << 48) * reach                        # past 2^64
    for k, (a, b, cc, dd) in enumerate(cases):
        want = (_wrap_exact((a * cc - b * dd) >> shift, width),
                _wrap_exact((b * cc + a * dd) >> shift, width))
        assert (int(got[0][k]), int(got[1][k])) == want, (a, b, cc, dd)


def test_control_differs_on_carrier_frames():
    """At 4096 points a carrier of 2^30 reaches about 2^42 in its bin, and
    P1's sums against the 2^23 spectrum pass 2^63: formed modulo 2^64
    they give other bits."""
    n, factors = 4096, (64, 64)
    xr, xi = _frames("carrier", n, 4, 11)
    want = _plain(xr, xi, n, factors)
    ctl = _plain(xr, xi, n, factors, product_sums="mod64")
    assert sum(int((a != b).sum()) for a, b in zip(want, ctl)) > 0


@pytest.mark.parametrize("part, value", [(0, 1 << 24), (1, -(1 << 24) - 1),
                                         (0, 1 << 30)])
def test_spectrum_wider_than_its_width_is_refused(part, value):
    n = 256
    table = [np.array(h) for h in quadratic_phase(n, SHIFT)]
    table[part][5] = value
    with pytest.raises(ValueError, match="wider than 25 bits"):
        FFTPairPlan(_config(n), table, product_shift=SHIFT,
                    spectrum_width=SPECTRUM_WIDTH, factors=(16, 16),
                    device="cpu")
    table[part][5] = -(1 << 24)              # the least 25-bit value
    FFTPairPlan(_config(n), table, product_shift=SHIFT,
                spectrum_width=SPECTRUM_WIDTH, factors=(16, 16),
                device="cpu")


def test_spectrum_of_the_wrong_length_is_refused():
    hr, hi = quadratic_phase(512, SHIFT)
    with pytest.raises(ValueError, match="expected 256 integers"):
        FFTPairPlan(_config(256), (hr, hi), product_shift=SHIFT,
                    spectrum_width=SPECTRUM_WIDTH, factors=(16, 16),
                    device="cpu")


def test_blocks_of_another_shape_or_dtype_are_refused():
    plan = _plan(256, (16, 16))
    x = torch.zeros(2, 16, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="blocks"):
        plan(x.long(), x.long())
    with pytest.raises(ValueError, match="blocks"):
        plan(x.reshape(2, 8, 32), x.reshape(2, 8, 32))


@pytest.fixture
def lib(monkeypatch):
    """A stub of the kernel library, the launch path taken on CPU
    tensors (as ``test_torch_submit.py``'s)."""
    stub = StubLibrary()
    monkeypatch.setattr(_build, "library", lambda threads=None: stub)
    for mod in (fused_fft, intmath, pair_module):
        monkeypatch.setattr(mod, "use_kernel", lambda device: True)
    for mod in (fused_fft, intmath):
        monkeypatch.setattr(mod, "stream_handle", lambda device: 0)
    monkeypatch.setattr(fused_pass, "launches", 0)
    monkeypatch.setattr(spectrum_product, "launches", 0)
    return stub


def test_call_is_two_chains_and_one_product(lib):
    """The 64k plan of config 2: the forward chain (two modular passes),
    P1 on 48-bit data in __int128 writing int64, the inverse chain (two
    exact passes, in limbs); each reads what the one before wrote, with
    nothing in between; prepared once, noted in the ``plan.prepare``
    spans."""
    n = 1 << 16
    plan = _plan(n, (256, 256))
    x = torch.zeros((2, 256, 256), dtype=torch.int32)
    with trace.recording() as rec:
        plan(x, x)
        plan(x, x)
    notes = [s.note for s in rec.spans if s.name == "plan.prepare"]
    assert notes == [
        "product int32 0 mod32 0 mod64 2 limb64 0 int128 0 skew 0 "
        "epi host 524288",
        "p1 int128",
        "product int32 0 mod32 0 mod64 0 limb64 2 int128 0 skew 0 "
        "epi host 524288"]
    kinds = [k for k, _, _ in lib.launched]
    assert kinds == ["chain", "chain", "product", "chain", "chain"] * 2
    assert lib.chain_calls == 4
    assert (fused_pass.launches, spectrum_product.launches) == (8, 2)
    fwd2, product, inv1 = lib.launched[1], lib.launched[2], lib.launched[3]
    # numel, table, in and out bytes, the __int128 form, shift, width
    assert product[1][:7] == (2 * n, n, 8, 8, 1, SHIFT, 48)
    assert product[2][:2] == fwd2[2][10:12]      # P1 reads the forward's
    assert inv1[2][:2] == product[2][4:6]        # the inverse reads P1's
    assert product[2][2:4] == (plan.hr.data_ptr(), plan.hi.data_ptr())


def test_narrow_pair_takes_the_long_long_product(lib):
    """Where the forward's output fits int32 (16-bit data at 4096 points:
    28 bits) P1 forms its sums in long long."""
    cfg = FFTConfig(n=4096, mode="unscaled", data_width=16, twiddle_width=16)
    plan = FFTPairPlan(cfg, quadratic_phase(4096, 14), product_shift=14,
                       spectrum_width=16, device="cpu")
    x = torch.zeros((1,) + plan.fwd.block_in_shape, dtype=torch.int32)
    with trace.recording() as rec:
        plan(x, x)
    assert [s.note for s in rec.spans if s.name == "plan.prepare"][1] == \
        "p1 long long"


def test_capture_on_cpu_raises():
    plan = _plan(256, (16, 16))
    x = torch.zeros(1, 16, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        plan.capture()(x, x)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["carrier", "uniform"])
def test_pair_64k_on_card(dev, kind):
    """The 64k plan on the card, eager and captured: five launches a call,
    bits equal to the plain reference computed on the card; P1 noted in
    __int128."""
    n, factors, batch = 1 << 16, (256, 256), 8
    with trace.recording() as rec:
        plan = _plan(n, factors, device=dev)
        xr, xi = _frames(kind, n, batch, 5, device=dev)
        before = (fused_pass.launches, spectrum_product.launches)
        y = _call(plan, xr, xi)
        torch.cuda.synchronize()
        assert (fused_pass.launches - before[0],
                spectrum_product.launches - before[1]) == (4, 1)
    notes = [s.note for s in rec.spans if s.name == "plan.prepare"]
    assert notes == [
        "product int32 0 mod32 0 mod64 2 limb64 0 int128 0 skew 0 "
        "epi host 524288",
        "p1 int128",
        "product int32 0 mod32 0 mod64 0 limb64 2 int128 0 skew 0 "
        "epi host 524288"]
    want = _plain(xr, xi, n, factors)
    call = plan.capture()
    x = tuple(v.to(torch.int32).reshape((batch,) + factors)
              for v in (xr, xi))
    z = call(*x)
    for a, b, w in zip(y, z, want):
        assert torch.equal(a.reshape(batch, n), w)
        assert torch.equal(b.reshape(batch, n), w)


@pytest.mark.cuda
def test_pair_64k_adversarial_on_card(dev):
    """The 64k plan on the card on full-scale adversarial 32-bit frames:
    frame 0 at the top value in its first half and the least in its second
    (imaginary the other way), frame 1 at the top value throughout (a DC of
    2^16 (2^31 - 1), at the top of the forward's 48 bits, which P1 spreads
    over every bin of the inverse's input); the inverse's passes in limbs,
    the output equal to the golden pair (the frozen NumPy composition) bit
    for bit."""
    n, factors = 1 << 16, (256, 256)
    lo, hi = -(1 << 31), (1 << 31) - 1
    xr = torch.full((2, n), hi, dtype=torch.int64)
    xi = xr.clone()
    xr[0, n // 2:] = lo
    xi[0, :n // 2] = lo
    plan = _plan(n, factors, device=dev)
    with trace.recording() as rec:
        y = _call(plan, xr.to(dev), xi.to(dev))
    notes = [s.note for s in rec.spans if s.name == "plan.prepare"]
    assert notes[-1] == \
        "product int32 0 mod32 0 mod64 0 limb64 2 int128 0 skew 0 " \
        "epi host 524288"
    for got, want in zip(y, _frozen(xr, xi, n, factors)):
        np.testing.assert_array_equal(got.reshape(2, n).cpu().numpy(),
                                      np.asarray(want, dtype=np.int64))
