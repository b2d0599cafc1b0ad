"""The port's Channelizer (intfftk_tpu_torch.parallel) on one device
against the JAX Channelizer on the virtual 8-device CPU mesh (Pallas in
interpret mode) and golden fft_int, exactly: both layouts, both
directions, the kernel and the staged engine.  The benchmark's plain
PyTorch reference of BASELINE config 3 (``benchmark/plain/channelizer.py``)
equals the frozen NumPy ``fft_int`` and the JAX package's golden one at
n = 4096 (the Taylor-corrected stage p = 11 among its twelve), and the
port equals it; its truncating control differs.  ``capture()`` raises on
CPU tensors and its graphs go with ``retune`` and ``.to()``.  The
``cuda`` tests run the captured call on the card at the cell's size
against the eager call and the plain reference; they skip without a card.
The JAX package is imported inside the tests that compare with it: the
``cuda`` tests of this file run on the card, which has no JAX."""

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.plain import channelizer as plain
from intfftk_tpu_torch.config import FFTConfig as PortConfig
from intfftk_tpu_torch.convert import config_from_jax as P
from intfftk_tpu_torch.golden import random_stimulus
from intfftk_tpu_torch.ops.fused_fft import fused_pass
from intfftk_tpu_torch.ops.single_pass import FusedAxisFFT, PallasFFTPlan
from intfftk_tpu_torch.ops.transform import FFTPlan
from intfftk_tpu_torch.parallel import Channelizer, local_plan, resolve_kernel

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]
#: BASELINE config 3's transform: 4096 points, scaled, round-half-up,
#: 16-bit data and twiddles
C3 = dict(n=4096, mode="scaled", rounding="round", data_width=16,
          twiddle_width=16)


def _jax():
    """The JAX package's ``FFTConfig`` and golden ``fft_int``."""
    from intfftk_tpu.config import FFTConfig
    from intfftk_tpu.golden import fft_int

    return FFTConfig, fft_int


def _stimulus(ch, n, seed):
    """Random 16-bit channels; channel 0 is the full-scale pattern that
    drives the round-mode difference to +2^15."""
    re, im = random_stimulus(n, 16, seed=seed, batch=(ch,))
    re[0] = -(1 << 15)
    re[0, ::3] = (1 << 15) - 1
    return re, im


def _bank(kind, ch, n, seed):
    """[ch, n] int64 channels of 16-bit samples.  "uniform": every sample
    uniform over the full scale.  "adversarial": channel 0 as
    ``_stimulus``'s; channel 1 pairs (max, min) in every butterfly of the
    first stage, p = log2(n) - 1 (the imaginary part the other way);
    channel 2 the most-negative value throughout (the guarded negates);
    channel 3 the top value throughout (a DC at full scale); the rest
    uniform."""
    if kind == "uniform":
        return random_stimulus(n, 16, seed=seed, batch=(ch,))
    re, im = _stimulus(ch, n, seed)
    lo, hi = -(1 << 15), (1 << 15) - 1
    top = np.arange(n) >= n // 2
    re[1], im[1] = np.where(top, lo, hi), np.where(top, hi, lo)
    re[2] = im[2] = lo
    re[3] = im[3] = hi
    return re, im


def _plain(re, im, layout, **over):
    """``plain.channelize`` of [ch, n] channels in ``layout`` under
    BASELINE config 3's transform (``over`` changes it), as [ch, n]."""
    cfg = reference.FFTConfig(**dict(C3, n=re.shape[-1], **over))
    turn = (lambda v: v) if layout == "cn" else (lambda v: v.T)
    y = plain.channelize(*(torch.as_tensor(turn(v)) for v in (re, im)),
                         cfg, layout, block=5)
    return [turn(v.numpy()) for v in y]


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("layout", ["cn", "nc"])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_channelizer_vs_jax(mode, rounding, layout, inverse):
    """256 channels x n = 128: the port == the JAX Channelizer sharded
    over 8 CPU devices == golden; the CPU runs the plain version."""
    from conftest import cpu_mesh
    from intfftk_tpu.parallel.channelizer import \
        Channelizer as JaxChannelizer
    from intfftk_tpu.parallel.mesh import CHANNEL_AXIS

    FFTConfig, fft_int = _jax()
    n, ch = 128, 256
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding)
    re, im = _stimulus(ch, n, seed=ch + n)
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    if layout == "nc":
        re, im, gr, gi = re.T, im.T, gr.T, gi.T
    port = Channelizer(P(cfg), inverse=inverse, layout=layout, device="cpu")
    assert port.kernel == "pallas"
    xr, xi = port.shard(re), port.shard(im)
    assert xr.dtype == torch.int32 and xr.device.type == "cpu"
    before = fused_pass.launches
    yr, yi = port(xr, xi)
    assert fused_pass.launches == before
    assert yr.dtype == torch.int32 and tuple(yr.shape) == re.shape
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)
    jax_ch = JaxChannelizer(cfg, cpu_mesh((8,), (CHANNEL_AXIS,)),
                            inverse=inverse, layout=layout)
    jr, ji = jax_ch(jax_ch.shard(re), jax_ch.shard(im))
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_channelizer_4096(inverse):
    """The published size's transform, n = 4096 scaled/round, on 4
    channels of a [4, 2, n] batch ("cn" takes any leading shape)."""
    FFTConfig, fft_int = _jax()
    cfg = FFTConfig(n=4096, mode="scaled", rounding="round")
    re, im = _stimulus(8, 4096, seed=3)
    port = Channelizer(P(cfg), inverse=inverse, device="cpu")
    yr, yi = port(port.shard(re.reshape(4, 2, 4096)),
                  port.shard(im.reshape(4, 2, 4096)))
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    np.testing.assert_array_equal(yr.reshape(8, 4096).numpy(), gr)
    np.testing.assert_array_equal(yi.reshape(8, 4096).numpy(), gi)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_channelizer_staged_engine(inverse):
    """kernel="xla": the staged engine, on the CPU, same bits, int32."""
    FFTConfig, fft_int = _jax()
    cfg = FFTConfig(n=64, mode="scaled", rounding="truncate")
    re, im = _stimulus(16, 64, seed=4)
    port = Channelizer(P(cfg), inverse=inverse, kernel="xla", device="cpu")
    assert isinstance(port.plan, FFTPlan)
    yr, yi = port(port.shard(re), port.shard(im))
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    assert yr.dtype == torch.int32
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)


def test_engine_choice():
    FFTConfig, _ = _jax()
    small, big = FFTConfig(n=4096), FFTConfig(n=8192)
    assert resolve_kernel("auto", "cpu", P(small)) == "pallas"
    assert resolve_kernel("auto", "cpu", P(small), P(big)) == "xla"
    assert resolve_kernel("xla", "cpu", P(small)) == "xla"
    with pytest.raises(ValueError):
        resolve_kernel("mosaic", "cpu", P(small))
    assert isinstance(local_plan(P(small), True, "pallas", device="cpu"), FusedAxisFFT)
    assert isinstance(local_plan(P(small), True, "xla", device="cpu"), FFTPlan)
    nc = Channelizer(P(FFTConfig(n=64)), layout="nc", device="cpu")
    assert isinstance(nc.plan, PallasFFTPlan) and nc.plan.layout == "nb"
    with pytest.raises(NotImplementedError):
        Channelizer(P(FFTConfig(n=64)), kernel="xla", layout="nc", device="cpu")
    with pytest.raises(ValueError):
        Channelizer(P(FFTConfig(n=64)), layout="bn", device="cpu")


@pytest.mark.parametrize("layout", plain.LAYOUTS)
@pytest.mark.parametrize("rounding", ["round", "truncate"])
@pytest.mark.parametrize("kind", ["uniform", "adversarial"])
def test_plain_channelizer_equals_fft_int(kind, rounding, layout):
    """BASELINE config 3's transform (n = 4096, scaled, 16-bit data and
    twiddles, whose stage p = 11 takes the Taylor-corrected table) on 12
    channels: the plain PyTorch reference, in blocks of 5 channels, equals
    the frozen NumPy ``fft_int`` and the JAX package's golden one."""
    FFTConfig, fft_int = _jax()
    re, im = _bank(kind, 12, 4096, seed=11)
    got = _plain(re, im, layout, rounding=rounding)
    frozen = reference.fft_int(re, im, reference.FFTConfig(
        **dict(C3, rounding=rounding)))
    golden = fft_int(re, im, FFTConfig(**dict(C3, rounding=rounding)))
    for g, f, j in zip(got, frozen, golden):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, np.asarray(f))
        np.testing.assert_array_equal(g, np.asarray(j))


@pytest.mark.parametrize("n, ch", [(4096, 12), (256, 64)])
@pytest.mark.parametrize("kind", ["uniform", "adversarial"])
def test_truncating_control_differs(kind, n, ch):
    """The control (each scaled stage truncating) reads other bits than
    the reference on the stimuli the reference is held to."""
    re, im = _bank(kind, ch, n, seed=n)
    want = _plain(re, im, "cn")
    ctl = _plain(re, im, "cn", rounding="truncate")
    assert sum(int((a != b).sum()) for a, b in zip(want, ctl)) > 0


@pytest.mark.parametrize("layout", plain.LAYOUTS)
@pytest.mark.parametrize("kind", ["uniform", "adversarial"])
def test_port_equals_plain_reference(kind, layout):
    """The port's Channelizer on the CPU (the pass's plain version) at
    n = 256 on 64 channels, int32 in and out, equals the plain reference
    in both layouts."""
    n, ch = 256, 64
    re, im = _bank(kind, ch, n, seed=5)
    port = Channelizer(PortConfig(**dict(C3, n=n)), layout=layout,
                       device="cpu")
    turn = (lambda v: v) if layout == "cn" else (lambda v: v.T)
    got = port(*(torch.as_tensor(turn(v)).to(torch.int32) for v in (re, im)))
    for g, w in zip(got, _plain(re, im, layout)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(turn(g.numpy()), w)


def test_plain_refuses_a_wrong_shape_or_layout():
    cfg = reference.FFTConfig(**dict(C3, n=256))
    x = torch.zeros(256, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="samples a channel"):
        plain.channelize(x, x, cfg, "cn")
    plain.channelize(x, x, cfg, "nc")
    with pytest.raises(ValueError, match="bad layout"):
        plain.channelize(x, x, cfg, "bn")


def test_capture_on_cpu_raises():
    chz = Channelizer(PortConfig(**dict(C3, n=256)), device="cpu")
    x = torch.zeros(4, 256, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        chz.capture()(x, x)


@pytest.mark.parametrize("drop", ["retune", "to"])
@pytest.mark.parametrize("layout", plain.LAYOUTS)
def test_capture_is_dropped_with_the_plan(layout, drop):
    """A capture is tracked on the channelizer and on its plan: the plan's
    ``retune`` and the channelizer's ``.to()`` drop its graphs (a stand-in
    graph here)."""
    chz = Channelizer(PortConfig(**dict(C3, n=256)), layout=layout,
                      device="cpu")
    call = chz.capture()
    call._graphs["key"] = object()
    if drop == "retune":
        chz.plan.retune(chz.plan.tuning)
    else:
        chz.to("cpu")
    assert call._graphs == {}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _device_bank(layout, ch, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (ch, 4096) if layout == "cn" else (4096, ch)
    return tuple(torch.randint(-(1 << 15), 1 << 15, shape, generator=gen,
                               device=dev, dtype=torch.int32)
                 for _ in range(2))


def _rows(t, layout):
    return t if layout == "cn" else t.t()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", plain.LAYOUTS)
@pytest.mark.parametrize("ch", [512, 4096])
def test_capture_equals_eager_on_card(dev, layout, ch):
    """BASELINE config 3's transform on 4096 x ``ch`` int32 on the card:
    the captured call equals the eager one bit for bit, one pass launch a
    call; 64 of its channels equal the plain reference computed on the
    card; a second call on new inputs overwrites the static outputs."""
    chz = Channelizer(PortConfig(**C3), layout=layout, device=dev)
    call = chz.capture()
    for seed in (1, 2):
        x = _device_bank(layout, ch, seed, dev)
        eager = [y.clone() for y in chz(*x)]
        before = fused_pass.launches
        got = call(*x)
        torch.cuda.synchronize(dev)
        assert fused_pass.launches - before == (1 if seed == 2 else 2)
        for g, e in zip(got, eager):
            assert g.dtype == torch.int32 and torch.equal(g, e)
        picks = torch.arange(0, ch, ch // 64, device=dev)
        xs = [_rows(v, layout)[picks] for v in x]
        want = plain.channelize(*xs, reference.FFTConfig(**C3), "cn")
        for g, w in zip(got, want):
            assert torch.equal(_rows(g, layout)[picks].long(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", plain.LAYOUTS)
def test_capture_is_dropped_with_the_plan_on_card(dev, layout):
    """``retune`` of the plan and ``.to()`` drop the real graphs; the next
    call captures again and reads the same bits."""
    chz = Channelizer(PortConfig(**C3), layout=layout, device=dev)
    call = chz.capture()
    x = _device_bank(layout, 512, 3, dev)
    first = [y.clone() for y in call(*x)]
    assert len(call._graphs) == 1
    chz.plan.retune(chz.plan.tuning)
    assert call._graphs == {}
    assert all(torch.equal(a, b) for a, b in zip(call(*x), first))
    chz.to(dev)
    assert call._graphs == {}
    assert all(torch.equal(a, b) for a, b in zip(call(*x), first))


@pytest.mark.cuda
def test_capture_under_a_one_rank_mesh_on_card(dev, tmp_path):
    """A channelizer on a one-rank NCCL mesh captures as one without: its
    channels exchange nothing."""
    import torch.distributed as dist

    from intfftk_tpu_torch.parallel import initialize_multihost, make_mesh

    if dist.is_initialized():
        pytest.skip("a process group is up already")
    initialize_multihost(f"file://{tmp_path}/store", 1, 0)
    try:
        mesh = make_mesh()
        for layout in plain.LAYOUTS:
            chz = Channelizer(PortConfig(**C3), mesh, layout=layout)
            x = _device_bank(layout, 512, 4, dev)
            eager = [y.clone() for y in chz(*x)]
            got = chz.capture()(*x)
            assert all(torch.equal(g, e) for g, e in zip(got, eager))
    finally:
        dist.destroy_process_group()
