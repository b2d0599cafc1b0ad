"""The port's Channelizer (intfftk_tpu_torch.parallel) on one device
against the JAX Channelizer on the virtual 8-device CPU mesh (Pallas in
interpret mode) and golden fft_int, exactly: both layouts, both
directions, the kernel and the staged engine."""

import numpy as np
import pytest
import torch

from conftest import cpu_mesh
from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden import fft_int, random_stimulus
from intfftk_tpu.parallel.channelizer import Channelizer as JaxChannelizer
from intfftk_tpu.parallel.mesh import CHANNEL_AXIS
from intfftk_tpu_torch.convert import config_from_jax as P
from intfftk_tpu_torch.ops.fused_fft import fused_pass
from intfftk_tpu_torch.ops.single_pass import FusedAxisFFT, PallasFFTPlan
from intfftk_tpu_torch.ops.transform import FFTPlan
from intfftk_tpu_torch.parallel import Channelizer, local_plan, resolve_kernel

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


def _stimulus(ch, n, seed):
    """Random 16-bit channels; channel 0 is the full-scale pattern that
    drives the round-mode difference to +2^15."""
    re, im = random_stimulus(n, 16, seed=seed, batch=(ch,))
    re[0] = -(1 << 15)
    re[0, ::3] = (1 << 15) - 1
    return re, im


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("layout", ["cn", "nc"])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_channelizer_vs_jax(mode, rounding, layout, inverse):
    """256 channels x n = 128: the port == the JAX Channelizer sharded
    over 8 CPU devices == golden; the CPU runs the plain version."""
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
