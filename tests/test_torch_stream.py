"""The port's StreamExecutor (intfftk_tpu_torch.runtime) on the CPU: the
bursty-chunk protocol of tests/test_runtime.py against golden fft_int and
the JAX executor fed the same chunks, exactly.  On the CPU the executor
runs its dispatches synchronously through the same code; the CUDA-stream
form runs in chip_smoke.py and tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden import fft_int, random_stimulus
from intfftk_tpu.ops.pallas_fft import PallasFFTPlan as JaxPallasFFTPlan
from intfftk_tpu.runtime.stream import StreamExecutor as JaxStreamExecutor
from intfftk_tpu_torch.convert import config_from_jax as P
from intfftk_tpu_torch.ops.single_pass import PallasFFTPlan
from intfftk_tpu_torch.parallel import Channelizer
from intfftk_tpu_torch.runtime import StreamExecutor

STATS = {"repack_s", "dispatch_s", "wait_s", "dispatches", "samples_in"}


def _bursty(ex, re, im, seed, lo=1, hi=97):
    """Feed [total, n] transforms as [n, c] chunks of random sizes in
    [lo, hi); return the emitted blocks concatenated back to [total, n]."""
    rng = np.random.default_rng(seed)
    total, pos, got = re.shape[0], 0, []
    while pos < total:
        c = min(int(rng.integers(lo, hi)), total - pos)
        got += list(ex.feed(re[pos:pos + c].T, im[pos:pos + c].T))
        pos += c
    got += list(ex.flush())
    return (np.concatenate([g[0] for g in got], axis=1).T,
            np.concatenate([g[1] for g in got], axis=1).T)


def test_stream_bursty_chunks():
    """300 transforms in irregular bursts through PallasFFTPlan("nb"):
    the output equals the batch reference regardless of chunking, and
    equals the JAX executor fed the same chunks."""
    n, total = 64, 300
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    re, im = random_stimulus(n, 16, seed=1, batch=(total,))
    gr, gi = fft_int(re, im, cfg)
    ex = StreamExecutor(PallasFFTPlan(P(cfg), layout="nb", device="cpu"), n=n, lane_tile=128, device="cpu")
    out_r, out_i = _bursty(ex, re, im, seed=0)
    assert out_r.dtype == np.int32
    np.testing.assert_array_equal(out_r, gr)
    np.testing.assert_array_equal(out_i, gi)
    assert set(ex.stats) == STATS
    assert ex.stats["dispatches"] == 3                  # 2 full + the tail
    assert ex.stats["samples_in"] == n * total
    jex = JaxStreamExecutor(JaxPallasFFTPlan(cfg, layout="nb",
                                             interpret=True), n=n,
                            lane_tile=128)
    jr, ji = _bursty(jex, re, im, seed=0)
    np.testing.assert_array_equal(out_r, jr)
    np.testing.assert_array_equal(out_i, ji)


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("layout", ["cn", "nc"])
def test_stream_channelizer(layout, inverse, depth):
    """Channelizer.stream in both layouts and directions, depths 1, 2, 4:
    bursts of 1-96 channels, bit-exact, in order; reset_stats clears."""
    n, total = 128, 300
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    re, im = random_stimulus(n, 16, seed=2, batch=(total,))
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    ex = Channelizer(P(cfg), inverse=inverse, layout=layout, device="cpu").stream(
        lane_tile=64, depth=depth)
    out_r, out_i = _bursty(ex, re, im, seed=depth)
    np.testing.assert_array_equal(out_r, gr)
    np.testing.assert_array_equal(out_i, gi)
    assert ex.stats["dispatches"] == 5
    ex.reset_stats()
    assert ex.stats == dict.fromkeys(STATS, 0)


def test_channelizer_nc_layout():
    """layout="nc" batched and streamed (two uneven feeds then a flush)
    agree with golden; the flushed tail is the zero-padded tile, cut to
    its valid columns."""
    n, ch = 128, 256
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    c = Channelizer(P(cfg), layout="nc", device="cpu")
    re, im = random_stimulus(n, 16, seed=5, batch=(ch,))
    gr, gi = fft_int(re, im, cfg)
    yr, yi = c(c.shard(re.T), c.shard(im.T))
    np.testing.assert_array_equal(yr.numpy().T, gr)
    ex = c.stream(lane_tile=128)
    blocks = []
    for sl in (np.s_[0:100], np.s_[100:256]):
        blocks += list(ex.feed(re[sl].T, im[sl].T))
    blocks += list(ex.flush())
    assert [b[0].shape[1] for b in blocks] == [128, 128]
    out = np.concatenate([b[0] for b in blocks], axis=1).T
    np.testing.assert_array_equal(out, gr)


def test_stream_tiles_are_copies():
    """Every dispatched tile is the plan's own copy of the samples: the
    plan sees the right data even though the pack buffer is compacted and
    overwritten behind it, a one-transform chunk is taken as [n], a chunk
    larger than the buffer grows it, and the tail tile is zero-padded."""
    n, lane = 16, 8
    seen = []

    def plan(xr, xi):
        seen.append(xr.clone())
        return xr + 0, xi + 0                   # the identity transform

    ex = StreamExecutor(plan, n=n, lane_tile=lane, depth=2, device="cpu")
    rng = np.random.default_rng(6)
    data = rng.integers(-100, 100, (n, 90))
    chunks = [data[:, :1][:, 0], data[:, 1:5], data[:, 5:61], data[:, 61:90]]
    out = []
    for ch in chunks:
        out += list(ex.feed(ch, -ch))
    out += list(ex.flush())
    got = np.concatenate([o[0] for o in out], axis=1)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(np.concatenate([o[1] for o in out], 1),
                                  -data)
    tiles = torch.cat(seen, dim=1).numpy()
    np.testing.assert_array_equal(tiles[:, :90], data)
    assert not tiles[:, 90:].any()              # 6 zero transforms of pad


def test_stream_rejects():
    plan = PallasFFTPlan(P(FFTConfig(n=64)), device="cpu")
    ex = StreamExecutor(plan, n=64, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        list(ex.feed(np.zeros((32, 4)), np.zeros((32, 4))))
    with pytest.raises(ValueError):
        StreamExecutor(plan, n=64, lane_tile=0, device="cpu")
    with pytest.raises(ValueError):
        StreamExecutor(plan, n=64, depth=0, device="cpu")
