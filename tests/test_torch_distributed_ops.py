"""The port's Channelizer and OverlapSaveConv sharded over a device mesh
(the channels over 'ch'; the signal over 'fft' with the halo exchange)
against the JAX classes on the virtual CPU mesh of the same shape (Pallas
in interpret mode) and against golden fft_int / overlap_save_int, exactly
(tolerance 0), on the same numpy stimuli.

As in test_torch_distributed.py, the port runs SPMD in CPU processes
joined over gloo, one spawn per group size (``entry.run_cases``), and the
parametrised tests read what rank 0 saved."""

import functools
import itertools

import numpy as np
import pytest
import torch.distributed as dist

from conftest import cpu_mesh
from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden import fft_int, make_conv_spec, overlap_save_int
from intfftk_tpu.golden.stimulus import random_stimulus
from intfftk_tpu.parallel.channelizer import Channelizer as JaxChannelizer
from intfftk_tpu.parallel.convolve import OverlapSaveConv as JaxConv
from intfftk_tpu_torch.entry import run_cases, spawn_cpu
from intfftk_tpu_torch.golden import make_conv_spec as port_conv_spec
from intfftk_tpu_torch.parallel import (CHANNEL_AXIS, FFT_AXIS, Channelizer,
                                        OverlapSaveConv,
                                        initialize_multihost, make_mesh)

SPAWN_TIMEOUT = 240
CH_CFG = dict(n=256, mode="scaled", rounding="round")


def _taps(m, width, seed):
    rng = np.random.default_rng(seed)
    lim = 1 << (width - 2)
    return rng.integers(-lim, lim, m), rng.integers(-lim, lim, m)


def _cases(d):
    out = []
    ch_mesh = ("make", (d,), (CHANNEL_AXIS,))
    x = random_stimulus(256, 16, seed=7, batch=(16,))
    x[0][0] = -(1 << 15)                  # the full-scale round-mode pattern
    x[0][0, ::3] = (1 << 15) - 1
    for layout, inverse in itertools.product(("cn", "nc"), (False, True)):
        xs = x if layout == "cn" else tuple(v.T.copy() for v in x)
        out.append(dict(name=f"channelizer-{layout}-"
                        f"{'inv' if inverse else 'fwd'}", kind="channelizer",
                        cfg=CH_CFG, layout=layout, inverse=inverse,
                        mesh=ch_mesh, x=xs, bad_lane_tile=2 * d + 1))
    out.append(dict(name="channelizer-cn-fwd-xla", kind="channelizer",
                    cfg=CH_CFG, layout="cn", kernel="xla", mesh=ch_mesh, x=x))
    fft_mesh = ("make", (d,), (FFT_AXIS,))
    spec = dict(n=256, taps_len=33, data_width=12, taps_width=12)
    t = make_conv_spec(**spec).payload * 2 * d
    for kernel in ("pallas", "xla"):
        out.append(dict(name=f"conv-fused-{kernel}", kind="conv", spec=spec,
                        h=_taps(33, 12, 0), mesh=fft_mesh, kernel=kernel,
                        x=_taps(t, 12, 1)))
    spec = dict(n=256, taps_len=17, data_width=10, taps_width=10)
    t = make_conv_spec(**spec).payload * d
    rng = np.random.default_rng(3)
    out.append(dict(name="conv-batched", kind="conv", spec=spec,
                    h=_taps(17, 10, 2), mesh=fft_mesh,
                    x=tuple(rng.integers(-256, 256, (3, t))
                            for _ in range(2))))
    spec = dict(n=1 << 13, taps_len=1 << 10)
    t = make_conv_spec(**spec).payload * d
    out.append(dict(name="conv-four-step", kind="conv", spec=spec,
                    h=_taps(1 << 10, 16, 4), mesh=fft_mesh,
                    x=_taps(t, 16, 5)))
    return out


GROUPS = {d: {c["name"]: c for c in _cases(d)} for d in (2, 4)}
PARAMS = [(d, name) for d, cases in GROUPS.items() for name in cases]


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    done = {}

    def run(d):
        if d not in done:
            out = tmp_path_factory.mktemp(f"d{d}")
            spawn_cpu(run_cases, d, list(GROUPS[d].values()), str(out),
                      timeout=SPAWN_TIMEOUT)
            done[d] = out
        return done[d]
    return run


@functools.lru_cache(maxsize=None)
def _jax(d, name):
    """The JAX class on the CPU mesh of D devices, its default engine; the
    xla cases share the Pallas case's reference."""
    c = GROUPS[d][name]
    if c["kind"] == "channelizer":
        plan = JaxChannelizer(FFTConfig(**c["cfg"]),
                              cpu_mesh((d,), (CHANNEL_AXIS,)),
                              inverse=c.get("inverse", False),
                              layout=c["layout"])
        y = plan(*(plan.shard(v) for v in c["x"]))
    else:
        y = JaxConv(make_conv_spec(**c["spec"]), *c["h"],
                    mesh=cpu_mesh((d,), (FFT_AXIS,)))(*c["x"])
    return tuple(np.asarray(v, np.int64) for v in y)


def _golden(c):
    if c["kind"] == "conv":
        return overlap_save_int(*c["x"], *c["h"], make_conv_spec(**c["spec"]))
    cfg = FFTConfig(**c["cfg"])
    inverse = c.get("inverse", False)
    if c["layout"] == "cn":
        return fft_int(*c["x"], cfg, inverse=inverse)
    return tuple(g.T for g in fft_int(*(v.T for v in c["x"]), cfg,
                                      inverse=inverse))


@pytest.mark.parametrize("d,name", PARAMS, ids=[f"d{d}-{n}"
                                                for d, n in PARAMS])
def test_sharded_op(spmd, d, name):
    """The sharded port == the JAX class at the same D == golden."""
    c = GROUPS[d][name]
    got = np.load(spmd(d) / f"{name}.npz")
    gr, gi = _golden(c)
    assert got["re"].shape == gr.shape
    np.testing.assert_array_equal(got["re"], gr)
    np.testing.assert_array_equal(got["im"], gi)
    jr, ji = _jax(d, name.replace("fused-xla", "fused-pallas")
                  .removesuffix("-xla"))
    np.testing.assert_array_equal(got["re"], jr)
    np.testing.assert_array_equal(got["im"], ji)


@pytest.mark.parametrize("d", [2, 4])
def test_stream_lane_tile_divides(spmd, d):
    """stream() refuses a lane_tile that does not divide over the ranks of
    'ch', as the JAX channelizer does (:92-95)."""
    for name, c in GROUPS[d].items():
        if "bad_lane_tile" in c:
            msg = str(np.load(spmd(d) / f"{name}.npz")["stream_error"])
            assert msg == (f"lane_tile {c['bad_lane_tile']} must divide over "
                           f"{d} devices on axis 'ch'")


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    store = tmp_path_factory.mktemp("store") / "s"
    initialize_multihost(f"file://{store}", 1, 0, device="cpu")
    yield make_mesh((1,), (FFT_AXIS,), device="cpu")
    dist.destroy_process_group()


def test_conv_length_guard(world1):
    spec = port_conv_spec(n=256, taps_len=17)
    conv = OverlapSaveConv(spec, *_taps(17, 16, 0), mesh=world1)
    with pytest.raises(ValueError, match="payload\\*devices"):
        conv(np.zeros(1000), np.zeros(1000))
    with pytest.raises(ValueError, match="halo"):
        OverlapSaveConv(port_conv_spec(n=64, taps_len=41), *_taps(41, 16, 0),
                        mesh=world1)(np.zeros(24), np.zeros(24))


def test_one_rank_mesh_equals_no_mesh(world1):
    """On a mesh of one rank the channelizer and the convolution give the
    bits of their mesh-less runs."""
    from intfftk_tpu_torch.config import FFTConfig as PortConfig
    mesh = make_mesh((1,), (CHANNEL_AXIS,), device="cpu")
    x = random_stimulus(256, 16, seed=11, batch=(8,))
    for layout in ("cn", "nc"):
        xs = x if layout == "cn" else tuple(v.T.copy() for v in x)
        a = Channelizer(PortConfig(**CH_CFG), layout=layout, device="cpu")
        b = Channelizer(PortConfig(**CH_CFG), layout=layout, mesh=mesh)
        for u, v in zip(a(*(a.shard(v) for v in xs)),
                        b(*(b.shard(v) for v in xs))):
            np.testing.assert_array_equal(u.numpy(), v.numpy())
    spec = port_conv_spec(n=256, taps_len=33, data_width=12, taps_width=12)
    h, xs = _taps(33, 12, 0), _taps(spec.payload * 3, 12, 1)
    a = OverlapSaveConv(spec, *h, device="cpu")(*xs)
    b = OverlapSaveConv(spec, *h, mesh=world1)(*xs)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
