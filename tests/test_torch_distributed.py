"""The port's distributed layer (intfftk_tpu_torch.parallel: mesh,
multihost, FourStepPlan) against the JAX FourStepPlan on the virtual CPU
mesh (its Pallas kernels in interpret mode) and against golden
four_step_int, exactly (tolerance 0), on the same numpy stimuli at the same
D.

The port runs SPMD in spawned CPU processes joined over gloo
(``entry.spawn_cpu``: a FileStore in a temporary directory, no port), once
per group size: every case of a group runs in one spawn
(``entry.run_cases``, which imports torch and the port, never jax) and
rank 0 saves the gathered result; the parametrised tests read the saved
results.  A rank that fails, or a spawn that outlasts its timeout, fails
the tests of that group."""

import dataclasses
import functools
import itertools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import cpu_mesh
from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden.stimulus import random_stimulus
from intfftk_tpu.parallel import FourStepPlan as JaxFourStepPlan
from intfftk_tpu_torch.config import FFTConfig as PortConfig
from intfftk_tpu_torch.convert import (config_from_jax,
                                       four_step_tables_from_jax)
from intfftk_tpu_torch.entry import dryrun_multiprocess, run_cases, spawn_cpu
from intfftk_tpu_torch.golden.four_step import four_step_int
from intfftk_tpu_torch.parallel import (CHANNEL_AXIS, FFT_AXIS,
                                        FourStepPasses, FourStepPlan,
                                        channel_sharding, gather,
                                        initialize_multihost, make_mesh,
                                        multihost, pod_mesh, replicated, shard)

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]
KERNELS = ["pallas", "xla"]
SPAWN_TIMEOUT = 240


def _case(name, cfg, n1, n2, x, mesh, **kw):
    return dict(name=name, kind="four_step", cfg=cfg, n1=n1, n2=n2, x=x,
                mesh=mesh, **kw)


def _cases(group):
    """The four-step cases of one group: "d2", "d4" (a 1-D 'fft' mesh of D
    ranks) or "2x2" (pod_mesh(2, 2), the batch over 'ch')."""
    if group == "2x2":
        cfg = dict(n=1024, mode="scaled", rounding="round", data_width=12)
        x = random_stimulus(1024, 12, seed=8, batch=(4,))
        return [_case(f"batch_axis-{'nat' if nat else 'mat'}-{kernel}", cfg,
                      32, 32, x, ("pod", 2, 2), batch_axis=CHANNEL_AXIS,
                      natural_out=nat, kernel=kernel)
                for nat, kernel in itertools.product((True, False), KERNELS)]
    mesh = ("make", (int(group[1:]),), (FFT_AXIS,))
    out = []
    for (mode, rnd), inverse, kernel in itertools.product(
            MODES, (False, True), KERNELS):
        cfg = dict(n=2048, mode=mode, rounding=rnd, data_width=12,
                   twiddle_width=16)
        out.append(_case(f"modes-{mode}-{rnd}-{'inv' if inverse else 'fwd'}-"
                         f"{kernel}", cfg, 32, 64,
                         random_stimulus(2048, 12, seed=3), mesh,
                         inverse=inverse, kernel=kernel))
    for inverse, kernel in itertools.product((False, True), KERNELS):
        out.append(_case(f"matrix-{'inv' if inverse else 'fwd'}-{kernel}",
                         dict(n=512, data_width=12), 16, 32,
                         random_stimulus(512, 12, seed=4), mesh,
                         inverse=inverse, natural_out=False, kernel=kernel))
    for kernel in KERNELS:
        out.append(_case(f"batched-{kernel}", dict(n=256, data_width=10), 16,
                         16, random_stimulus(256, 10, seed=5, batch=(3,)),
                         mesh, kernel=kernel))
    return out


GROUPS = {g: {c["name"]: c for c in _cases(g)} for g in ("d2", "d4", "2x2")}
PARAMS = [(g, name) for g, cases in GROUPS.items() for name in cases]


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """group -> the directory of its saved results (one spawn per group,
    on first use)."""
    done = {}

    def run(group):
        if group not in done:
            out = tmp_path_factory.mktemp(group)
            nprocs = 4 if group == "2x2" else int(group[1:])
            spawn_cpu(run_cases, nprocs, list(GROUPS[group].values()),
                      str(out), timeout=SPAWN_TIMEOUT)
            done[group] = out
        return done[group]
    return run


@functools.lru_cache(maxsize=None)
def _jax(group, name):
    """The JAX FourStepPlan on the conftest CPU mesh of the same shape, its
    default kernel (Pallas, interpret mode), the case's input."""
    c = GROUPS[group][name]
    if group == "2x2":
        mesh = cpu_mesh((2, 2), (CHANNEL_AXIS, FFT_AXIS))
    else:
        mesh = cpu_mesh((int(group[1:]),), (FFT_AXIS,))
    plan = JaxFourStepPlan(FFTConfig(**c["cfg"]), c["n1"], c["n2"], mesh,
                           inverse=c.get("inverse", False),
                           natural_out=c.get("natural_out", True),
                           batch_axis=c.get("batch_axis"))
    return tuple(np.asarray(v, np.int64) for v in plan(*c["x"]))


@pytest.mark.parametrize("group,name", PARAMS,
                         ids=[f"{g}-{n}" for g, n in PARAMS])
def test_four_step_plan(spmd, group, name):
    """The sharded port == the JAX plan at the same D == golden."""
    c = GROUPS[group][name]
    got = np.load(spmd(group) / f"{name}.npz")
    cfg = PortConfig(**c["cfg"])
    gr, gi = four_step_int(*c["x"], cfg, c["n1"], c["n2"],
                           inverse=c.get("inverse", False))
    if not c.get("natural_out", True):      # D[k1, k2]: X[k2*n1 + k1]
        shp = gr.shape[:-1] + (c["n2"], c["n1"])
        gr, gi = (g.reshape(shp).swapaxes(-1, -2) for g in (gr, gi))
    assert got["re"].dtype == np.int32 and got["re"].shape == gr.shape
    np.testing.assert_array_equal(got["re"], gr)
    np.testing.assert_array_equal(got["im"], gi)
    jr, ji = _jax(group, name)
    np.testing.assert_array_equal(got["re"], jr)
    np.testing.assert_array_equal(got["im"], ji)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_tables_from_jax(inverse, kernel, d):
    """convert.four_step_tables_from_jax of the JAX plan's consts == the
    port's own epilogue slice and factor tables, for every rank."""
    cfg = FFTConfig(n=2048, mode="scaled", rounding="round", data_width=12)
    jp = JaxFourStepPlan(cfg, 32, 64, cpu_mesh((d,), (FFT_AXIS,)),
                         inverse=inverse, kernel=kernel)
    consts = jax.tree_util.tree_map(np.asarray, jp.consts)
    for rank in range(d):
        own = FourStepPasses(config_from_jax(cfg), 32, 64, inverse,
                             kernel=kernel, rank=rank, size=d,
                             device="cpu").state_dict()
        got = four_step_tables_from_jax(consts, 32, 64, inverse, rank, d)
        assert set(got) == set(own)
        for k in own:
            assert torch.equal(got[k], own[k]), (k, rank)


def test_dryrun_multiprocess():
    """The dry run: 4 CPU processes, a 2 x 2 ('ch', 'fft') mesh, the
    four-step with the batch over 'ch' and the halo convolution, bits
    checked against golden in every rank."""
    dryrun_multiprocess(4, timeout=SPAWN_TIMEOUT)


# ------------------------------------------------ one process, world size 1

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A real gloo process group of one rank in this process."""
    store = tmp_path_factory.mktemp("store") / "s"
    initialize_multihost(f"file://{store}", 1, 0, device="cpu")
    yield
    dist.destroy_process_group()


def test_initialize_multihost_idempotent(world1, tmp_path):
    initialize_multihost(f"file://{tmp_path / 'other'}", 1, 0, device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"


def test_initialize_multihost_is_noop_when_up(monkeypatch):
    def fail(*a, **kw):
        raise AssertionError("init_process_group called again")

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "init_process_group", fail)
    multihost.initialize_multihost("localhost:1", 2, 0)


def _fake_world(monkeypatch, world):
    calls = []
    monkeypatch.setattr(dist, "get_world_size", lambda *a: world)
    monkeypatch.setattr(multihost, "make_mesh",
                        lambda shape, names, device=None: calls.append(
                            (shape, names)) or calls[-1])
    return calls


def test_pod_mesh_defaults(monkeypatch):
    _fake_world(monkeypatch, 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    # fft = the ranks of one host (innermost), ch = the hosts
    assert pod_mesh() == ((2, 4), (CHANNEL_AXIS, FFT_AXIS))


def test_pod_mesh_explicit(monkeypatch):
    _fake_world(monkeypatch, 8)
    assert pod_mesh(ch=4, fft=2) == ((4, 2), (CHANNEL_AXIS, FFT_AXIS))
    with pytest.raises(ValueError, match="world size 8"):
        pod_mesh(ch=3, fft=2)


def test_pod_mesh_real_group(world1):
    mesh = pod_mesh(device="cpu")
    assert mesh.mesh_dim_names == (CHANNEL_AXIS, FFT_AXIS)
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    assert channel_sharding(mesh, 2) == (
        torch.distributed.tensor.Shard(0),
        torch.distributed.tensor.Replicate())
    assert replicated(mesh) == (torch.distributed.tensor.Replicate(),) * 2
    with pytest.raises(ValueError):
        make_mesh((2,), (FFT_AXIS,), device="cpu")
    x = np.arange(12).reshape(3, 4)
    s = shard(x, mesh, FFT_AXIS, -1)
    assert torch.equal(s, torch.as_tensor(x))
    assert torch.equal(gather(s, mesh, CHANNEL_AXIS, 0), s)


@pytest.mark.parametrize("natural_out", [True, False])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_four_step_plan_one_rank(world1, mode, rounding, natural_out):
    """D = 1 in this process: no turn copies, the bits of golden."""
    cfg = PortConfig(n=1024, mode=mode, rounding=rounding, data_width=14)
    plan = FourStepPlan(cfg, 16, 64, make_mesh((1,), (FFT_AXIS,),
                                               device="cpu"),
                        natural_out=natural_out)
    x = random_stimulus(1024, 14, seed=9, batch=(2, 3))
    yr, yi = plan(*(plan.shard(v) for v in x))
    gr, gi = four_step_int(*x, cfg, 16, 64)
    if not natural_out:
        gr, gi = (g.reshape(2, 3, 64, 16).swapaxes(-1, -2) for g in (gr, gi))
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)


def test_four_step_checks(world1):
    cfg = PortConfig(n=1024)
    mesh = make_mesh((1,), (FFT_AXIS,), device="cpu")
    with pytest.raises(ValueError, match="cfg.n"):
        FourStepPlan(cfg, 16, 32, mesh)
    with pytest.raises(ValueError, match="powers of two"):
        FourStepPlan(cfg, 4, 256, mesh)
    with pytest.raises(ValueError, match="divide over 16"):
        FourStepPasses(PortConfig(n=64), 8, 8, size=16, device="cpu")
    with pytest.raises(NotImplementedError, match="int32"):
        FourStepPlan(dataclasses.replace(cfg, mode="unscaled",
                                         data_width=24), 32, 32, mesh)
    plan = FourStepPlan(cfg, 32, 32, mesh)
    with pytest.raises(ValueError, match="n/D"):
        plan(torch.zeros(4, 512), torch.zeros(4, 512))
