"""The benchmark's lines over several ranks: config 5 and the channel weak
scaling, each over NCCL (one card a rank) or over gloo CPU processes.

Counterparts of ``bench.py``'s ``bench_config5`` (:900-962), the channel
branch of ``bench_weak`` (:982-1002, its metric name at :1124-1147) and
``--cpu-mesh`` (:1037-1050):

* ``config5``: ``FourStepPlan`` over the whole world's "fft" axis, n =
  2^20 (1024 x 1024, square factors so the timed calls chain output to
  input), scaled/round, 16-bit data and twiddles, batch 2.  Bits before
  speed: ``random_stimulus(n, 15, seed=31, batch=(1,))`` through the plan
  is held ``array_equal`` to ``golden.four_step.four_step_int``
  (``bits_ok``).  On the card the calls are eager between CUDA events
  (``timing.readings(capture=False)``: NCCL is not captured);
* ``weak_channel``: ``Channelizer(FFTConfig(n=1024, mode="scaled",
  rounding="round"), mesh)`` with 512 channels a rank on the first d ranks,
  for every d that divides the world size; efficiency = rate(d) / (d x
  rate(1)), under the metric ``weak_scaling_efficiency``;
* ``cpu_mesh(d, what)``: either over d gloo CPU processes
  (``intfftk_tpu_torch.entry.spawn_cpu``), timed by the host's clock
  between barriers, config 5 at n = 2^18; the line is flagged virtual: it
  validates the harness and claims no rate.

``weak_line`` names the weak metric by its quantity: batch retention on
one card, weak scaling efficiency across ranks; two artifacts never share
a name for different quantities.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from intfftk_tpu_torch.config import FFTConfig
from intfftk_tpu_torch.golden import random_stimulus
from intfftk_tpu_torch.golden.four_step import four_step_int
from intfftk_tpu_torch.parallel import (Channelizer, FourStepPlan,
                                        initialize_multihost, make_mesh)

from . import timing

#: config 5's size on cards and on gloo processes (``bench.py:923``), and
#: its batch
CONFIG5_N, CONFIG5_N_VIRTUAL, CONFIG5_BATCH = 1 << 20, 1 << 18, 2
#: the channel weak scaling's transform and channels per rank
WEAK_N, WEAK_PER_RANK = 1024, 512
#: the timed stimulus: 15-bit values, as ``bench.py``'s ``_devdata``
LIM = 1 << 14
#: calls per reading on the card, and per host-timed window on gloo
CALLS, CALLS_VIRTUAL = 20, 3
NOTE_C5_VIRTUAL = ("gloo processes sharing one host's cores: code-path and "
                   "harness validation only; the rate is host-core bound, "
                   "the shape reduced")
NOTE_WEAK_VIRTUAL = ("shared-core virtual mesh: efficiency bounded by host "
                     "cores, not communication; harness/code-path "
                     "validation only")
NOTE_RETENTION = ("one card: throughput retention across batch sizes, not "
                  "scaling across cards")


def weak_line(mode: str, eff: dict, virtual: bool = False) -> dict:
    """The weak-scaling line of points {d or batch: efficiency}: metric
    ``weak_scaling_efficiency`` for ``mode`` "channel" (across ranks),
    ``batch_retention`` for "batch_retention" (one card across batch
    sizes); the smallest point is the value.  ``virtual``: gloo processes
    on one host (``virtual_devices`` and its note)."""
    if mode not in ("channel", "batch_retention"):
        raise ValueError(f"bad weak mode {mode!r}")
    out = {"metric": ("weak_scaling_efficiency" if mode == "channel"
                      else "batch_retention"),
           "value": min(eff.values()), "unit": "fraction", "mode": mode,
           "points": {str(k): v for k, v in eff.items()}}
    if mode == "batch_retention":
        out["note"] = NOTE_RETENTION
    if virtual:
        out["virtual_devices"] = True
        out["note"] = NOTE_WEAK_VIRTUAL
    return out


def _on_gloo() -> bool:
    return dist.get_backend() == "gloo"


def _device() -> torch.device:
    return (torch.device("cpu") if _on_gloo()
            else torch.device("cuda", torch.cuda.current_device()))


def _wall_ms(run, calls: int) -> float:
    """Host ms per call of ``calls`` calls of ``run`` (None: this rank
    only waits), between two barriers of the world."""
    dist.barrier()
    t0 = time.perf_counter()
    if run is not None:
        for _ in range(calls):
            run()
    dist.barrier()
    return (time.perf_counter() - t0) * 1e3 / calls


def config5(n: int | None = None, batch: int = CONFIG5_BATCH,
            calls: int | None = None, count: int = timing.READINGS,
            seed: int = 0) -> dict | None:
    """Config 5 over every rank of the joined group (each rank calls it):
    the line on rank 0, None on the others.  ``n``: 2^20 over NCCL, 2^18
    over gloo unless named."""
    gloo, world = _on_gloo(), dist.get_world_size()
    n = n or (CONFIG5_N_VIRTUAL if gloo else CONFIG5_N)
    calls = calls or (CALLS_VIRTUAL if gloo else CALLS)
    cfg = FFTConfig(n=n, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    l2 = cfg.stages // 2
    n2, n1 = 1 << l2, n >> l2
    if n1 != n2:
        raise ValueError(f"config 5 chains output to input: n = {n} has no "
                         f"square factors")
    dev = _device()
    fsp = FourStepPlan(cfg, n1, n2, make_mesh((world,), ("fft",),
                                              device=dev.type))
    # bits before speed: the full mesh path against the golden model
    re, im = random_stimulus(n, 15, seed=31, batch=(1,))
    y = [fsp.gather(v).cpu().numpy() for v in fsp(fsp.shard(re),
                                                    fsp.shard(im))]
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    if dist.get_rank() == 0:
        g = four_step_int(re, im, cfg, n1, n2)
        ok[0] = all(np.array_equal(a, b) for a, b in zip(g, y))
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    rng = np.random.default_rng(seed)
    x = [fsp.shard(rng.integers(-LIM, LIM, (batch, n),
                                dtype=np.int32)) for _ in range(2)]
    if gloo:
        state = list(fsp(*x))
        ms = _wall_ms(lambda: state.__setitem__(slice(None), fsp(*state)),
                      calls)
        timed = {"timed": "host wall clock between barriers",
                 "ms_per_call": ms}
    else:
        reads = timing.readings(fsp, *x, calls=calls, count=count,
                                capture=False)
        ms = reads.window
        timed = {"timed": "eager", "timed_ms": reads.summary(),
                 "msamples_per_sec_readings": reads.rates(batch * n)}
    if dist.get_rank():
        return None
    out = {"line": "c5_four_step", "metric": "msamples_per_sec",
           "msamples_per_sec": batch * n / ms / 1e3, "n": n,
           "devices": world, "batch": batch, "bits_ok": bool(ok.item()),
           "kernel": fsp.kernel, **timed}
    if gloo:
        out.update(virtual=True, note=NOTE_C5_VIRTUAL)
    return out


def weak_channel(n: int = WEAK_N, per_rank: int = WEAK_PER_RANK,
                 calls: int | None = None, seed: int = 0) -> dict | None:
    """The channel weak scaling over every rank of the joined group (each
    rank calls it): for every d dividing the world size, a Channelizer on a
    mesh of the first d ranks, ``per_rank`` channels each, chained
    ``calls`` times; the line on rank 0, None on the others.  Over NCCL a
    point's ms per call is the slowest rank's, by CUDA events."""
    gloo, world, rank = _on_gloo(), dist.get_world_size(), dist.get_rank()
    calls = calls or (CALLS_VIRTUAL if gloo else CALLS)
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    dev = _device()
    rates, eff = {}, {}
    for d in (d for d in range(1, world + 1) if world % d == 0):
        # every rank joins the mesh's groups; the first d ranks run on it
        mesh = DeviceMesh(dev.type, list(range(d)), mesh_dim_names=("ch",))
        run = None
        if rank < d:
            ch = Channelizer(cfg, mesh)
            rng = np.random.default_rng(seed)
            state = [ch.shard(rng.integers(-LIM, LIM,
                                           (per_rank * d, n), dtype=np.int32))
                     for _ in range(2)]
            state[:] = ch(*state)                       # warm-up
            run = lambda: state.__setitem__(slice(None), ch(*state))
        if gloo:
            ms = _wall_ms(run, calls)
        else:
            t = torch.zeros(1, dtype=torch.float64, device=dev)
            if run is not None:
                t[0] = timing.readings(ch, *state, calls=calls,
                                       capture=False).window
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            ms = t.item()
        rates[d] = per_rank * d * n / ms / 1e3
        eff[d] = rates[d] / (d * rates[1])
    if rank:
        return None
    return {**weak_line("channel", eff, virtual=gloo),
            "msamples_per_sec": {str(d): r for d, r in rates.items()},
            "devices": world, "n": n, "channels_per_rank": per_rank}


@contextlib.contextmanager
def process_group():
    """The joined process group: as it is where one is up; under a launcher
    that sets ``WORLD_SIZE`` (torchrun) the world it names, one card a rank
    over NCCL; else a world of one over a ``FileStore`` in a temporary
    directory (no port).  A group joined here is left at the end."""
    if dist.is_initialized():
        yield
        return
    tmp = None
    if "WORLD_SIZE" in os.environ:
        initialize_multihost()
    else:
        tmp = tempfile.mkdtemp()
        initialize_multihost(f"file://{tmp}/store", 1, 0)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


#: what ``cpu_mesh`` runs, by name
LINES = {"config5": config5, "weak": weak_channel}


def _cpu_rank(rank: int, world: int, what: str, out: str, kw: dict):
    line = LINES[what](**kw)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(line, f)


def cpu_mesh(d: int, what: str, timeout: float = 600.0, **kw) -> dict:
    """``LINES[what]`` over ``d`` gloo CPU processes (``spawn_cpu``;
    ``timeout`` seconds at most), with ``kw`` (a smaller ``n`` for a test):
    rank 0's line, with the torch version."""
    from intfftk_tpu_torch.entry import spawn_cpu

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "line.json")
        spawn_cpu(_cpu_rank, d, what, out, kw, timeout=timeout)
        with open(out) as f:
            line = json.load(f)
    return {**line, "device": "cpu", "torch": torch.__version__}
