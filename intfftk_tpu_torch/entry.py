"""Entry points: the flagship step on one card, and a dry run of the
distributed layer in CPU processes.

Counterpart of ``__graft_entry__.py``:

* ``entry()`` (``:28-54``): the flagship forward step, the 1024-point
  scaled/round 16-bit transform of a [1024, 256] tile (256 channels) in one
  kernel launch, ``PallasFFTPlan(layout="nb")``, on the card unless the
  caller names the CPU;
* ``dryrun_multiprocess(n)`` (``dryrun_multichip``, ``:57-111``): n CPU
  processes joined over gloo build the ('ch', 'fft') mesh and run one
  sharded step (``FourStepPlan`` with the batch over 'ch' and the
  transform over 'fft', then the halo convolution on 'fft'), and check the
  bits against the golden models.  It runs on the CPU on purpose: it
  checks the process logic, as the JAX dry run does on virtual CPU
  devices.

``spawn_cpu`` starts such a group (a ``FileStore`` in a temporary
directory, so no port is opened) and ``run_cases`` is a worker that runs
a list of distributed cases and saves what rank 0 gathers, for checks that
compare the sharded plans with other implementations.

Run:  python -m intfftk_tpu_torch.entry [n_procs] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .config import FFTConfig
from .device import resolve
from .golden import make_conv_spec, overlap_save_int
from .golden.four_step import four_step_int
from .ops.single_pass import PallasFFTPlan
from .parallel import (Channelizer, FourStepPlan, OverlapSaveConv, gather,
                       initialize_multihost, make_mesh, pod_mesh, shard)


def entry(device: torch.device | str | None = None):
    """(plan, (x_re, x_im)): the flagship forward step and its example
    tile, int32 [1024, 256] on ``device`` (the card unless named)."""
    device = resolve(device)
    cfg = FFTConfig(n=1024, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    plan = PallasFFTPlan(cfg, layout="nb", device=device)
    rng = np.random.default_rng(0)
    x = [torch.as_tensor(rng.integers(-(1 << 14), 1 << 14, (1024, 256)),
                         dtype=torch.int32, device=device) for _ in range(2)]
    return plan, tuple(x)


def _gloo_main(rank, world, store, fn, args):
    torch.set_num_threads(1)
    initialize_multihost(f"file://{store}", world, rank, device="cpu")
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_cpu(fn, nprocs: int, *args, timeout: float = 300.0) -> None:
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` fresh CPU processes
    joined over gloo, and wait.  A rank that raises fails the whole run
    here (the others are ended); a run longer than ``timeout`` seconds is
    ended and raises TimeoutError."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _gloo_main, args=(nprocs, os.path.join(tmp, "store"), fn, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{nprocs} processes still running after "
                                   f"{timeout} s")


def _mesh(spec):
    """("make", shape, names) -> make_mesh; ("pod", ch, fft) -> pod_mesh;
    both on the CPU."""
    if spec[0] == "pod":
        return pod_mesh(*spec[1:], device="cpu")
    return make_mesh(spec[1], spec[2], device="cpu")


def _run_case(case: dict, mesh):
    """One case on this rank -> the global (re, im) and any extra results."""
    kind, x = case["kind"], case["x"]
    if kind == "four_step":
        plan = FourStepPlan(FFTConfig(**case["cfg"]), case["n1"], case["n2"],
                            mesh, axis=case.get("axis", "fft"),
                            inverse=case.get("inverse", False),
                            natural_out=case.get("natural_out", True),
                            batch_axis=case.get("batch_axis"),
                            kernel=case.get("kernel", "auto"), device="cpu")
        y = plan(*(plan.shard(v) for v in x))
        return [plan.gather(v) for v in y], {}
    if kind == "channelizer":
        axis = case.get("axis", "ch")
        ch = Channelizer(FFTConfig(**case["cfg"]),
                         inverse=case.get("inverse", False),
                         kernel=case.get("kernel", "auto"),
                         layout=case["layout"], mesh=mesh, axis=axis)
        y = ch(*(ch.shard(v) for v in x))
        extra = {}
        if "bad_lane_tile" in case:
            try:
                ch.stream(lane_tile=case["bad_lane_tile"])
                extra["stream_error"] = ""
            except ValueError as e:
                extra["stream_error"] = str(e)
        dim = 0 if case["layout"] == "cn" else -1
        return [gather(v, mesh, axis, dim) for v in y], extra
    if kind == "conv":
        axis = case.get("axis", "fft")
        conv = OverlapSaveConv(make_conv_spec(**case["spec"]), *case["h"],
                               kernel=case.get("kernel", "auto"), mesh=mesh,
                               axis=axis)
        y = conv(*(shard(v, mesh, axis, -1) for v in x))
        return [gather(v, mesh, axis, -1) for v in y], {}
    raise ValueError(f"bad case kind {kind!r}")


def run_cases(rank: int, world: int, cases: list, out_dir: str) -> None:
    """Worker of ``spawn_cpu``: run every case (a dict: ``kind`` one of
    "four_step", "channelizer", "conv"; ``mesh`` as ``_mesh``; ``x`` the
    global (re, im) input; the plan's arguments) on this rank, and on rank
    0 save the gathered result as ``out_dir/<name>.npz`` (``re``, ``im``
    and the case's extras)."""
    meshes = {}
    for case in cases:
        key = tuple(map(str, case["mesh"]))
        if key not in meshes:
            meshes[key] = _mesh(case["mesh"])
        (yr, yi), extra = _run_case(case, meshes[key])
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{case['name']}.npz"),
                     re=yr.numpy(), im=yi.numpy(), **extra)


def _dryrun_rank(rank: int, world: int) -> None:
    """One rank of the dry run (``__graft_entry__.py:73-108``)."""
    n_ch = 2 if world % 2 == 0 else 1
    n_fft = world // n_ch
    mesh = pod_mesh(n_ch, n_fft, device="cpu")
    n1 = n2 = 8
    while n1 % n_fft:
        n1, n2 = 2 * n1, 2 * n2
    cfg = FFTConfig(n=n1 * n2, mode="scaled", rounding="round",
                    data_width=12, twiddle_width=16)
    plan = FourStepPlan(cfg, n1, n2, mesh, axis="fft", batch_axis="ch",
                        device="cpu")
    rng = np.random.default_rng(1)
    xr, xi = (rng.integers(-1024, 1024, (2 * n_ch, cfg.n)) for _ in range(2))
    yr, yi = (plan.gather(v) for v in plan(plan.shard(xr), plan.shard(xi)))
    gr, gi = four_step_int(xr, xi, cfg, n1, n2)
    if not (np.array_equal(gr, yr.numpy()) and np.array_equal(gi, yi.numpy())):
        raise AssertionError("sharded four-step != golden four_step_int")

    # the halo convolution on 'fft' (each 'ch' row of the mesh on its own)
    spec = make_conv_spec(n=64, taps_len=9, data_width=10, taps_width=10)
    h = rng.integers(-128, 128, 9), np.zeros(9, np.int64)
    conv = OverlapSaveConv(spec, *h, mesh=mesh, axis="fft")
    t = spec.payload * n_fft
    x = [rng.integers(-128, 128, t) for _ in range(2)]
    y = [gather(v, mesh, "fft", -1) for v in conv(
        *(shard(v, mesh, "fft", -1) for v in x))]
    g = overlap_save_int(*x, *h, spec)
    if not all(np.array_equal(a, b.numpy()) for a, b in zip(g, y)):
        raise AssertionError("halo convolution != golden overlap_save_int")


def dryrun_multiprocess(n_procs: int, timeout: float = 300.0) -> None:
    """One sharded step over ``n_procs`` CPU processes (gloo); raises when
    a rank fails or the bits differ from the golden models."""
    spawn_cpu(_dryrun_rank, n_procs, timeout=timeout)
    n_ch = 2 if n_procs % 2 == 0 else 1
    print(f"dryrun_multiprocess({n_procs}): mesh ch={n_ch} x "
          f"fft={n_procs // n_ch} OK", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_procs", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None,
                    help='"cpu" for the plain version (default: the card)')
    a = ap.parse_args(argv)
    plan, x = entry(a.device)
    y = plan(*x)
    print("entry() ok:", [tuple(v.shape) for v in y], flush=True)
    dryrun_multiprocess(a.n_procs)


if __name__ == "__main__":
    main()
