"""python -m bench_torch: the PyTorch/CUDA port's benchmark on one card.

    python -m bench_torch                 the headline cell, with the bit
                                          checks below 512K
    python -m bench_torch --all           every cell, then the reported
                                          lines (the streamed channelizer,
                                          2M and 4M; config 5 where the
                                          world or the visible cards are
                                          more than one)
    python -m bench_torch --cell NAME     one cell
    python -m bench_torch --verify        every bit-check family
    python -m bench_torch --config5       config 5, FourStepPlan over every
                                          rank (a world of one, or
                                          torchrun's, one card a rank)
    python -m bench_torch --weak          batch retention on one card; the
                                          channel weak scaling under
                                          torchrun with more than one rank
    python -m bench_torch --config5|--weak --cpu-mesh D
                                          either over D gloo CPU processes
                                          (virtual: harness validation, no
                                          rate claimed)
    python -m bench_torch --trace         a profiled run of the cells
                                          (separate from the timed run)
    python -m bench_torch --seed S        seeds every stimulus (default:
                                          the seed bench.py uses for it)
    python -m bench_torch --smoke         every cell at a tiny size on the
                                          CPU, plain versions: bits and
                                          counts, no time

One JSON line per cell on stdout (progress on stderr; over several ranks
rank 0 prints).  Every line but the smoke's and the CPU mesh's carries the
card's name and power limit, torch's CUDA and nvcc's version.  A cell
reads its ``msamples_per_sec`` from 40 individually timed readings, each
one replay of one CUDA graph of the cell's chained calls: every sample
of every reading over the device time of the whole window, with the
rates at the median and the p75 reading and their count beside it.  Then its output
on its input, as a CUDA graph of one call replays it and as an eager call
gives it, is held to the golden model.  Exits non-zero when any cell or
family is not correct, or config 5's bits are not golden's.  Without
``--smoke`` or ``--cpu-mesh`` it needs a card: with no CUDA it raises
RuntimeError.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import cells, sharded, timing, verify

ROOT = Path(__file__).resolve().parent.parent
HEADLINE = "fft64k_int16_b64"
HEADLINE_METRIC = "fft64k_int16_msamples_per_sec_per_chip"


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def git_rev():
    """Short revision of the tree (with "-dirty" when it has changes), or
    None where it is not a git repository."""
    try:
        rev = subprocess.run(["git", "-C", str(ROOT), "rev-parse", "--short",
                              "HEAD"], capture_output=True, text=True,
                             timeout=10)
        if rev.returncode:
            return None
        dirty = subprocess.run(["git", "-C", str(ROOT), "status",
                                "--porcelain"], capture_output=True,
                               text=True, timeout=10).stdout
    except OSError:
        return None
    return rev.stdout.strip() + ("-dirty" if dirty.strip() else "")


def environment() -> dict:
    """The card's name and power limit as nvidia-smi gives them, torch's
    CUDA version and nvcc's."""
    from intfftk_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout
    return {"card": card.strip().splitlines()[0],
            "cuda": torch.version.cuda,
            "nvcc": nvcc.strip().splitlines()[-1],
            "torch": torch.__version__}


def counters():
    """The port's launch counters, by kernel."""
    from intfftk_tpu_torch.ops.fused_fft import fused_pass, fused_whole
    from intfftk_tpu_torch.ops.intmath import spectrum_product
    from intfftk_tpu_torch.ops.twiddle_synth import device_circle_table

    return {"fused_pass": fused_pass, "fused_whole": fused_whole,
            "spectrum_product": spectrum_product,
            "circle_table": device_circle_table}


def launches(run) -> dict:
    """Launches of each kernel in one call of ``run.fn`` on its input."""
    before = {k: c.launches for k, c in counters().items()}
    run.fn(*run.x)
    if run.x[0].is_cuda:
        torch.cuda.synchronize()
    return {k: c.launches - before[k] for k, c in counters().items()
            if c.launches != before[k]}


def measure(run, count: int = timing.READINGS) -> dict:
    """The timed readings of a built cell, its per-layer numbers, and its
    check: the output of the call as a CUDA graph replays it (where the
    cell is read captured) and of an eager call, each against golden."""
    reads = timing.readings(run.fn, *run.x, calls=run.chain, count=count,
                            capture=run.capture)
    eager = timing.event_ms(run.fn, *run.x, calls=run.chain)
    host = timing.paced(run.fn, *run.x, calls=run.chain)[1]
    bound_ms, by = run.work.bound()
    rate = reads.rate(run.samples)
    checked = cells.check(run, *(
        [timing.replayed(run.call, *run.x)] if run.capture else []),
        run.call(*run.x))
    return {"msamples_per_sec": rate, "value": rate,
            "msamples_per_sec_readings": reads.rates(run.samples),
            "timed": "captured" if run.capture else "eager",
            "timed_ms": reads.summary(),
            "captured_ms": reads.summary() if run.capture else None,
            "device_ms_eager": eager, "host_issue_ms": host,
            "launches_per_call": launches(run),
            "samples_per_call": run.samples, "bytes_per_call": run.work.bytes,
            "ops_per_call": run.work.ops, "bound_ms": bound_ms,
            "bound_by": by, "bound_share": bound_ms / reads.window,
            **checked}


def per_mode(name, dev, seed, count: int) -> dict:
    """A large-n cell's readings in every ``epi_synth`` mode, and the
    generator's ms to build one table of its plan."""
    from intfftk_tpu_torch.ops.twiddle_synth import (coarse_table,
                                                     device_circle_table)

    out = {}
    for mode in cells.EPI_MODES:
        run = cells.build(name, dev, seed, epi_synth=mode)
        out[mode] = timing.readings(run.fn, *run.x, calls=run.chain,
                                    count=count).summary()
        plan = run.plans[0]
        del run
    cfg = plan.cfg
    co = coarse_table(cfg, dev)
    gen = timing.event_ms(lambda u, v: device_circle_table(
        cfg, cfg.n, plan.n1, plan.n2, False, coarse=co), None, None,
        calls=20)
    return {"epi_synth_ms": out, "generator_ms": gen}


def run_cell(name, dev, env, seed=None, count: int = timing.READINGS,
             modes: bool = True) -> dict:
    """Build, time and check one cell: its JSON line."""
    t0 = time.perf_counter()
    spec = cells.CELLS[name]
    run = cells.build(name, dev, seed)
    line = {"cell": name, "metric": "msamples_per_sec", **measure(run, count),
            "regression_bound": spec.regression_bound}
    if name == HEADLINE:
        plan = run.plans[0]
        xf = [v.reshape(v.shape[0], -1) for v in run.x]
        line["value_flat_contract"] = timing.readings(
            plan, *xf, calls=run.chain, count=count).rate(run.samples)
        snr = cells.headline_snr(plan, dev, 11 if seed is None else seed)
        ok = snr.pop("correct")
        line.update(snr)
        line["correct"] &= ok
    del run
    if spec.per_mode and modes:
        line.update(per_mode(name, dev, seed, count))
    line.update(env)
    line["seconds"] = time.perf_counter() - t0
    return line


def streamed(dev, env, seed=None) -> list[dict]:
    """The channelizer fed from host chunks (``bench_config3``'s streamed
    rate): host wall time, split into repack, dispatch and wait; a reported
    line per layout, not a cell."""
    lines = []
    for layout in ("cn", "nc"):
        run = cells.build(f"c3_channelizer_{layout}", dev, seed)
        chz = run.plans[0]
        want = run.output()
        xr, xi = run.stimulus
        if layout == "cn":
            xr, xi = xr.T, xi.T
        hr, hi = (np.ascontiguousarray(v, np.int32) for v in (xr, xi))
        ex = chz.stream(lane_tile=512, depth=4)
        for _ in ex.feed(hr[:, :512], hi[:, :512]):   # warm the path
            pass
        for _ in ex.flush():
            pass
        ex.reset_stats()
        rng = np.random.default_rng(3 if seed is None else seed)
        outs, pos, total = [], 0, hr.shape[1]
        t0 = time.perf_counter()
        while pos < total:
            c = min(int(rng.integers(64, 256)), total - pos)
            outs += list(ex.feed(hr[:, pos:pos + c], hi[:, pos:pos + c]))
            pos += c
        outs += list(ex.flush())
        wall = time.perf_counter() - t0
        got = [np.concatenate([o[k] for o in outs], axis=1) for k in (0, 1)]
        if layout == "cn":
            got = [v.T for v in got]
        st = ex.stats
        lines.append({
            "line": f"c3_channelizer_{layout}_streamed",
            "host_wall_msamples_per_sec": run.samples / wall / 1e6,
            "wall_ms": wall * 1e3, "repack_ms": st["repack_s"] * 1e3,
            "dispatch_ms": st["dispatch_s"] * 1e3,
            "wait_ms": st["wait_s"] * 1e3, "dispatches": st["dispatches"],
            "correct": all(np.array_equal(a, b) for a, b in zip(got, want)),
            **env})
    return lines


def reported(dev, env, seed=None, count: int = timing.READINGS):
    """The 2M and 4M lines: timed and checked as a cell, not cells."""
    for name in cells.REPORTED:
        run = cells.build(name, dev, seed)
        yield {"line": name, **measure(run, count), **env}


def weak(dev, env, seed=None, count: int = timing.READINGS) -> dict:
    """Batch retention on one card (``bench_weak``'s one-chip branch): the
    headline at batch 8, 16, 32 and 64, each rate over the smallest
    batch's."""
    rates = {}
    for b in (8, 16, 32, 64):
        run = cells.headline(dev, 0 if seed is None else seed, batch=b)
        rates[b] = timing.readings(run.fn, *run.x, calls=max(50, 3200 // b),
                                   count=count).rate(run.samples)
    return {**sharded.weak_line("batch_retention",
                                {b: r / rates[8] for b, r in rates.items()}),
            "msamples_per_sec": {str(b): r for b, r in rates.items()}, **env}


def trace(run, calls: int = 10) -> dict:
    """A profiled run of ``calls`` eager calls (``torch.profiler``): the
    device time by kernel name, largest first, and the longest idle gaps
    between device activities; "not measured" where the profiler saw no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    a, b = run.x
    # the first window warms the path and the profiler up; the second is
    # the one read (its events are handed over when it ends)
    events = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        for _ in range(2):
            for _ in range(calls):
                a, b = run.fn(a, b)
            torch.cuda.synchronize()
            prof.step()
    spans, by_name = [], {}
    for e in events:
        # device activity only: kernels and copies, not the profiler's own
        # step annotation, which spans the window
        if (getattr(e, "device_type", None) != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name.startswith("ProfilerStep")):
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t1 - t0) / 1e3, n + 1)
    if not spans:
        return {"trace": "not measured"}
    spans.sort()
    gaps, busy, end = [], 0.0, spans[0][0]
    for t0, t1 in spans:
        if t0 > end:
            gaps.append((t0 - end) / 1e3)
        busy += max(0.0, t1 - max(t0, end)) / 1e3
        end = max(end, t1)
    span = (end - spans[0][0]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"trace_calls": calls, "device_span_ms": span, "busy_ms": busy,
            "idle_share": 1 - busy / span if span else 0.0,
            "top_kernels": [{"name": k[:120], "device_ms": ms, "launches": n}
                            for k, (ms, n) in top],
            "longest_idle_gaps_ms": sorted(gaps, reverse=True)[:5]}


def smoke(seed=None) -> int:
    """Every cell at its tiny size and the bit checks below 512K on the
    CPU, through the plain versions: bits and counts, no time."""
    ok = True
    for name in cells.CELLS:
        run = cells.build(name, "cpu", seed, tiny=True)
        line = {"cell": name, "device": "cpu", **cells.check(run),
                "samples_per_call": run.samples,
                "bytes_per_call": run.work.bytes,
                "ops_per_call": run.work.ops}
        ok &= line["correct"]
        print(json.dumps(line), flush=True)
    ver = verify.verify("cpu", large=False, seed=seed, log=verify.log_stderr)
    ok &= all(v for _, v in ver)
    print(json.dumps({"smoke": True, "device": "cpu", "correct": bool(ok),
                      "verified": {k: v for k, v in ver}}), flush=True)
    return 0 if ok else 1


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m bench_torch",
                                description=__doc__.split("\n\n")[0])
    what = p.add_mutually_exclusive_group()
    what.add_argument("--all", action="store_true", help="every cell")
    what.add_argument("--cell", choices=list(cells.CELLS), help="one cell")
    what.add_argument("--verify", action="store_true",
                      help="every bit-check family")
    what.add_argument("--config5", action="store_true",
                      help="config 5 over every rank")
    what.add_argument("--weak", action="store_true",
                      help="batch retention on one card; the channel weak "
                           "scaling over several ranks")
    what.add_argument("--smoke", action="store_true",
                      help="tiny, on the CPU: bits and counts only")
    p.add_argument("--trace", action="store_true",
                   help="a profiled run of the selected cells, untimed")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of every stimulus")
    p.add_argument("--cpu-mesh", type=int, metavar="D",
                   help="--config5 or --weak over D gloo CPU processes")
    args = p.parse_args(argv)
    if args.cpu_mesh is not None and not (args.config5 or args.weak):
        p.error("--cpu-mesh D takes --config5 or --weak")
    return args


def distributed(what: str, env: dict | None) -> dict | None:
    """Config 5 ("config5") or the channel weak scaling ("weak") over the
    joined process group (``sharded.process_group``): rank 0's line with
    ``env``, None on the other ranks."""
    with sharded.process_group():
        line = sharded.LINES[what]()
    return None if line is None else {**line, **env}


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    emit = lambda line: print(json.dumps(line), flush=True)
    if args.smoke:
        return smoke(args.seed)
    if args.cpu_mesh is not None:
        line = sharded.cpu_mesh(args.cpu_mesh,
                                "config5" if args.config5 else "weak")
        emit(line)
        return 0 if line.get("bits_ok", True) else 1
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark times the card; "
                           "python -m bench_torch --smoke checks bits and "
                           "counts on the CPU")
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1 and not (args.config5 or args.weak or args.all):
        raise SystemExit("over several ranks bench_torch runs --config5, "
                         "--weak or --all")
    if world > 1:
        # one card a rank: set before anything builds on the current device
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    rank0 = int(os.environ.get("RANK", 0)) == 0
    dev = torch.device("cuda", torch.cuda.current_device())
    env = environment()
    if rank0:
        _log(f"bench_torch on {env['card']}, CUDA {env['cuda']}, "
             f"{env['nvcc']}")
    if args.config5 or args.weak and world > 1:
        line = distributed("config5" if args.config5 else "weak", env)
        if line is not None:
            emit(line)
        return 0 if line is None or line.get("bits_ok", True) else 1
    if args.verify:
        ver = verify.verify(dev, large=True, seed=args.seed,
                            log=verify.log_stderr)
        ok = all(v for _, v in ver)
        emit({"metric": "verified_bits", "value": int(ok),
              "families": len(ver), "verified": dict(ver),
              "git_rev": git_rev(), **env})
        return 0 if ok else 1
    if args.weak:
        emit(weak(dev, env, args.seed))
        return 0
    names = (list(cells.CELLS) if args.all or args.trace and not args.cell
             else [args.cell or HEADLINE])
    if not rank0:
        # the cells are rank 0's; the other ranks join config 5 alone
        names = []
    if args.trace:
        for name in names:
            emit({"cell": name, **trace(cells.build(name, dev, args.seed)),
                  **env})
        return 0
    ok = True
    for name in names:
        _log(f"cell {name}")
        line = run_cell(name, dev, env, args.seed)
        if name == HEADLINE:
            ver = verify.verify(dev, large=False, seed=args.seed,
                                log=verify.log_stderr)
            line.update(metric=HEADLINE_METRIC,
                        verified_bits=all(v for _, v in ver),
                        verified=dict(ver), git_rev=git_rev())
            ok &= line["verified_bits"]
        ok &= line["correct"]
        emit(line)
        torch.cuda.empty_cache()
    if args.all and rank0:
        for line in [*streamed(dev, env, args.seed),
                     *reported(dev, env, args.seed)]:
            ok &= line["correct"]
            emit(line)
    if args.all and max(world, torch.cuda.device_count()) > 1:
        line = distributed("config5", env)
        if line is not None:
            ok &= line["bits_ok"]
            emit(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
