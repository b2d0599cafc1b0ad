"""On-card sweep of the factor pass's launch geometry, and the choice of
the ``"sm_90"`` row of ``ops/tuning.py``.

Counterpart of ``tools/sweep_tuning.py``, which swept the TPU's lane tile
and batch block.  Here the knobs of a row are the ones a pass launches
with: threads per CTA (``THREADS``; a template parameter of the kernel,
so every count the library lacks is a library of its own,
``_build.library(threads)``), fixed or given by the tasks of a stage group
each thread takes (``TASKS_PER_THREAD``), the most columns per CTA on the
int32 and the int64 tile (``LANE_TILES``), and the shared memory one CTA
may take (``CTAS_PER_SM``: the budgets that let an SM hold 1, 2, 3 or 4
CTAs of the tallest tiles).  Each candidate row gives each pass of a path
a geometry (TC, threads: ``tuning.pass_geometry``); many rows give a path
the same geometry, and each distinct one is timed once per round.

The paths are the card-bound ones, at full size: the channelizer 4096 x
4096 (``cn`` and ``nc``, both directions), the 1M block chain (``device``
twiddles), 512K flat, 16M (both directions), K5 ``[4096, 1024]`` int64,
config 4 at T = 64 payloads and the monolithic schedule's 2-D stage pass
(64k at batch 64, 512K at batch 2).  The
64k headline is printed too and left out of the choice.  Every
``LargeFFTPlan`` here is built with ``fuse="split"``, so that the rows time
the pass they tune whatever a row's ``whole_max_n`` says, as the JAX sweep
asserts its plans split (``tools/sweep_tuning.py:79``); the candidate rows
keep ``whole_max_n`` at 0, so config 4's own plans split too.  A path whose
host needs at least ``HOST_PACED`` of the card's time to issue a call (read
as ``bench_torch.timing.paced`` does, at today's geometry) cannot judge
geometry: it is timed and printed, marked host-paced, and does not take
part.

What it does, in one process on one card:

1. builds the variants of the thread counts the library lacks, side by
   side, and prints what each form of the pass takes at each thread count
   (registers, spills: ``intfft_pass_attributes``);
2. per path, checks every geometry bit-equal to the plain version on the
   same input, then times them in turns: ``ROUNDS`` rounds, the order
   reversed every other round, today's geometry (``DEFAULT_TUNING``) at
   the start and end of each; device ms from CUDA events over chained
   calls after warm-up, as ``bench_torch.timing.event_ms``, a geometry's
   time the least of its readings (a hiccup of the host only adds time);
3. prints one table per path: geometry, ms, time / bound (the bound of
   ``utils/roofline``, against the ceilings measured in this process),
   registers, CTAs per SM, spills;
4. chooses the row: among the rows no deciding path of which runs slower
   than today's geometry by more than that path's spread and whose passes
   spill no more than today's, the one with the least geometric mean of
   time / today's over the deciding paths; it replaces today's values only
   where that mean is below 1 - spread.  A path's spread is the larger of
   2 % and (max - min) / min of today's readings on it in this run; the
   run's spread the median of the deciding paths' (one path's host hiccup
   does not set the bar for all).  Otherwise today's values stay,
   measured.

Usage, on a machine with the card (about two minutes with the builds):

    python -m intfftk_tpu_torch.tools.sweep_tuning [--rounds N]
        [--out sweep_tuning.json]
    python -m intfftk_tpu_torch.tools.sweep_tuning --dry   # no card: the
        grid and the distinct geometries of each path, on the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import FFTConfig
from ..ops import _build
from ..ops.fused_fft import (LargeFFTPlan, circle_table, fused_pass,
                             fused_pass_reference, modular, product_form)
from ..ops.intmath import spectrum_product_reference
from ..ops.single_pass import (FusedAxisFFT, PallasFFTPlan,
                               PallasWideFFTPlan)
from ..ops.transform import pack_tables
from ..ops.tuning import (DEFAULT_TUNING, KernelTuning, pick_lane_tile,
                          smem_budget)
from ..ops.twiddle_synth import EpiSynth, coarse_table
from ..utils.roofline import (OPS_PER_SAMPLE_STAGE, KernelCost, fft_cost,
                              large_fft_cost)

THREADS = (128, 256, 512, 1024)
TASKS_PER_THREAD = (0, 1, 2, 4)
LANE_TILES = (2, 4, 8, 16, 32)
CTAS_PER_SM = (1, 2, 3, 4)
#: The least a row must beat today's geometry by, and the most a path may
#: lose: the spread of kernel times between calls (PERF.md §7).
SPREAD = 0.02
ROUNDS = 4
#: The host's share of the card's time to issue one call from which a path
#: is host-paced.
HOST_PACED = 0.8
N64K, N1M, N512K, N16M = 1 << 16, 1 << 20, 1 << 19, 1 << 24


def candidate_rows():
    """Every row of the grid: threads x tasks per thread (0: every pass
    takes the row's threads; k: the threads that give each thread k tasks
    of a stage group, at most the row's) x lane_tile x wide_lane_tile x the
    shared-memory budget of 1, 2, 3 or 4 CTAs per SM."""
    for t, k_t, lt, wlt, k in itertools.product(
            THREADS, TASKS_PER_THREAD, LANE_TILES, LANE_TILES, CTAS_PER_SM):
        yield KernelTuning("sm_90", lt, 4096, smem_budget(k),
                           wide_lane_tile=wlt, threads=t,
                           tasks_per_thread=k_t)


def grid_geometries(m: int, wide: bool) -> dict:
    """The launch geometries the grid gives a factor of ``m`` rows on the
    int32 (or, ``wide``, int64) tile: {(threads, TC): the grid points
    (threads, lane_tile, CTAs per SM) that give it}.  Tasks per thread
    choose among the same thread counts, so they add no geometry."""
    out = {}
    for t, lt, k in itertools.product(THREADS, LANE_TILES, CTAS_PER_SM):
        tc = pick_lane_tile(None, lt, m, 8 if wide else 4, smem_budget(k))
        out.setdefault((t, tc), []).append((t, lt, k))
    return out


def check_geometry(dev, m: int, wide: bool, tc: int, threads: int) -> int:
    """One launch geometry on a small shape with a tail tile (2 items, 2 TC
    + 1 columns) against the plain version, in six forms: both directions,
    the turned load and the turned store, the table epilogue, and on the
    int32 tile the in-kernel epilogue, in every mode; seeded random data
    with the full-scale adversarial rows.  Returns the largest |kernel -
    plain|; raises RuntimeError where a call does not make exactly one
    launch of the geometry it was given."""
    c = 2 * tc + 1
    forms = [  # (inverse, natural, turned in, turned out, epilogue)
        (False, True, False, False, "table"), (True, True, True, False, None),
        (False, False, False, True, "table"), (True, False, True, True,
                                               "table")]
    if not wide:
        forms += [(False, True, False, True, "synth"),
                  (True, True, False, False, "synth")]
    worst = 0
    for k, (inverse, natural, t_in, t_out, epi) in enumerate(forms):
        mode = ("scaled", "round") if k % 2 else ("unscaled", "truncate")
        cfg = FFTConfig(n=m, mode=mode[0], rounding=mode[1],
                        data_width=32 if wide else 16, twiddle_width=16)
        in_dt = ((torch.int32, torch.int64)[k % 2] if wide
                 else torch.int32)
        tables = tuple(torch.as_tensor(t, device=dev)
                       for t in pack_tables(cfg))
        kw = dict(inverse=inverse, natural=natural, transpose_in=t_in,
                  transpose_out=t_out,
                  out_dtype=torch.int64 if wide else torch.int32)
        if epi == "table":
            kw["epi"] = tuple(torch.as_tensor(t, device=dev)
                              for t in circle_table(
                dataclasses.replace(cfg, n=m * 64), m, c, inverse,
                "natural" if natural else "raw"))
        elif epi == "synth":
            kw["synth"] = EpiSynth(*coarse_table(
                dataclasses.replace(cfg, n=1 << 20), dev), 1 << 20)
        bits = 32 if in_dt == torch.int64 else 16
        rng = np.random.default_rng(m + c + k)
        lim = 1 << (bits - 1)
        v = rng.integers(-lim, lim, (2, 2, c, m) if t_in else (2, 2, m, c))
        v[0, 0] = -lim                  # the full-scale adversarial item
        v[0, 0].reshape(-1)[::3] = lim - 1
        v[1, -1] = -lim
        x = [torch.as_tensor(p, dtype=in_dt, device=dev) for p in v]
        before = fused_pass.launches
        got = fused_pass(*x, cfg, tables, lane_tile=tc, threads=threads, **kw)
        torch.cuda.synchronize()
        if (fused_pass.launches != before + 1
                or fused_pass.geometry[:2] != (tc, threads)
                or fused_pass.geometry[3] != -(-c // tc)):
            raise RuntimeError(
                f"m = {m}, TC {tc} x {threads} threads, form {k}: "
                f"{fused_pass.launches - before} launches reporting "
                f"{fused_pass.geometry}")
        want = fused_pass_reference(*x, cfg, tables, **kw)
        worst = max(worst, *(int((a.long() - b.long()).abs().max())
                             for a, b in zip(got, want)))
    return worst


@dataclasses.dataclass
class Path:
    """A path of the sweep: its plans (each retuned to a row), one call
    (chained: its output is the next call's input, or not: every call reads
    the same input), the plain version of that call, its input (``data()``
    makes it, on the plans' device), the work that sets its bound, and
    whether it takes part in the choice."""

    name: str
    plans: list
    call: object
    plain: object
    data: object
    calls: int
    cost: KernelCost
    chained: bool = True
    decides: bool = True

    def key(self, row: KernelTuning) -> tuple:
        """The launch geometry ``row`` gives the path: each pass's (TC,
        threads)."""
        for p in self.plans:
            p.retune(row)
        return tuple((g["lane_tile"], g["threads"])
                     for p in self.plans for g in _geometries(p))

    def forms(self):
        """(in_size, out_size, inverse, two_d, rows, synth, product form,
        geometry) of each pass under the plans' current rows."""
        out = []
        for p in self.plans:
            if isinstance(p, LargeFFTPlan):
                sizes = (p.in_dtype, p.mid_dtype, p.out_dtype)
                for i, (cfg, kw) in enumerate(p.passes()):
                    epi = (kw.get("epi") is not None
                           or kw.get("synth") is not None)
                    two_d = kw.get("tables_2d") is not None
                    out.append((_size(sizes[i]), _size(sizes[i + 1]),
                                p.inverse, two_d, cfg.n, "synth" in kw,
                                product_form(cfg, sizes[i + 1], p.inverse,
                                             epi, two_d),
                                p.pass_geometry[i]))
            else:
                s = 8 if p.wide else 4
                out.append((s, s, p.inverse, False, p.cfg.n, False,
                            product_form(p.cfg, torch.int64 if p.wide
                                         else torch.int32, p.inverse,
                                         False), p.geometry))
        return out


def _size(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _geometries(plan):
    return (plan.pass_geometry if isinstance(plan, LargeFFTPlan)
            else (plan.geometry,))


def _data(shape, dtype, bits, seed, dev):
    """A maker of seeded random ``bits``-bit (re, im) on ``dev``."""
    def make():
        rng = np.random.default_rng(seed)
        lim = 1 << (bits - 1)
        return tuple(torch.as_tensor(rng.integers(-lim, lim, shape),
                                     dtype=dtype, device=dev)
                     for _ in range(2))
    return make


def _plain_single(p, xr, xi):
    """The plain version of a single-pass plan's call."""
    n, shp = p.cfg.n, xr.shape
    turned = not isinstance(p, (PallasFFTPlan, PallasWideFFTPlan)) or (
        isinstance(p, PallasFFTPlan) and p.layout == "bn")
    view = ((lambda x: x.reshape(1, -1, n)) if turned
            else (lambda x: x.reshape(1, n, -1)))
    dt = torch.int64 if p.wide else torch.int32
    yr, yi = fused_pass_reference(
        view(xr.to(dt)), view(xi.to(dt)), p.cfg, (p.w_re, p.w_im),
        inverse=p.inverse, natural=p.order == "natural",
        transpose_in=turned, transpose_out=turned)
    return yr.reshape(shp), yi.reshape(shp)


def paths(dev) -> list[Path]:
    """The paths of the sweep on ``dev``, at full size and published
    widths (PERF.md §5)."""
    from ..golden import make_conv_spec
    from ..parallel import OverlapSaveConv

    kw = dict(mode="scaled", rounding="round", data_width=16,
              twiddle_width=16)
    blocks = lambda p: (lambda a, b, q=p: q.apply_blocks(
        a, b, pass_fn=fused_pass_reference))
    out = []
    c3 = FFTConfig(n=4096, mode="scaled", rounding="round")
    xch = _data((4096, 4096), torch.int32, 16, 3, dev)
    for inverse in (False, True):
        what = "inverse" if inverse else "forward"
        cn = FusedAxisFFT(c3, inverse=inverse, device=dev)
        nc = PallasFFTPlan(c3, inverse=inverse, layout="nb", device=dev)
        out.append(Path(f"channelizer cn [4096 x 4096] int32, {what}", [cn],
                        cn, lambda a, b, p=cn: _plain_single(p, a, b), xch,
                        20, fft_cost(4096, 4096)))
        out.append(Path(f"channelizer nc [4096 x 4096] int32, {what}", [nc],
                        nc, lambda a, b, p=nc: _plain_single(p, a, b),
                        lambda: tuple(t.T.contiguous() for t in xch()), 20,
                        fft_cost(4096, 4096)))
    a = LargeFFTPlan(FFTConfig(n=N1M, **kw), fuse="split", device=dev)
    b = LargeFFTPlan(FFTConfig(n=N1M, **kw), a.n2, a.n1, fuse="split",
                     device=dev)
    out.append(Path(
        "1M block chain [4, 1024, 1024] int16, device twiddles", [a, b],
        lambda u, v: b.apply_blocks(*a.apply_blocks(u, v)),
        lambda u, v: blocks(b)(*blocks(a)(u, v)),
        _data((4, 1024, 1024), torch.int16, 16, 24, dev), 20,
        KernelCost(OPS_PER_SAMPLE_STAGE * 2 * 4 * N1M * 21,
                   4 * N1M * 2 * (2 + 2))))
    p512 = LargeFFTPlan(FFTConfig(n=N512K, **kw), fuse="split", device=dev)
    out.append(Path(
        "512K flat [8, 1024, 512] int16", [p512], p512.apply_blocks,
        blocks(p512), _data((8,) + p512.block_in_shape, torch.int16, 16, 25,
                            dev), 20,
        large_fft_cost(N512K, 8, itemsize=2), chained=False))
    x16 = _data((1, 4096, 4096), torch.int16, 16, 26, dev)
    for inverse in (False, True):
        p16 = LargeFFTPlan(FFTConfig(n=N16M, **kw), inverse=inverse,
                           fuse="split", device=dev)
        out.append(Path(
            f"16M [1, 4096, 4096] int16, device twiddles, "
            f"{'inverse' if inverse else 'forward'}", [p16],
            p16.apply_blocks, blocks(p16), x16, 10,
            large_fft_cost(N16M, 1, itemsize=2)))
    k5 = PallasWideFFTPlan(FFTConfig(n=4096, mode="unscaled", data_width=32,
                                     twiddle_width=16), device=dev)
    out.append(Path(
        "K5 PallasWideFFTPlan [4096, 1024] int64", [k5], k5,
        lambda u, v: _plain_single(k5, u, v),
        _data((4096, 1024), torch.int64, 32, 27, dev), 20,
        KernelCost(fft_cost(4096, 1024).int_ops, 4096 * 1024 * 2 * (8 + 8)),
        chained=False))
    spec = make_conv_spec(n=N64K, taps_len=(1 << 13) + 1, twiddle_width=16,
                          max_product_width=44, max_spectrum_width=25)
    taps = np.random.default_rng(1).integers(-(1 << 13), 1 << 13,
                                             spec.taps_len)
    conv = OverlapSaveConv(spec, taps, np.zeros_like(taps), device=dev)
    t = spec.payload * 64
    out.append(Path(
        "config 4 overlap-save, T = 64 payloads",
        [conv.pair.fwd, conv.pair.inv],
        conv, lambda u, v: conv(u, v, pass_fn=fused_pass_reference,
                                product_fn=spectrum_product_reference),
        _data((t,), torch.int32, 14, 28, dev), 20,
        KernelCost(OPS_PER_SAMPLE_STAGE * 64 * N64K * (2 * 17 + 1),
                   t * 2 * (4 + 8) + N64K * 2 * 4), chained=False))
    for n, nb in ((N64K, 64), (N512K, 2)):
        mono = LargeFFTPlan(FFTConfig(n=n, **kw), schedule="monolithic",
                            fuse="split", device=dev)
        out.append(Path(
            f"monolithic {n >> 10}K [{nb}, {mono.n1}, {mono.n2}] int16 "
            f"(2-D stage tables)", [mono], mono.apply_blocks, blocks(mono),
            _data((nb,) + mono.block_in_shape, torch.int16, 16, 29, dev),
            20, KernelCost(OPS_PER_SAMPLE_STAGE * nb * n * (n.bit_length() - 1),
                           nb * n * 2 * (2 + 2)),
            chained=mono.block_in_shape == mono.block_out_shape))
    head = LargeFFTPlan(FFTConfig(n=N64K, **kw), fuse="split", device=dev)
    out.append(Path(
        "64k headline [64, 256, 256] int16 (host-paced: not in the choice)",
        [head], head.apply_blocks, blocks(head),
        _data((64, 256, 256), torch.int16, 16, 5, dev), 50,
        large_fft_cost(N64K, 64, itemsize=2), decides=False))
    return out


def _event_ms(fn, x, calls, chained, warmup=3):
    """Mean device ms of one call: CUDA events around ``calls`` calls after
    ``warmup``; chained (each output the next input) or on one fixed x."""
    step = fn if chained else (lambda a, b: (fn(a, b), (a, b))[1])
    a, b = x
    for _ in range(warmup):
        a, b = step(a, b)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        a, b = step(a, b)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _paced(fn, x, calls, chained):
    """(device ms, host ms to issue) per call, as
    ``bench_torch.timing.paced``."""
    step = fn if chained else (lambda a, b: (fn(a, b), (a, b))[1])
    a, b = x
    for _ in range(3):
        a, b = step(a, b)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        a, b = step(a, b)
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, host * 1e3 / calls


def attributes(form, dev) -> tuple[int, int, int]:
    """(registers per thread, spill bytes per thread, CTAs per SM) of one
    pass form at its geometry, as the library reports them."""
    import ctypes

    in_size, out_size, inverse, two_d, rows, synth, product, g = form
    lib = _build.library(g["threads"])
    out = (ctypes.c_int * 5)()
    err = lib.intfft_pass_attributes(in_size, out_size, int(inverse),
                                     int(two_d), rows, g["lane_tile"],
                                     g["threads"], int(synth),
                                     int(modular(product)), 0, 0,
                                     dev.index, out)
    _build.check(lib, err, "intfft_pass_attributes")
    return out[0], out[1], out[3]


def build_variants() -> dict[int, str]:
    """Builds every thread count of ``THREADS`` the library lacks, side by
    side; returns each count's compiler log."""
    from concurrent.futures import ThreadPoolExecutor

    want = [t for t in THREADS if t not in _build.PASS_THREADS]
    with ThreadPoolExecutor(len(want)) as pool:
        logs = dict(zip(want, pool.map(lambda t: _build.build(t)[1], want)))
    for t in want:
        _build.library(t)
    return logs


def sweep(dev, rounds: int = ROUNDS, emit=print) -> dict:
    """Times every distinct geometry of every path (section 2 of the module
    docstring) and returns {"paths": [...], "spread": s, "row": the chosen
    KernelTuning as a dict, "changed": bool, "card": ...}."""
    from . import probe_vpu

    ceil = probe_vpu.same_session_ceilings(quick=True, device=dev)
    rows = list(candidate_rows())
    results = []
    for path in paths(dev):
        keys = {row: path.key(row) for row in rows}
        today = path.key(DEFAULT_TUNING)
        distinct = list(dict.fromkeys([today, *keys.values()]))
        by_key = {}
        for row, k in keys.items():
            by_key.setdefault(k, row)
        by_key[today] = DEFAULT_TUNING
        # every geometry bit-equal to the plain version first
        x = path.data()
        want = path.plain(*x)
        forms = {}
        for k in distinct:
            path.key(by_key[k])
            got = path.call(*x)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{path.name}: geometry {k} differs "
                                     f"from the plain version")
            forms[k] = [attributes(f, dev) for f in path.forms()]
        del want, got
        path.key(DEFAULT_TUNING)
        paced = _paced(path.call, x, path.calls, path.chained)
        decides = path.decides and paced[1] < HOST_PACED * paced[0]
        times = {k: [] for k in distinct}
        t_today = []
        for r in range(rounds):
            order = distinct if r % 2 == 0 else distinct[::-1]
            path.key(DEFAULT_TUNING)
            t_today.append(_event_ms(path.call, x, path.calls,
                                     path.chained))
            for k in order:
                path.key(by_key[k])
                times[k].append(_event_ms(path.call, x, path.calls,
                                          path.chained))
            path.key(DEFAULT_TUNING)
            t_today.append(_event_ms(path.call, x, path.calls,
                                     path.chained))
        path.key(DEFAULT_TUNING)
        bound_s = path.cost.time_bound(ceil)
        table = []
        for k in distinct:
            ms = min(times[k])
            regs = [f[0] for f in forms[k]]
            spill = [f[1] for f in forms[k]]
            ctas = [f[2] for f in forms[k]]
            table.append({"geometry": [list(g) for g in k], "ms": ms,
                          "readings": times[k],
                          "time_over_bound": ms / (bound_s * 1e3),
                          "registers": regs, "spill_bytes": spill,
                          "ctas_per_sm": ctas, "today": k == today})
        results.append({"name": path.name, "decides": decides,
                        "device_host_ms": paced,
                        "bound_ms": bound_s * 1e3, "today": list(today),
                        "today_readings": t_today, "table": table,
                        "keys": {_row_id(row): k for row, k in keys.items()}})
        _print_path(results[-1], emit)
    choice = choose(results)
    return {"paths": [{k: v for k, v in r.items() if k != "keys"}
                      for r in results], **choice,
            "ceilings": {"int_ops_per_s": ceil[0], "bytes_per_s": ceil[1]}}


ROW_FIELDS = ("threads", "tasks_per_thread", "lane_tile", "wide_lane_tile",
              "smem_per_cta")


def _row_id(row: KernelTuning) -> tuple:
    return tuple(getattr(row, f) for f in ROW_FIELDS)


def path_spread(result: dict) -> float:
    """The spread of one path: the larger of ``SPREAD`` and (max - min) /
    min of today's readings on it."""
    t = result["today_readings"]
    return max(SPREAD, max(t) / min(t) - 1)


def choose(results: list) -> dict:
    """The row of the sweep (module docstring, step 4), with the geometric
    mean of its time over today's and the run's spread."""
    deciding = [r for r in results if r["decides"]]
    spreads = [path_spread(r) for r in deciding]
    spread = statistics.median(spreads)
    ms = [{tuple(map(tuple, e["geometry"])): e for e in r["table"]}
          for r in deciding]
    today_ms = [m[tuple(map(tuple, r["today"]))]["ms"]
                for r, m in zip(deciding, ms)]
    today_spill = [m[tuple(map(tuple, r["today"]))]["spill_bytes"]
                   for r, m in zip(deciding, ms)]
    # rows that give every deciding path the same geometry tie: the one
    # nearest today's values (fewest knobs changed) is taken
    today_id = _row_id(DEFAULT_TUNING)
    moved = lambda row_id: sum(a != b for a, b in zip(row_id, today_id))
    best, best_mean = None, 1.0
    for row_id in sorted(deciding[0]["keys"], key=moved):
        ratios, ok = [], True
        for r, m, t, sp, s in zip(deciding, ms, today_ms, today_spill,
                                  spreads):
            e = m[r["keys"][row_id]]
            ratios.append(e["ms"] / t)
            ok &= (all(a <= b for a, b in zip(e["spill_bytes"], sp))
                   and ratios[-1] <= 1 + s)
        if not ok:
            continue
        mean = math.exp(sum(map(math.log, ratios)) / len(ratios))
        if mean < best_mean:
            best, best_mean = row_id, mean
    changed = best is not None and best_mean < 1 - spread
    return {"row": dict(zip(ROW_FIELDS, best if changed
                            else _row_id(DEFAULT_TUNING))),
            "changed": changed, "best_mean_ratio": best_mean,
            "spread": spread,
            "best_row": None if best is None else dict(zip(ROW_FIELDS,
                                                           best))}


def _print_path(r: dict, emit):
    dev_ms, host_ms = r["device_host_ms"]
    emit(f"== {r['name']}: bound {r['bound_ms']:.4f} ms; device ms / host ms "
         f"to issue one call {dev_ms:.4f} / {host_ms:.4f}"
         f"{'' if r['decides'] else ' (not in the choice)'}; today's "
         f"geometry {r['today']} read " + ", ".join(
             f"{t:.4f}" for t in r["today_readings"]))
    emit("   geometry (TC, threads) per pass | ms | time / bound | "
         "registers | spill B | CTAs per SM")
    for e in sorted(r["table"], key=lambda e: e["ms"]):
        emit(f"   {e['geometry']}{' (today)' if e['today'] else ''} | "
             f"{e['ms']:.4f} | {e['time_over_bound']:.2f} | "
             f"{e['registers']} | {e['spill_bytes']} | {e['ctas_per_sm']}")


def dry() -> int:
    """The grid and each path's distinct geometries, on the CPU (the plans
    alone: no data is made and nothing is timed)."""
    rows = list(candidate_rows())
    print(f"{len(rows)} candidate rows")
    for path in paths(torch.device("cpu")):
        keys = {path.key(row) for row in rows}
        print(f"{path.name}: {len(keys)} distinct geometries; today "
              f"{path.key(DEFAULT_TUNING)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--out", default=None,
                    help="write the full result as JSON to this file")
    ap.add_argument("--dry", action="store_true",
                    help="print the grid's distinct geometries (CPU)")
    args = ap.parse_args(argv)
    if args.dry:
        return dry()
    if not torch.cuda.is_available():
        print("sweep_tuning: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    logs = build_variants()
    print(f"library and variants {sorted(logs)} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for t, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"  ptxas t{t}: {line.split(':', 1)[-1].strip()}")
    res = sweep(dev, args.rounds, emit=lambda s: print(s, flush=True))
    res["card"] = card
    res["seconds"] = time.perf_counter() - t0
    print(f"spread (median over the deciding paths): {res['spread']:.4f}; best "
          f"row {res['best_row']} at a geometric mean of "
          f"{res['best_mean_ratio']:.4f} x today's")
    print("chosen row: " + json.dumps(res["row"]) + (
        " (beats today's)" if res["changed"] else " (today's values)"))
    if args.out:
        from pathlib import Path as _P

        _P(args.out).parent.mkdir(parents=True, exist_ok=True)
        _P(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"card": card, "row": res["row"],
                      "changed": res["changed"], "spread": res["spread"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
