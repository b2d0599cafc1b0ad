"""One run of one cell: build, warm up, measure (or trace), check, and
print the result's one line.

    python -m benchmark --workload NAME --seed N --seconds S --trace 0|1

In order: the cell's plans are built through the port's public API and
its ring of frames is made on the card from the seed; every slot's call
is captured and the ring replayed once more (all of this, from the
process's start, is ``setup_s``); the window replays the ring for
``--seconds`` (``--trace 1``: the traffic's ``trace_calls`` calls under
the profiler instead); then a sample of the answers in the ring, drawn
from the seed, is compared with the frozen reference.  Progress goes to
standard error, whose last lines are each number compared beside its
limit; the last line of standard output is the result.  With no card, or
fewer than the cell asks for, or with jax, the JAX package or bench_torch
loaded once the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from . import count, manifest, ring, trace, window

#: Top-level modules no run may hold: JAX and the packages built on it,
#: the JAX package, and the port's older benchmark.
FORBIDDEN = ("jax", "jaxlib", "flax", "intfftk_tpu", "bench_torch")
#: The limit of each number compared: the check is exact.
LIMITS = {"mismatched": 0, "max_gap": 0}


def forbidden_modules() -> list:
    """Forbidden modules in ``sys.modules``, by whole top-level name
    (``intfftk_tpu_torch`` is not ``intfftk_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def counters() -> dict:
    """The port's launch counters, by kernel."""
    from intfftk_tpu_torch.ops.fused_fft import fused_pass, fused_whole
    from intfftk_tpu_torch.ops.intmath import spectrum_product
    from intfftk_tpu_torch.ops.twiddle_synth import device_circle_table

    return {"fused_pass": fused_pass, "fused_whole": fused_whole,
            "spectrum_product": spectrum_product,
            "circle_table": device_circle_table}


def launch_counts() -> dict:
    return {k: c.launches for k, c in counters().items()}


class Context:
    """What a per-layer metric's reader reads: the trace of the traced
    window, its calls, the port's launches over it by counter, and the
    cell's work per call (``ring.Sizes.work``)."""

    def __init__(self, trace_, calls, launches, work):
        self.trace, self.calls = trace_, calls
        self.launches, self.work = launches, work


def synchronize(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def card(device) -> dict:
    """The contract's ``device`` field (without the peak)."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, for the
    log; read after the window."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi: {out.stderr.strip()}"


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             device, started: float, control: bool = False,
             alter=None) -> tuple[dict, list]:
    """Run ``cell`` once on ``device``: (the result's line, the numbers
    compared as (name, value, limit)).  ``started`` is the process's start
    on ``time.monotonic``'s clock.  ``control`` puts the control's answers
    in the program's place in the check; ``alter(built)``, where given,
    changes the built cell before the window (the tests' faults)."""
    import torch

    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    log(f"{cell.name}: torch and the card ready at "
        f"{time.monotonic() - started:.3f} s")
    built = cell.builder.build(cell.config, cell.traffic, device, seed)
    log(f"{cell.name}: plans, ring and captures done at "
        f"{time.monotonic() - started:.3f} s")
    if alter is not None:
        alter(built)
    size = built.sizes
    if device.type == "cuda" and size.ring_bytes < count.ring_floor_bytes():
        raise ValueError(f"{cell.name}: a ring of {size.ring_bytes} bytes "
                         f"would stay in the L2 cache; it needs "
                         f"{count.ring_floor_bytes()}")
    for slot in built.slots:              # one more round: every kernel warm
        slot.run()
    ring.fill_sentinel(built.slots)
    synchronize(device)
    setup_s = time.monotonic() - started
    log(f"{cell.name}: {len(built.slots)} slots, ring "
        f"{size.ring_bytes / 2**20:.2f} MiB in + out, "
        f"{size.samples_per_call} samples a call; set-up {setup_s:.3f} s")

    if traced:
        before = launch_counts()
        tr, win = trace.traced(built.slots, device,
                               int(cell.traffic["trace_calls"]))
        after = launch_counts()
    else:
        win = window.run(built.slots, device, seconds=seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"window: {win.calls} calls over {win.span_ms:.3f} ms of device "
        f"time; call ms median {sorted(win.call_ms)[win.calls // 2]:.5f}, "
        f"p95 {win.p95():.5f}, max {max(win.call_ms):.5f}")

    compared = built.check(seed, control)
    by_slot = win.calls_by_slot(len(built.slots))
    failed = sum(by_slot[k] for k in compared.bad_slots)
    numbers = [("mismatched", compared.mismatched, LIMITS["mismatched"]),
               ("max_gap", compared.max_gap, LIMITS["max_gap"])]
    correct = compared.answers > 0 and all(v <= lim
                                           for _, v, lim in numbers)
    log(f"checked {compared.answers} answers of {len(by_slot)} slots "
        f"against the reference{' (control in place)' if control else ''}")

    dev = dict(card(device), memory_peak_bytes=int(peak))
    if traced:
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        ctx = Context(tr, win.calls, launches, size.work)
        metrics = {}
        for name, unit, reader in cell.per_layer:
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        e2e = {"msamples_per_sec": lambda: win.rate(size.samples_per_call),
               "call_ms_p95": win.p95, "setup_s": lambda: setup_s}
        # a quantity split by the cells it bounds shares its reading
        metrics = {name: {"value": e2e[name.split(".")[0]](), "unit": unit}
                   for name, unit in cell.end_to_end}
    line = {"correct": bool(correct), "attempted": win.calls,
            "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        line["breakdown"] = tr.breakdown()
    line["compared"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in numbers}
    return line, numbers


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m benchmark",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="the cell's name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="the measured window's length")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="compare the control's answers in the program's "
                        "place (the control's reading; never a result)")
    return p.parse_args(argv)


def main(argv=None, started: float | None = None) -> int:
    started = time.monotonic() if started is None else started
    args = parse(argv)
    try:
        cell = manifest.cell(args.workload)
    except manifest.ManifestError as e:
        log(f"refused: {e}")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("refused: no CUDA device; the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"refused: {cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    line, numbers = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             started, control=args.control)
    log(f"card: {power_limit()}")
    bad = forbidden_modules()
    if bad:
        log(f"refused: the run holds {', '.join(bad)} in sys.modules")
        return 3
    for name, value, limit in numbers:
        log(f"{name} {value} limit {limit}")
    print(json.dumps(line), flush=True)
    return 0
