"""The port's own spans (``intfftk_tpu_torch.runtime.trace``) in a cell:
the set-up's, and two windows of the cell's ring.

* **Set-up**: recording on from just before the cell's build until its
  warm round ends.  Its root ``graph.capture``, ``plan.build``,
  ``plan.prepare`` and ``library.load`` spans give ``setup_port_s``.
* **Window S**: the traffic's ``trace_calls`` calls of the ring, as the
  measured window replays them, with recording on and no profiler.  Its
  ``graph.call`` spans less their ``graph.launch`` give
  ``submit_host_ms``: the port's host code around the CUDA graph launch.
* **Window J**: the same calls with recording on, under the profiler.
  Matching each ``graph.launch`` span to the ``cudaGraphLaunch`` it
  contains, and that launch's correlation id to the device work it
  started, gives ``submit_wait_ms``: device idle time during which the
  host was inside the port, before the launch.  The spans and the
  profiler's host events share one clock; the card's timestamps are
  converted to it by the profiler, and that conversion is checked in
  every J both ways (``Waits.aligned``): J is taken again, up to five
  times, while it fails, and every J taken is logged.

Python's collector is off during S and J (``collector_off``).

The readers of ``metrics/`` read ``ctx.spans``, a ``Readings``, and give
None where it is absent: where the port has no span module (a commit before
it), ``port_trace()`` is None and nothing is recorded or read.

``python -m benchmark.spans --workload NAME --seed N`` builds the cell,
takes these readings and prints them as one JSON line, logging the windows
to standard error.  The benchmark's own command, ``python -m benchmark``,
does not take them yet: ``measure`` is the tool's, and ``windows``,
``report`` and ``read`` what a traced run would call.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import gc
import importlib
import json
import statistics
import sys

from . import manifest, run, trace, window

#: the root spans whose union is the port's set-up
SETUP = ("graph.capture", "plan.build", "plan.prepare", "library.load")
#: the per-layer metrics read here, with their units
METRICS = (("submit_host_ms", "ms"), ("submit_wait_ms", "ms"),
           ("setup_port_s", "s"))
#: the host's runtime call that launches a graph
GRAPH_LAUNCH = "cudaGraphLaunch"
#: the share of each run of a window's calls (``RUNS``) whose work may start
#: before their launch on the profiler's clock (their timestamps off the
#: host's) before the window is not read
SKEWED = 0.01
#: a window's found calls are checked in this many runs of consecutive
#: calls, so that a clock that drifts within the window shows
RUNS = 8
#: the most a graph launched to an idle card takes, from the start of its
#: cudaGraphLaunch, to start its work on the profiler's clock (the least
#: lags of the windows checked: 5-12 us)
LATENCY_NS = 20_000


def port_trace():
    """The port's span module, or None where the port has none."""
    try:
        return importlib.import_module("intfftk_tpu_torch.runtime.trace")
    except ImportError:
        return None


@dataclasses.dataclass(frozen=True)
class Event:
    """One activity of the profiler's trace with its correlation id: a
    device activity carries the id of the host call that launched it."""

    name: str
    start_ns: int
    end_ns: int
    correlation: int


@dataclasses.dataclass(frozen=True)
class Events:
    """Window J's device activities (the card's work, as ``trace.py``
    keeps it) and its host launches of graphs."""

    device: tuple
    launches: tuple


def events(kineto_events) -> Events:
    """``Events`` of the profiler's raw events."""
    from torch.autograd import DeviceType

    device, launches = [], []
    for e in kineto_events:
        ev = Event(e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            if not (trace._flag(e, "is_user_annotation", False)
                    or any(w in trace._flag(e, "activity_type", "")
                           for w in trace.NOT_WORK)):
                device.append(ev)
        elif ev.name == GRAPH_LAUNCH:
            launches.append(ev)
    return Events(tuple(device), tuple(launches))


@dataclasses.dataclass
class Readings:
    """What the readers read: the set-up's recording, window S's, and the
    J read with its events: the first J taken whose card clock passes the
    check (``Waits.aligned``), else the last; each None where not taken.
    For the log, S's ``window.Window`` and every J taken (``tries``), as
    (recording, ``Events``, ``window.Window``)."""

    setup: object = None
    s: object = None
    j: object = None
    j_events: Events | None = None
    s_window: object = None
    tries: list = dataclasses.field(default_factory=list)


def _union_ns(intervals) -> int:
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total, reach = total + b - a, b
        elif b > reach:
            total, reach = total + b - reach, b
    return total


def _overlap(a0, a1, b0, b1) -> int:
    return max(0, min(a1, b1) - max(a0, b0))


def setup_port_s(spans) -> float | None:
    """Seconds covered by the union of the root set-up spans."""
    roots = [(s.start_ns, s.end_ns) for s in spans
             if s.parent == -1 and s.name in SETUP and s.end_ns]
    return _union_ns(roots) / 1e9 if roots else None


def calls(spans) -> list:
    """(``graph.call``, its ``graph.launch``) of each call, in order."""
    launch = {s.parent: s for s in spans if s.name == "graph.launch"}
    return [(s, launch[i]) for i, s in enumerate(spans)
            if s.name == "graph.call" and i in launch]


def submit_host_ms(spans) -> float | None:
    """Mean ms per call of ``graph.call`` less its ``graph.launch``."""
    pairs = calls(spans)
    if not pairs:
        return None
    return sum((c.end_ns - c.start_ns) - (la.end_ns - la.start_ns)
               for c, la in pairs) / len(pairs) / 1e6


def _inside(launches, span) -> list:
    """The launches (sorted by start) that lie within ``span``."""
    lo = bisect.bisect_left(launches, span.start_ns, key=lambda e: e.start_ns)
    hi = bisect.bisect_right(launches, span.end_ns, key=lambda e: e.start_ns)
    return [e for e in launches[lo:hi] if e.end_ns <= span.end_ns]


@dataclasses.dataclass
class Waits:
    """Window J's idle time split call by call, in ns summed over the calls
    read: ``wait`` (the host inside the call, before its launch),
    ``before`` (the host before the call began: the harness's loop and the
    previous call's end) and ``launch`` (from the launch's start to the
    work's: the CUDA runtime's and the card's own latency).

    Of the ``calls`` (``graph.call`` spans), ``matched`` hold one
    ``cudaGraphLaunch`` in their ``graph.launch``; ``found`` of those have
    device work carrying that launch's correlation id; ``read`` of those
    started their work after the card had run dry, and not before their
    launch.  ``lags`` are each found call's work start less its launch's
    start, in call order: the check of the card's clock against the
    host's (``aligned``)."""

    calls: int = 0
    matched: int = 0
    found: int = 0
    read: int = 0
    wait: int = 0
    before: int = 0
    launch: int = 0
    lags: list = dataclasses.field(default_factory=list)

    @property
    def skewed(self) -> int:
        """Calls whose work starts before their launch on the profiler's
        clock."""
        return sum(1 for lag in self.lags if lag < 0)

    @property
    def floors(self) -> list:
        """Each run's least lag, past its ``SKEWED`` share of outliers, for
        ``RUNS`` runs of consecutive found calls."""
        n, out = len(self.lags), []
        for r in range(RUNS):
            run = sorted(self.lags[r * n // RUNS:(r + 1) * n // RUNS])
            if run:
                out.append(run[int(SKEWED * len(run))])
        return out

    @property
    def aligned(self) -> bool:
        """The card's clock checked both ways: every matched call's work
        found, and each run's floor (``floors``) between 0 (no work before
        its launch) and ``LATENCY_NS`` (some call of the run found the card
        idle, and its work started one launch's latency after the launch).
        A window in which no call found the card idle, its launches queued
        far ahead, fails: its clock cannot be checked."""
        return (0 < self.found == self.matched
                and all(0 <= f <= LATENCY_NS for f in self.floors))

    def per_call_ms(self, part: int) -> float:
        """``part`` in ms per matched call."""
        return part / self.matched / 1e6


def waits(spans, ev: Events) -> Waits:
    """Each call's idle time, by what the host was doing (``Waits``).

    A call's ``graph.launch`` span matches when it contains exactly one
    ``cudaGraphLaunch``; the device activities carrying that launch's
    correlation id are the call's work.  The card ran dry at the end of the
    busy stretch before the work's first start; a call whose work starts
    inside a busy stretch, or before any, adds nothing, nor does one whose
    work starts before its launch (its card timestamps are off)."""
    out = Waits()
    pairs = calls(spans)
    out.calls = len(pairs)
    launches = sorted(ev.launches, key=lambda e: e.start_ns)
    matched = []
    for call, la in pairs:
        inside = _inside(launches, la)
        if len(inside) == 1:
            matched.append((call, la, inside[0]))
    out.matched = len(matched)
    first = {}
    for e in ev.device:
        if e.start_ns < first.get(e.correlation, e.start_ns + 1):
            first[e.correlation] = e.start_ns
    busy = trace.Trace(tuple(trace.Span(e.name, e.start_ns, e.end_ns)
                             for e in ev.device), ())._merged()
    begins = [b[0] for b in busy]
    for call, la, h in matched:
        if h.correlation not in first:
            continue
        out.found += 1
        w = first[h.correlation]
        out.lags.append(w - h.start_ns)
        k = bisect.bisect_right(begins, w) - 1
        if w < h.start_ns or k < 1 or busy[k][0] != w:
            continue        # timestamps off, busy already, or nothing before
        dry = busy[k - 1][1]
        out.read += 1
        out.wait += _overlap(dry, w, call.start_ns, la.start_ns)
        out.before += _overlap(dry, w, dry, call.start_ns)
        out.launch += _overlap(dry, w, la.start_ns, w)
    return out


def margins(spans, ev: Events) -> list:
    """The shared clock's check, beside the share of ``graph.launch`` spans
    that hold one ``cudaGraphLaunch`` (``Waits.matched``): for each such
    span, how far inside it the launch lies, as (the launch's start less
    the span's, the span's end less the launch's) in ns."""
    launches = sorted(ev.launches, key=lambda e: e.start_ns)
    out = []
    for _, la in calls(spans):
        inside = _inside(launches, la)
        if len(inside) == 1:
            out.append((inside[0].start_ns - la.start_ns,
                        la.end_ns - inside[0].end_ns))
    return out


def submit_wait_ms(spans, ev: Events) -> float | None:
    """Mean ms per matched call of device idle time while the host was
    inside the call, before its launch; None where the card's clock fails
    the check (``Waits.aligned``)."""
    w = waits(spans, ev)
    return w.per_call_ms(w.wait) if w.aligned else None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def log_summary(what: str, rec) -> None:
    for name, row in sorted(rec.summary().items()):
        log(f"{what}: {name} x {row['count']}: total "
            f"{row['total_ms']:.6f} ms, self {row['self_ms']:.6f} ms")


@contextlib.contextmanager
def collector_off():
    """Python's cyclic collector off for the block: the spans a recording
    keeps would otherwise set off full collections inside the port's
    calls (one of 334 ms in a window of 8 000 calls), which an untraced
    run does not have."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def windows(port, slots, device, calls_: int, tries: int = 5) -> Readings:
    """Window S, then window J, taken again, ``tries`` times in all, while
    the card's clock fails the check (``Waits.aligned``): the ``Readings``
    of both (without the set-up's)."""
    from torch.profiler import ProfilerActivity, profile

    out = Readings()
    with collector_off(), port.recording() as out.s:
        out.s_window = window.run(slots, device, calls=calls_)
    for _ in range(tries):
        with collector_off(), port.recording() as j, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            j_win = window.run(slots, device, calls=calls_)
        ev = events(prof.profiler.kineto_results.events())
        out.tries.append((j, ev, j_win))
        out.j, out.j_events = j, ev
        if waits(j.spans, ev).aligned:
            break
    return out


def metric_names(cell) -> list:
    """(name, unit) of each metric read here, as the cell names it: the
    submission's under the suffix of the cell's rate."""
    rate = next(n for n, _ in cell.end_to_end
                if n.split(".")[0] == "msamples_per_sec")
    suffix = rate[len("msamples_per_sec"):]
    return [(name if name == "setup_port_s" else name + suffix, unit)
            for name, unit in METRICS]


def _us(ns) -> str:
    return f"{ns / 1e3:.3f}"


def report(readings: Readings, samples: int) -> None:
    """Log windows S and every J taken: their rates, J's idle share, the
    shared clock's checks and J's split of the idle time; the span
    summaries of S and of the J read."""
    s_win = readings.s_window
    log(f"window S: {s_win.calls} calls, {s_win.rate(samples):.1f} "
        f"Msamples/s (recording on, no profiler)")
    log_summary("window S", readings.s)
    for k, (j, ev, j_win) in enumerate(readings.tries, 1):
        what = f"window J, try {k}"
        j_trace = trace.Trace(tuple(trace.Span(e.name, e.start_ns, e.end_ns)
                                    for e in ev.device), ())
        idle = (100.0 * (1.0 - j_trace.busy_s / j_trace.window_s)
                if j_trace.window_s else float("nan"))
        w = waits(j.spans, ev)
        log(f"{what}: {j_win.calls} calls, {j_win.rate(samples):.1f} "
            f"Msamples/s, idle {idle:.4f} % (recording on, profiled); "
            f"{w.matched} of {w.calls} graph.launch spans hold one "
            f"{GRAPH_LAUNCH}, work found by correlation id for {w.found}, "
            f"idle read on {w.read}")
        if w.lags:
            lags = sorted(w.lags)
            log(f"{what}: work's start less its launch's, us: least "
                f"{_us(lags[0])}, median {_us(lags[len(lags) // 2])}, most "
                f"{_us(lags[-1])}; {w.skewed} calls before their launch")
        log(f"{what}: the least lag of each run of "
            f"{len(w.lags) // RUNS} calls, past {SKEWED:.0%} of outliers, "
            f"us: {', '.join(_us(f) for f in w.floors)}")
        log(f"{what}: the card's clock "
            f"{'passes' if w.aligned else 'fails'} the check (floors within "
            f"0-{_us(LATENCY_NS)} us); idle ms a "
            f"matched call: waiting for the port "
            f"{w.per_call_ms(w.wait) if w.matched else float('nan'):.6f}, "
            f"before the call "
            f"{w.per_call_ms(w.before) if w.matched else float('nan'):.6f}, "
            f"the launch's latency "
            f"{w.per_call_ms(w.launch) if w.matched else float('nan'):.6f}")
    if readings.j is None:
        return
    log_summary("window J read", readings.j)
    m = margins(readings.j.spans, readings.j_events)
    if m:
        log(f"window J read: {GRAPH_LAUNCH} inside its graph.launch: from "
            f"its start median {statistics.median(a for a, _ in m)} ns "
            f"(least {min(a for a, _ in m)}), before its end median "
            f"{statistics.median(b for _, b in m)} ns (least "
            f"{min(b for _, b in m)})")


def read(cell: manifest.Cell, readings: Readings | None) -> dict:
    """The metrics of ``metric_names(cell)`` that its readers find, as a
    result line's ``metrics`` holds them."""
    ctx = run.Context(None, None, None, None)
    ctx.spans = readings
    out = {}
    for name, unit in metric_names(cell):
        value = manifest._reader(manifest.HERE, name).read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def measure(cell: manifest.Cell, seed: int, device, tries: int = 5) -> dict:
    """Build ``cell`` on ``device`` with its set-up recorded up to the end
    of one warm round, then take windows S and J; log them and return the
    readings (``read``).  Nothing is built and nothing read where the port
    has no span module."""
    port = port_trace()
    if port is None:
        log(f"{cell.name}: the port has no span module; nothing to read")
        return {}
    with port.recording() as setup:
        built = cell.builder.build(cell.config, cell.traffic, device, seed)
        for slot in built.slots:            # the warm round
            slot.run()
        run.synchronize(device)
    log_summary("set-up", setup)
    readings = windows(port, built.slots, device,
                       int(cell.traffic["trace_calls"]), tries)
    readings.setup = setup
    report(readings, built.sizes.samples_per_call)
    return read(cell, readings)


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m benchmark.spans",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="the cell's name")
    p.add_argument("--seed", type=int, required=True)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = manifest.cell(args.workload)
    except manifest.ManifestError as e:
        log(f"refused: {e}")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("refused: no CUDA device; the spans are read on the card")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    metrics = measure(cell, args.seed, device)
    log(f"card: {run.power_limit()}")
    print(json.dumps({"workload": cell.name, "seed": args.seed,
                      "metrics": metrics}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
