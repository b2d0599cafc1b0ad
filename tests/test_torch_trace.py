"""The port's spans (``intfftk_tpu_torch.runtime.trace``): nesting, parent
and call ids and self time; nothing recorded and no clock read with
recording off; the clock against the profiler's; the set-up spans of a
plan built on the CPU (a channelizer's noting its engine); the stream's
spans beside its ``stats``; the replay's spans on the CPU with a stand-in
graph; the same spans as ranges of torch's profiler, alone and beside a
recording, and neither sink's cost while both are off; the benchmark's
readers of those ranges (``port_host_ms``, ``idle_port_share``) on
hand-built traces.  The ``graph.*`` spans of real captured calls are
marked ``cuda`` and skip without a card."""

import contextlib
import ctypes
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from intfftk_tpu_torch.config import FFTConfig
from intfftk_tpu_torch.golden import make_conv_spec
from intfftk_tpu_torch.ops import _build
from intfftk_tpu_torch.ops.fused_fft import (LargeFFTPlan, PreparedPlan,
                                              fused_pass)
from intfftk_tpu_torch.ops.intmath import spectrum_product
from intfftk_tpu_torch.ops.single_pass import PallasFFTPlan
from intfftk_tpu_torch.parallel import Channelizer, OverlapSaveConv
from intfftk_tpu_torch.runtime import CapturedCall, StreamExecutor, trace
from intfftk_tpu_torch.runtime import graph as graph_mod

CFG = FFTConfig(n=4096, mode="scaled", rounding="round")


def _names(rec):
    return [s.name for s in rec.spans]


def test_nesting_parents_calls_and_self_time():
    with trace.recording() as rec:
        with rec.span("outer"):
            rec.add("graph.call", 100, 200, call=True)
            with rec.span("inner"):
                pass
        c = rec.add("graph.call", 300, 400, parent=-1, call=True)
        rec.add("graph.launch", 350, 390, c)
        rec.add("setup", 500, 600, parent=-1)
    s = rec.spans
    assert _names(rec) == ["outer", "graph.call", "inner", "graph.call",
                           "graph.launch", "setup"]
    assert [x.parent for x in s] == [-1, 0, 0, -1, 3, -1]
    assert [x.call for x in s] == [-1, 0, -1, 1, 1, -1]
    summary = rec.summary()
    assert summary["graph.call"]["count"] == 2
    assert summary["graph.call"]["total_ms"] == pytest.approx(200e-6)
    # the second call's launch covers 40 of its 100 ns
    assert summary["graph.call"]["self_ms"] == pytest.approx(160e-6)
    assert summary["graph.launch"] == {"count": 1, "total_ms": 40e-6,
                                       "self_ms": 40e-6}


def test_self_time_counts_overlapping_children_once():
    with trace.recording() as rec:
        p = rec.add("p", 0, 1000)
        rec.add("a", 100, 500, p)
        rec.add("b", 300, 700, p)           # overlaps a by 200
        rec.add("c", 900, 1500, p)          # runs past its parent's end
    # covered: 100-700 and 900-1000
    assert rec.summary()["p"]["self_ms"] == pytest.approx(300e-6)


def test_a_span_closes_when_its_block_raises():
    with trace.recording() as rec:
        with pytest.raises(KeyError):
            with rec.span("outer"):
                with rec.span("inner"):
                    raise KeyError("x")
        rec.add("after", 1, 2)
    assert [s.parent for s in rec.spans] == [-1, 0, -1]
    assert all(s.end_ns >= s.start_ns > 0 for s in rec.spans[:2])


def test_recordings_do_not_nest_and_switch_back_off():
    assert not trace.on and trace.active is None
    with pytest.raises(ValueError):
        with trace.recording() as rec:
            assert trace.on and trace.active is rec
            with pytest.raises(RuntimeError, match="open already"):
                with trace.recording():
                    pass
            raise ValueError("inside")
    assert not trace.on and trace.active is None


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    """With both sinks off, a plan's build, prepare and call, a
    convolution's and a channelizer's build and the stream run without one
    read of the spans' clock and without building a range."""
    def no_clock():
        raise AssertionError("the clock was read with recording off")

    def no_range(name):
        raise AssertionError(f"a range {name} was built with the "
                             f"profiler off")

    monkeypatch.setattr(trace.time, "time_ns", no_clock)
    monkeypatch.setattr(trace, "Range", no_range)
    plan = LargeFFTPlan(CFG, device="cpu")
    x = torch.zeros((2,) + plan.block_in_shape, dtype=plan.in_dtype)
    plan.apply_blocks(x, x)
    plan._prepare(("key",), lambda: object())
    spec = make_conv_spec(n=8192, taps_len=1025)
    OverlapSaveConv(spec, np.ones(1025), np.zeros(1025), device="cpu")
    Channelizer(CFG, device="cpu", layout="nc")
    n = 64
    ex = StreamExecutor(PallasFFTPlan(FFTConfig(n=n), layout="nb",
                                      device="cpu"), n=n, lane_tile=8,
                        device="cpu")
    list(ex.feed(np.zeros((n, 20), np.int32), np.zeros((n, 20), np.int32)))
    list(ex.flush())
    assert ex.stats["dispatches"] == 3
    assert not trace.on and trace.active is None


def test_clock_is_the_profilers():
    """A span read inside a ``record_function`` range lies within that
    range as the profiler stamped it, to 5 us."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with trace.recording() as rec, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        for i in range(50):
            with record_function(f"range{i}"):
                with rec.span(f"span{i}"):
                    pass
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("range")}
    assert len(ranges) == 50
    for i, s in enumerate(rec.spans):
        r = ranges[f"range{i}"]
        assert r.start_ns() - 5000 <= s.start_ns <= s.end_ns \
            <= r.end_ns() + 5000


def test_plan_build_on_the_cpu():
    """A plan built on the CPU is one root ``plan.build``, noting where its
    inter-factor twiddle comes from, with the table's ``twiddle.table``
    inside it; no library is loaded and nothing is prepared there."""
    with trace.recording() as rec:
        LargeFFTPlan(CFG, device="cpu")
    assert _names(rec) == ["plan.build", "twiddle.table"]
    s, table = rec.spans
    assert s.parent == -1 and s.call == -1 and s.end_ns > s.start_ns
    assert s.note == "epi device 32768"
    assert table.parent == 0 and table.note == "device 32x128 32768"
    assert s.start_ns <= table.start_ns <= table.end_ns <= s.end_ns


def test_convolution_build_nests_its_plans():
    spec = make_conv_spec(n=8192, taps_len=1025)
    with trace.recording() as rec:
        OverlapSaveConv(spec, np.ones(1025), np.zeros(1025), device="cpu")
    assert _names(rec) == ["plan.build"] * 3 + ["twiddle.table",
                                                "plan.build",
                                                "twiddle.table"]
    assert [s.parent for s in rec.spans] == [-1, 0, 1, 2, 1, 4]
    # the pair's chains run in raw order: the tables come from the host
    assert [s.note for s in rec.spans[2:]] == [
        "epi host 65536", "host 64x128 65536", "epi host 65536",
        "host 128x64 65536"]
    outer = rec.spans[0]
    assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
               for s in rec.spans[1:])


@pytest.mark.parametrize("layout, kernel, note", [
    ("cn", "auto", "cn FusedAxisFFT"), ("nc", "auto", "nc PallasFFTPlan(nb)"),
    ("cn", "xla", "cn FFTPlan")])
def test_channelizer_build_notes_its_engine(layout, kernel, note):
    """A channelizer built on the CPU is one root ``plan.build`` whose note
    gives its layout and engine."""
    with trace.recording() as rec:
        Channelizer(CFG, kernel=kernel, device="cpu", layout=layout)
    assert _names(rec) == ["plan.build"]
    (s,) = rec.spans
    assert s.parent == -1 and s.end_ns > s.start_ns and s.note == note


def test_prepare_is_a_span_at_its_first_use_only():
    plan = PreparedPlan()
    made = []
    with trace.recording() as rec:
        for _ in range(3):
            plan._prepare(("k",), lambda: made.append(1) or len(made))
        plan._prepare(("other",), lambda: made.append(1) or len(made))
    assert made == [1, 1]
    assert _names(rec) == ["plan.prepare"] * 2


@pytest.mark.parametrize("log, note", [("nvcc link: 1.0 s\n", "built"),
                                       ("", "cached")])
def test_library_load_says_what_happened(monkeypatch, log, note):
    """The first load for a thread count is one ``library.load`` span, noted
    "built" where nvcc ran and "cached" where the library was there; a
    second call is cached by ``functools`` and records nothing."""
    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "build", lambda threads=None: (
        Path("libintfft_pass_t1024.so"), log))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Lib())
    _build.library.cache_clear()
    try:
        with trace.recording() as rec:
            _build.library(1024)
            _build.library(1024)
    finally:
        _build.library.cache_clear()
    assert _names(rec) == ["library.load"]
    assert rec.spans[0].note == note


def test_stream_spans_are_its_stats():
    """The stream's three costs are spans while recording; each ``stats``
    timer is the sum of its spans' durations (one clock read serves
    both); the counts are what they are untraced."""
    n, lane = 64, 8
    ex = StreamExecutor(PallasFFTPlan(FFTConfig(n=n), layout="nb",
                                      device="cpu"), n=n, lane_tile=lane,
                        device="cpu")
    rng = np.random.default_rng(3)
    x = rng.integers(-100, 100, (n, 21)).astype(np.int32)
    with trace.recording() as rec:
        got = list(ex.feed(x[:, :13], x[:, :13]))
        got += list(ex.feed(x[:, 13:], x[:, 13:]))
        got += list(ex.flush())
    assert sum(g[0].shape[1] for g in got) == 21
    assert ex.stats["dispatches"] == 3 and ex.stats["samples_in"] == n * 21
    by = {}
    for s in rec.spans:
        assert s.parent == -1 and s.call == -1
        by.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e9)
    assert {k: len(v) for k, v in by.items()} == {
        "stream.repack": 3, "stream.dispatch": 3, "stream.wait": 3}
    for key, name in (("repack_s", "stream.repack"),
                      ("dispatch_s", "stream.dispatch"),
                      ("wait_s", "stream.wait")):
        assert ex.stats[key] == pytest.approx(sum(by[name]), abs=1e-12)


class _Replay:
    """A stand-in CUDA graph: its replay takes a known time."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1
        time.sleep(0.0002)


@pytest.fixture
def stand_in(monkeypatch):
    """A ``CapturedCall`` whose graph for two int32 [4] arguments on the CPU
    is already captured: a stand-in replay, static inputs, one
    ``fused_pass`` launch a replay."""
    monkeypatch.setattr(CapturedCall, "_key", staticmethod(
        lambda args: (args[0].device, *((a.shape, a.dtype) for a in args))))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(fused_pass, "launches", 0)
    call = CapturedCall(lambda a, b: (a, b))
    static = (torch.zeros(4, dtype=torch.int32),
              torch.zeros(4, dtype=torch.int32))
    g = graph_mod._Graph(_Replay(), static, static, ((fused_pass, 2),))
    call._graphs[CapturedCall._key(static)] = g
    return call, static, g


def test_replay_spans_with_a_stand_in_graph(stand_in):
    """Each call is a root ``graph.call`` with its own call id, holding
    ``graph.copy_in`` only where an input was copied, and
    ``graph.launch``; the replay and the counters run as untraced."""
    call, static, g = stand_in
    fresh = (torch.arange(4, dtype=torch.int32),) * 2
    with trace.recording() as rec:
        call(*fresh)                         # copied into the static inputs
        call(*static)                        # no copy
        call(*static)
    assert g.graph.replays == 3 and torch.equal(static[0], fresh[0])
    assert fused_pass.launches == 6
    calls = [i for i, s in enumerate(rec.spans) if s.name == "graph.call"]
    assert [rec.spans[i].call for i in calls] == [0, 1, 2]
    for i in calls:
        assert rec.spans[i].parent == -1
    kids = [[s.name for s in rec.spans if s.parent == i] for i in calls]
    assert kids == [["graph.copy_in", "graph.launch"], ["graph.launch"],
                    ["graph.launch"]]
    for s in rec.spans:
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert s.call == p.call
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    launch = rec.summary()["graph.launch"]
    assert launch["count"] == 3 and launch["total_ms"] >= 0.6
    # untraced, the same call records nothing and replays alike
    call(*static)
    assert g.graph.replays == 4 and len(rec.spans) == 3 + 2 + 2
    assert fused_pass.launches == 8


def test_replay_spans_nest_in_an_open_span(stand_in):
    """A call made inside an open span (the stream's dispatch) nests there
    and keeps a call id of its own."""
    call, static, _ = stand_in
    with trace.recording() as rec:
        with rec.span("stream.dispatch"):
            call(*static)
    assert _names(rec) == ["stream.dispatch", "graph.call", "graph.launch"]
    assert [s.parent for s in rec.spans] == [-1, 0, 1]
    assert [s.call for s in rec.spans] == [-1, 0, 0]


# ------------------------------------------------------------ the profiler

#: the names of the port's spans
PORT = ("graph.call", "graph.copy_in", "graph.launch", "graph.capture",
        "plan.build", "plan.prepare", "twiddle.table", "library.load",
        "stream.dispatch")


def _profiled(block):
    """The port's ranges in the profiler's trace of ``block()`` (CPU
    activities), in the order they opened."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        block()
    assert not trace.profiler._is_profiler_enabled
    return sorted((e for e in prof.profiler.kineto_results.events()
                   if e.name() in PORT), key=lambda e: e.start_ns())


def _inside(inner, outer) -> bool:
    return (outer.start_ns() <= inner.start_ns()
            <= inner.end_ns() <= outer.end_ns())


def test_profiler_ranges_of_replayed_calls(stand_in):
    """With the profiler on and no recording, each call is one
    ``graph.call`` range holding one ``graph.launch`` and, where an input
    was copied, one ``graph.copy_in``; the replays and the counters are
    the untraced ones."""
    call, static, g = stand_in
    fresh = (torch.arange(4, dtype=torch.int32),) * 2

    def calls():
        assert not trace.on
        call(*fresh)
        call(*static)
        call(*static)

    ranges = _profiled(calls)
    assert [e.name() for e in ranges] == [
        "graph.call", "graph.copy_in", "graph.launch",
        "graph.call", "graph.launch", "graph.call", "graph.launch"]
    assert g.graph.replays == 3 and fused_pass.launches == 6
    assert torch.equal(static[0], fresh[0])
    tops = [e for e in ranges if e.name() == "graph.call"]
    for e in ranges:
        if e.name() != "graph.call":
            assert sum(_inside(e, t) for t in tops) == 1
    # the stand-in replay's 0.2 ms lies in the launch
    assert all(e.end_ns() - e.start_ns() >= 200_000 for e in ranges
               if e.name() == "graph.launch")


def test_set_up_spans_are_profiler_ranges():
    """A plan built on the CPU under the profiler is a ``plan.build``
    range holding its ``twiddle.table``; a captured call's first call
    holds its ``graph.capture`` and no launch."""
    ranges = _profiled(lambda: LargeFFTPlan(CFG, device="cpu"))
    assert [e.name() for e in ranges] == ["plan.build", "twiddle.table"]
    assert _inside(ranges[1], ranges[0])


def test_first_call_range_holds_the_capture(monkeypatch):
    """A first call under the profiler: ``graph.call`` holding
    ``graph.capture``, and no ``graph.launch`` (set-up, not a replay)."""
    captured_g = graph_mod._Graph(_Replay(), (), (), ())
    monkeypatch.setattr(CapturedCall, "_key", staticmethod(
        lambda args: (args[0].device,)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(CapturedCall, "_capture", trace.spanned(
        "graph.capture")(lambda self, dev, args: captured_g))
    call = CapturedCall(lambda a: a)
    ranges = _profiled(lambda: call(torch.zeros(4)))
    assert [e.name() for e in ranges] == ["graph.call", "graph.capture"]
    assert _inside(ranges[1], ranges[0])
    assert captured_g.graph.replays == 1


def test_both_sinks_agree(stand_in):
    """A recording open under the profiler: the ranges and the recorded
    spans are the same spans, by name and in order, and each span lies in
    its range."""
    call, static, _ = stand_in
    fresh = (torch.arange(4, dtype=torch.int32),) * 2
    rec = None

    def block():
        nonlocal rec
        with trace.recording() as rec:
            LargeFFTPlan(CFG, device="cpu")
            call(*fresh)
            with trace.span("stream.dispatch"):
                call(*static)
            call(*static)

    ranges = _profiled(block)
    spans = sorted(rec.spans, key=lambda s: s.start_ns)
    assert [e.name() for e in ranges] == [s.name for s in spans] == [
        "plan.build", "twiddle.table", "graph.call", "graph.copy_in",
        "graph.launch", "stream.dispatch", "graph.call", "graph.launch",
        "graph.call", "graph.launch"]
    for e, s in zip(ranges, spans):
        assert e.start_ns() - 5000 <= s.start_ns <= s.end_ns \
            <= e.end_ns() + 5000


def test_both_sinks_off_read_no_clock_and_build_no_range(stand_in,
                                                         monkeypatch):
    """With no recording and the profiler off, a replayed call (with a
    copy and without) and a set-up span read no clock and build no
    range."""
    def no_clock():
        raise AssertionError("the clock was read with both sinks off")

    def no_range(name):
        raise AssertionError(f"a range {name} was built with the "
                             f"profiler off")

    call, static, g = stand_in
    fresh = (torch.arange(4, dtype=torch.int32),) * 2
    monkeypatch.setattr(trace.time, "time_ns", no_clock)
    monkeypatch.setattr(trace, "Range", no_range)
    call(*fresh)
    call(*static)
    with trace.span("stream.dispatch") as s:
        pass
    assert s is None and g.graph.replays == 2 and fused_pass.launches == 4


def test_a_call_that_raises_closes_its_range():
    """A call whose arguments are refused raises under the profiler and
    inside a recording, with its ``graph.call`` range closed and nothing
    recorded."""
    call = CapturedCall(lambda a: a)
    rec = None

    def block():
        nonlocal rec
        with trace.recording() as rec:
            with pytest.raises(ValueError, match="CUDA tensors only"):
                call(torch.zeros(4))

    ranges = _profiled(block)
    assert [e.name() for e in ranges] == ["graph.call"]
    assert ranges[0].end_ns() >= ranges[0].start_ns() > 0
    assert rec.spans == []


def _reader(name):
    from benchmark import manifest

    return manifest._reader(manifest.HERE, name)


def _read(name, device, host):
    """Reader ``name`` on a trace of (name, start, end) tuples in us."""
    from benchmark import run
    from benchmark.trace import Span, Trace

    def spans(rows):
        return tuple(Span(n, a * 1000, b * 1000) for n, a, b in rows)

    ctx = run.Context(Trace(spans(device), spans(host)), 1, {}, None)
    return _reader(name).read(ctx)


#: the device busy 0-10, 30-40, 70-80, 100-110 us: 70 of a 110 us window
#: idle, in three gaps
DEVICE = [("k", 0, 10), ("k", 30, 40), ("k", 70, 80), ("k", 100, 110)]
#: the gap 10-30 all in a call (its launch included); of 40-70 the
#: harness's event record, then a call from 55 on; of 80-100 a first call
#: (a capture, no launch) 85-90 and a call from 95 on
HOST = [("graph.call", 5, 35), ("graph.launch", 20, 25),
        ("cudaEventRecordWithFlags", 40, 50),
        ("graph.call", 55, 75), ("graph.launch", 60, 65),
        ("graph.call", 85, 90), ("graph.capture", 86, 89),
        ("graph.call", 95, 120), ("graph.copy_in", 95, 96),
        ("graph.launch", 96, 99), ("graph.launch", 130, 131)]


@pytest.mark.parametrize("name, want", [
    # (25 + 15 + 22) / 3 us: the call without a launch, and the launch
    # outside any call, left out
    ("port_host_ms.small_calls", 62 / 3 / 1000),
    # (20 + 15 + 5 + 5) of 110 us
    ("idle_port_share.small_calls", 100 * 45 / 110)])
def test_reader_splits_a_known_trace(name, want):
    assert _read(name, DEVICE, HOST) == pytest.approx(want)


def test_idle_splits_between_the_port_and_the_rest():
    """``idle_share`` less ``idle_port_share`` is the idle outside the
    port's calls: here the harness's 40-55 and the 10 us of 80-100 that
    no call covers, 25 of 110 us."""
    idle = _read("idle_share.small_calls", DEVICE, HOST)
    port = _read("idle_port_share.small_calls", DEVICE, HOST)
    assert idle == pytest.approx(100 * 70 / 110)
    assert idle - port == pytest.approx(100 * 25 / 110)


@pytest.mark.parametrize("name", ["port_host_ms.small_calls",
                                  "idle_port_share.small_calls"])
@pytest.mark.parametrize("host", [
    [("cudaGraphLaunch", 12, 14), ("cudaEventRecordWithFlags", 40, 50)],
    []])
def test_reader_reads_none_without_the_ports_ranges(name, host):
    """A program that opens no ``graph.*`` range (an older port) reads
    None, not 0."""
    assert _read(name, DEVICE, host) is None


def test_port_host_ms_leaves_out_calls_without_one_launch():
    host = [("graph.call", 0, 10), ("graph.launch", 2, 4),
            ("graph.launch", 5, 7),             # two: left out
            ("graph.call", 20, 30),             # none: left out
            ("graph.call", 40, 50), ("graph.launch", 41, 49)]
    assert _read("port_host_ms.small_calls", DEVICE, host) == \
        pytest.approx(2 / 1000)
    assert _read("port_host_ms.small_calls", DEVICE, host[:2] + host[3:4]) \
        == pytest.approx(8 / 1000)
    assert _read("port_host_ms.small_calls", DEVICE, host[3:4]) is None


def test_idle_port_share_counts_overlapping_calls_once():
    """Calls that overlap (a call made inside another) cover a gap once;
    a trace with no device activity has no window and reads None."""
    host = [("graph.call", 12, 25), ("graph.call", 15, 28)]
    assert _read("idle_port_share.small_calls", DEVICE, host) == \
        pytest.approx(100 * 16 / 110)
    assert _read("idle_port_share.small_calls", [], host) is None


def test_readers_read_the_profilers_own_trace(stand_in):
    """The harness's own reduction of a profiled window
    (``benchmark.trace.from_kineto``) keeps the port's ranges among the
    host's, and ``port_host_ms`` reads each call less its launch."""
    from benchmark import run
    from benchmark import trace as btrace
    from torch.profiler import ProfilerActivity, profile

    call, static, _ = stand_in
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            call(*static)
    tr = btrace.from_kineto(prof.profiler.kineto_results.events())
    by = {}
    for s in tr.host:
        by.setdefault(s.name, []).append(s.end_ns - s.start_ns)
    assert len(by["graph.call"]) == len(by["graph.launch"]) == 5
    ctx = run.Context(tr, 5, {}, None)
    own = _reader("port_host_ms.small_calls").read(ctx)
    assert own == pytest.approx(
        (sum(by["graph.call"]) - sum(by["graph.launch"])) / 5 / 1e6)
    assert 0 < own < min(by["graph.call"]) / 1e6
    assert _reader("idle_port_share.small_calls").read(ctx) is None


# ---------------------------------------------------------------- the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frames(plan, dev, batch, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return tuple(torch.randint(-2**15, 2**15, (batch,) + plan.block_in_shape,
                               generator=g, device=dev, dtype=plan.in_dtype)
                 for _ in range(2))


@pytest.mark.cuda
def test_graph_spans_on_the_card(dev):
    """A plan built, captured and called on the card: the build, the
    capture (with its prepared chain inside) and each later call's spans,
    the launch counters' deltas, and the same bits as untraced."""
    before = fused_pass.launches
    with trace.recording() as rec:
        plan = LargeFFTPlan(CFG, device=dev)
        call = plan.capture()
        x = _frames(plan, dev, 4, 1)
        first = [t.clone() for t in call(*x)]
        y = _frames(plan, dev, 4, 2)
        second = [t.clone() for t in call(*y)]
        call(*call.static_inputs(*y))
        torch.cuda.synchronize(dev)
    roots = [s.name for s in rec.spans if s.parent == -1]
    assert roots == ["plan.build", "graph.capture", "graph.call",
                     "graph.call"]
    cap = rec.spans.index(next(s for s in rec.spans
                               if s.name == "graph.capture"))
    assert "plan.prepare" in [s.name for s in rec.spans if s.parent == cap]
    calls = [i for i, s in enumerate(rec.spans) if s.name == "graph.call"]
    assert [rec.spans[i].call for i in calls] == [0, 1]
    kids = [[s.name for s in rec.spans if s.parent == i] for i in calls]
    assert kids == [["graph.copy_in", "graph.launch"], ["graph.launch"]]
    # the capture ran nothing; the warm-up and three replays did
    assert fused_pass.launches - before == 2 * 4
    for want, got in ((first, plan.apply_blocks(*x)),
                      (second, plan.apply_blocks(*y))):
        assert all(torch.equal(a, b) for a, b in zip(want, got))


@pytest.mark.cuda
def test_library_load_on_the_card(dev):
    """The library's load, made anew, is one span inside the plan's build:
    the device twiddle generator loads it, inside its ``twiddle.table``."""
    _build.library.cache_clear()
    with trace.recording() as rec:
        LargeFFTPlan(CFG, device=dev)
    loads = [s for s in rec.spans if s.name == "library.load"]
    assert len(loads) == 1 and loads[0].note in ("built", "cached")
    table = rec.spans[loads[0].parent]
    assert table.name == "twiddle.table" and table.note == \
        "device 32x128 32768"
    assert rec.spans[table.parent].name == "plan.build"


@pytest.mark.cuda
def test_profiler_ranges_on_the_card(dev):
    """Captured calls under the profiler with the card traced: each call's
    ``graph.call`` and ``graph.launch`` are host ranges of the harness's
    reduction, and no ``graph.*`` name is among the card's work."""
    from benchmark import trace as btrace
    from torch.profiler import ProfilerActivity, profile

    plan = LargeFFTPlan(CFG, device=dev)
    call = plan.capture()
    x = _frames(plan, dev, 4, 1)
    call(*x)
    static = call.static_inputs(*x)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call(*static)
        torch.cuda.synchronize(dev)
    tr = btrace.from_kineto(prof.profiler.kineto_results.events())
    names = [s.name for s in tr.host]
    assert names.count("graph.call") == names.count("graph.launch") == 3
    assert "graph.copy_in" not in names
    assert tr.device and not [s.name for s in tr.device
                              if s.name.startswith("graph.")]
