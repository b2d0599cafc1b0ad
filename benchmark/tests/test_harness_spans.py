"""The readers of the port's spans (``spans.py``, ``metrics/submit_host_ms``,
``submit_wait_ms``, ``setup_port_s``) on synthetic spans and events: a
host late by a known time reads that wait, a host ahead reads 0, set-up
roots that overlap count once, a launch span that holds no launch or two is
not matched, the card's clock is checked both ways, work with no launch's
id reads nothing; and the span tool on a tiny cell on the CPU, with the
port's span module and as a commit without it."""

import sys

import pytest
import torch

from benchmark import manifest, run, spans

SEED = (1 << 31) + 977


def _rec(*calls):
    """A recording of calls given as (call start, launch start, launch
    end, call end) in ns."""
    from intfftk_tpu_torch.runtime.trace import Recording

    rec = Recording()
    for c0, l0, l1, c1 in calls:
        i = rec.add("graph.call", c0, c1, call=True)
        rec.add("graph.key", c0, c0 + 1, i)
        rec.add("graph.launch", l0, l1, i)
    return rec


def _ev(device, launches):
    E = spans.Event
    return spans.Events(tuple(E("k", a, b, c) for a, b, c in device),
                        tuple(E(spans.GRAPH_LAUNCH, a, b, c)
                              for a, b, c in launches))


def _readers(cell="conv64k_t4"):
    return {name: manifest._reader(manifest.HERE, name)
            for name, _ in spans.metric_names(manifest.cell(cell))}


def test_host_late_reads_its_wait():
    """The card runs dry at 10 000 ns; the host enters the call at 10 010,
    launches at 10 040, the work starts at 10 060: 30 ns of the idle 60
    are the port's, 10 before the call, 20 the launch's."""
    rec = _rec((1000, 1100, 1200, 1300), (10010, 10040, 10050, 10055))
    ev = _ev([(2000, 10000, 1), (10060, 12000, 2)],
             [(1110, 1190, 1), (10041, 10049, 2)])
    w = spans.waits(rec.spans, ev)
    assert (w.calls, w.matched, w.found, w.read) == (2, 2, 2, 1)
    assert w.lags == [890, 19] and w.floors == [890, 19] and w.aligned
    assert (w.wait, w.before, w.launch) == (30, 10, 20)
    # over both matched calls, the first of which found the card busy
    assert spans.submit_wait_ms(rec.spans, ev) == pytest.approx(15e-6)
    assert spans.margins(rec.spans, ev) == [(10, 10), (1, 1)]
    # the call less its launch: (300 - 100 + 45 - 10) / 2 ns
    assert spans.submit_host_ms(rec.spans) == pytest.approx(117.5e-6)


def test_host_ahead_reads_zero():
    """Calls issued long before the card reaches them: no wait, whether
    the work starts inside a busy stretch or after a gap the launch's
    latency spans."""
    rec = _rec((100, 130, 140, 150), (200, 230, 240, 250),
               (300, 330, 340, 350))
    ev = _ev([(1000, 2000, 1), (2000, 3000, 2), (3008, 4000, 3)],
             [(131, 139, 1), (231, 239, 2), (331, 339, 3)])
    w = spans.waits(rec.spans, ev)
    assert w.read == 1 and w.wait == 0 and w.before == 0 and w.launch == 8
    assert spans.submit_wait_ms(rec.spans, ev) == 0.0


@pytest.mark.parametrize("launches, matched", [
    ([(1110, 1190, 1)], 1),
    ([], 0),                                       # none inside the span
    ([(1110, 1150, 1), (1160, 1190, 2)], 0),       # two inside
    ([(1090, 1190, 1)], 0),                        # starts before the span
])
def test_a_launch_span_matches_one_launch(launches, matched):
    rec = _rec((1000, 1100, 1200, 1300))
    assert spans.waits(rec.spans, _ev([], launches)).matched == matched


def test_card_clock_off_the_hosts_reads_nothing():
    """Work that starts before its launch began: that call's card
    timestamps are off the host's clock and it is not read; where more than
    one call in a hundred is so, the window is not read at all."""
    rec = _rec((10010, 10040, 10050, 10055), (20010, 20040, 20050, 20055))
    ev = _ev([(0, 10000, 1), (10060, 12000, 2), (20000, 21000, 3)],
             [(10041, 10049, 2), (20041, 20049, 3)])
    w = spans.waits(rec.spans, ev)
    assert w.lags == [19, -41] and w.skewed == 1 and not w.aligned
    assert w.read == 1
    assert spans.submit_wait_ms(rec.spans, ev) is None
    assert spans.waits(rec.spans, _ev([], [])).aligned is False


def test_one_skewed_call_in_a_hundred_is_left_out():
    """799 calls each waited 30 ns for the port; one more reads its work
    before its launch: it is left out and the rest read."""
    calls, device, launches = [], [(0, 100, -1)], []
    for k in range(800):
        t = 1000 * (k + 1)
        calls.append((t + 10, t + 40, t + 50, t + 55))
        launches.append((t + 41, t + 49, k))
        start = t + 60 if k != 77 else t + 30
        device.append((start, t + 500, k))
    rec = _rec(*calls)
    w = spans.waits(rec.spans, _ev(device, launches))
    assert w.skewed == 1 and w.floors == [19] * 8
    assert w.aligned and w.read == 799
    assert spans.submit_wait_ms(rec.spans, _ev(device, launches)) == \
        pytest.approx(30e-6 * 799 / 800)


def test_work_without_its_launchs_id_reads_nothing():
    """Where no activity carries a matched launch's correlation id, the
    call's work is not found and the window gives no reading."""
    rec = _rec((10, 20, 30, 40), (5000, 5100, 5200, 5300))
    ev = _ev([(100, 200, 0), (200, 300, 0), (5400, 5500, 0),
              (5500, 5600, 0)], [(21, 29, 7), (5110, 5190, 8)])
    w = spans.waits(rec.spans, ev)
    assert (w.matched, w.found, w.read) == (2, 0, 0) and not w.aligned
    assert spans.submit_wait_ms(rec.spans, ev) is None
    # one of two found is not enough either
    ev = _ev([(100, 200, 7), (5400, 5500, 0)], [(21, 29, 7), (5110, 5190, 8)])
    assert spans.waits(rec.spans, ev).found == 1
    assert spans.submit_wait_ms(rec.spans, ev) is None


def _idle_calls(lag_ns, n=200, late=()):
    """``n`` calls, each launched to a card idle for 40 us, whose work
    starts ``lag_ns`` after its cudaGraphLaunch (the calls in ``late``
    1 ms after it): the host entered each call 20 us before launching."""
    calls, device, launches = [], [], []
    for k in range(n):
        t = 1_000_000 * (k + 1)
        calls.append((t - 20_000, t, t + 10_000, t + 11_000))
        launches.append((t + 2_000, t + 8_000, k))
        w = t + 2_000 + (1_000_000 if k in late else lag_ns)
        device.append((w - 40_000 - 10_000, w - 40_000, -1))
        device.append((w, w + 5_000, k))
    return _rec(*calls), _ev(device, launches)


def test_card_clock_checked_both_ways():
    """Calls that found the card idle start their work one launch's
    latency after their launch: read where that lag is 8 us; where the
    card's timestamps run 600 us late, no work starts before its launch,
    yet the window is not read, nor is one whose launches queue 5 ms ahead
    of the card."""
    rec, ev = _idle_calls(8_000)
    w = spans.waits(rec.spans, ev)
    assert w.floors == [8_000] * 8 and w.aligned
    # idle 40 us before the work: 20 of it the host inside the call before
    # its launch span, 10 before the call, 10 from the launch span's start
    assert (w.wait, w.before, w.launch) == (200 * 20_000, 200 * 10_000,
                                            200 * 10_000)
    assert spans.submit_wait_ms(rec.spans, ev) == pytest.approx(0.020)
    for lag in (600_000, 5_000_000):
        rec, ev = _idle_calls(lag)
        w = spans.waits(rec.spans, ev)
        assert w.skewed == 0 and w.floors == [lag] * 8 and not w.aligned
        assert spans.submit_wait_ms(rec.spans, ev) is None


def test_a_clock_that_drifts_within_the_window_fails():
    """One run of 25 calls whose work reads a millisecond after its launch
    fails the window; one such call in a run is a latency's tail."""
    rec, ev = _idle_calls(8_000, late={50})
    assert spans.waits(rec.spans, ev).aligned
    rec, ev = _idle_calls(8_000, late=set(range(100, 125)))
    w = spans.waits(rec.spans, ev)
    assert w.floors[4] > spans.LATENCY_NS and not w.aligned


def test_setup_roots_overlapping_count_once():
    from intfftk_tpu_torch.runtime.trace import Recording

    rec = Recording()
    b = rec.add("plan.build", 0, 100)
    rec.add("library.load", 10, 90, b)             # inside: not a root
    rec.add("graph.capture", 50, 150)              # overlaps the build
    rec.add("graph.call", 150, 400, call=True)     # no set-up
    rec.add("plan.prepare", 300, 350)
    assert spans.setup_port_s(rec.spans) == pytest.approx(200e-9)
    assert spans.setup_port_s(rec.spans[3:4]) is None


def test_readers_read_ctx_spans():
    rec = _rec((10010, 10040, 10050, 10055))
    ev = _ev([(0, 10000, 1), (10060, 12000, 2)], [(10041, 10049, 2)])
    ctx = run.Context(None, None, None, None)
    readers = _readers("conv64k_t4")
    assert sorted(readers) == ["setup_port_s", "submit_host_ms.small_calls",
                               "submit_wait_ms.small_calls"]
    assert all(r.read(ctx) is None for r in readers.values())  # old context
    ctx.spans = None
    assert all(r.read(ctx) is None for r in readers.values())
    ctx.spans = spans.Readings(setup=rec, s=rec, j=rec, j_events=ev)
    assert readers["submit_wait_ms.small_calls"].read(ctx) == \
        pytest.approx(30e-6)
    assert readers["submit_host_ms.small_calls"].read(ctx) == \
        pytest.approx(35e-6)
    assert readers["setup_port_s"].read(ctx) is None       # no set-up span
    assert [n for n, _ in spans.metric_names(manifest.cell("fft64k_b64"))] \
        == ["submit_host_ms", "submit_wait_ms", "setup_port_s"]


def test_span_tool_on_the_cpu(tiny):
    """With the port's spans: the set-up is read (plans built on the CPU),
    the submission is not (no graph on the CPU)."""
    metrics = spans.measure(tiny("conv64k_t4"), SEED, torch.device("cpu"),
                            tries=1)
    assert list(metrics) == ["setup_port_s"]
    assert metrics["setup_port_s"]["value"] > 0


def test_span_tool_without_the_port_module(tiny, monkeypatch):
    """As a commit whose port has no span module: the import fails, no
    cell is built and the three readings are absent, as they are from a
    context without spans."""
    monkeypatch.setitem(sys.modules, "intfftk_tpu_torch.runtime.trace", None)
    assert spans.port_trace() is None
    cell = tiny("fft64k_b64")
    monkeypatch.setattr(cell.builder, "build", None)
    assert spans.measure(cell, SEED, torch.device("cpu")) == {}
    assert spans.read(cell, None) == {}
