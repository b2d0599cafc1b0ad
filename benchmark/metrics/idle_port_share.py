"""``idle_port_share`` (%): the share of the traced window in which
nothing ran on the device and the host was inside the port's call, a
``graph.call`` range of the profiler's trace (``CapturedCall.__call__``,
its launch included).  The window is ``idle_share``'s, from the first
device activity's start to the last one's end; every gap between device
activities counts, each for the part of it that some ``graph.call``
covers: the attribution of the trace's ``idle_gaps`` applied to the whole
window.  ``idle_share`` less this share is the idle that the harness's
loop between calls and the card's own switch between graphs own.

None where the trace holds no ``graph.call``: a program that opens no
such range."""

from benchmark.trace import Trace

CALL = "graph.call"


def read(ctx):
    # the calls' ranges, overlaps merged, by the trace's own merge
    calls = Trace(tuple(s for s in ctx.trace.host if s.name == CALL),
                  ())._merged()
    window = ctx.trace.window_s
    if not calls or not window:
        return None
    busy = ctx.trace._merged()
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    covered, k = 0, 0
    for a, b in gaps:                   # both lists sorted and disjoint
        while k < len(calls) and calls[k][1] <= a:
            k += 1
        j = k
        while j < len(calls) and calls[j][0] < b:
            covered += min(b, calls[j][1]) - max(a, calls[j][0])
            j += 1
    return 100.0 * covered / 1e9 / window
