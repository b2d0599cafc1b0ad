"""``port_host_ms`` (ms): the port's own host code around the CUDA graph
launch, per call, in the traced window.  The port opens a profiler range
``graph.call`` around each call of a captured graph
(``CapturedCall.__call__``) and ``graph.launch`` around its replay alone;
each ``graph.call`` less the one ``graph.launch`` it holds, averaged over
the calls that hold one, read from the trace's host ranges.  The key, the
copies into the static inputs where one is made, and the counters.

None where the trace holds no such call: a program that opens no such
range."""

import bisect

CALL, LAUNCH = "graph.call", "graph.launch"


def own_ns(host) -> list:
    """Each ``graph.call`` range's ns less those of the ``graph.launch``
    range it holds, for the calls that hold exactly one."""
    calls = sorted((s for s in host if s.name == CALL),
                   key=lambda s: s.start_ns)
    starts = [c.start_ns for c in calls]
    held = {}
    for la in host:
        if la.name != LAUNCH:
            continue
        k = bisect.bisect_right(starts, la.start_ns) - 1
        if k >= 0 and la.end_ns <= calls[k].end_ns:
            held.setdefault(k, []).append(la)
    return [(calls[k].end_ns - calls[k].start_ns) - (la.end_ns - la.start_ns)
            for k, (la, *more) in sorted(held.items()) if not more]


def read(ctx):
    own = own_ns(ctx.trace.host)
    if not own:
        return None
    return sum(own) / len(own) / 1e6
