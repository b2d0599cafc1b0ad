"""``submit_wait_ms`` (ms): device idle time per call while the host was
inside the port's call, before its launch: over window J (``spans.py``:
the same calls with the port's recording on, under the profiler), each
call's ``graph.launch`` matched to the ``cudaGraphLaunch`` it holds, that
launch's correlation id to the device work it started, and the idle
stretch before that work overlapped with the call's span up to its
launch (``spans.waits``), summed and divided by the matched calls.  None
where the card's clock, as the profiler converts it, fails the check
both ways (``Waits.aligned``): in some run of the window's calls, work
before its launch, or no work within a launch's latency of its launch."""

from benchmark import spans


def read(ctx):
    readings = getattr(ctx, "spans", None)
    if readings is None or readings.j is None:
        return None
    return spans.submit_wait_ms(readings.j.spans, readings.j_events)
