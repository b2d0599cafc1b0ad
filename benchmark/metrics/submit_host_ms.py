"""``submit_host_ms`` (ms): the port's own host code around the CUDA graph
launch, per call: over window S (``spans.py``: the traffic's
``trace_calls`` calls with the port's recording on and no profiler), the
mean of each ``graph.call`` span less its ``graph.launch``.  Backpressure
from a full launch queue sits inside the launch and is left out."""

from benchmark import spans


def read(ctx):
    readings = getattr(ctx, "spans", None)
    if readings is None or readings.s is None:
        return None
    return spans.submit_host_ms(readings.s.spans)
