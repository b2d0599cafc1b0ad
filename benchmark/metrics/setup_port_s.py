"""``setup_port_s`` (s): the set-up's seconds spent in the port's own
set-up: the union of the root ``graph.capture``, ``plan.build``,
``plan.prepare`` and ``library.load`` spans recorded over the cell's
build (``spans.py``)."""

from benchmark import spans


def read(ctx):
    readings = getattr(ctx, "spans", None)
    if readings is None or readings.setup is None:
        return None
    return spans.setup_port_s(readings.setup.spans)
