"""``launches_per_call`` (launches): the port's own launch counters
(``fused_pass.launches``, ``fused_whole.launches``,
``spectrum_product.launches``, ``device_circle_table.launches``), summed
over the traced window and divided by its calls.  A captured call counts
on each replay the launches of one eager call."""


def read(ctx):
    total = sum(ctx.launches.values())
    if not total:
        return None
    return total / ctx.calls
