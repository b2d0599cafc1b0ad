"""``glue_ms_per_call`` (ms): device ms per call of the kernels that are
torch's, not the port's: the pads, slices, casts and copies around the
port's kernels (in ``parallel/convolve.py``: the windows, the widening
before the product, the cut) and the driver's copies inside a graph.
Selected by name from the trace."""

#: names of torch's own device work, lower case: its kernels, and the
#: copies and fills a graph runs as kernels of the driver's
#: (``memcpy32_post``, ``memcpy128``)
TORCH = ("at::native::", "at::cuda::", "memcpy", "memset")


def read(ctx):
    seconds = ctx.trace.seconds_where(
        lambda n: any(k in n.lower() for k in TORCH))
    if not seconds:
        return None
    return seconds * 1e3 / ctx.calls
