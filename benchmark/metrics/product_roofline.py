"""``product_roofline`` (%): the spectrum product's (P1, ``csrc/product.cu``)
share of its own roofline.  Its bound (the spectrum read and the product
written at their widths, the taps' table once, 12 operations a sample:
``ring.Sizes.work["product"]``) over the device ms per call of
``product_kernel``, selected by name from the trace."""

KERNELS = ("product_kernel",)


def read(ctx):
    seconds = ctx.trace.seconds_where(lambda n: any(k in n for k in KERNELS))
    work = ctx.work.get("product")
    if not seconds or work is None:
        return None
    return 100.0 * work.bound_ms() / (seconds * 1e3 / ctx.calls)
