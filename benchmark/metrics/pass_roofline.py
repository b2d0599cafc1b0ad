"""``pass_roofline`` (%): the factor pass's share of its roofline.  The
frozen count's bound for the call's transforms (``ring.Sizes.work
["pass"]``) over the device ms per call of the factor-pass kernels, the
split form's ``fused_pass_kernel`` and the whole form's
``fused_whole_kernel``, selected by name from the trace."""

KERNELS = ("fused_pass_kernel", "fused_whole_kernel")


def read(ctx):
    seconds = ctx.trace.seconds_where(lambda n: any(k in n for k in KERNELS))
    work = ctx.work.get("pass")
    if not seconds or work is None:
        return None
    return 100.0 * work.bound_ms() / (seconds * 1e3 / ctx.calls)
