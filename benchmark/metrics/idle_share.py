"""``idle_share`` (%): the share of the traced window in which nothing ran
on the device: 1 - busy / window, from the first device activity's start
to the last one's end."""


def read(ctx):
    window = ctx.trace.window_s
    if not window:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / window)
