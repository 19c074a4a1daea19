"""The share of the traced window in which no operation ran on the
device, %: 100 x (1 - the union of the kernel, copy and memset intervals
over the window)."""


def read(ctx):
    span = (ctx.trace.t1 - ctx.trace.t0) / 1e6
    if span <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / span)
