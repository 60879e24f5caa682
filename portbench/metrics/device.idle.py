"""``device.idle``: the share of the window's time in which nothing ran on
the card, in percent: 1 - (the card's busy seconds a traced step: the
union of its kernels, copies and memsets) / (the window's seconds a
step).  The profiler's host tracing slows the traced steps' launches, so
their own wall time would count idle that the window does not have."""

from portbench import trace


def read(ctx):
    if not ctx.trace.device:
        return None
    busy = trace.busy_s(ctx.trace) / ctx.trace_steps
    return 100.0 * (1.0 - busy * ctx.window_steps / ctx.window_s)
