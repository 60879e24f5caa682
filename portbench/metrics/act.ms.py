"""``act.ms``: device milliseconds a step launched under the port's
activation custom ops (``act.ms.json``), QuickGELU's forward (remat's
re-run included) and backward."""

from portbench import trace


def read(ctx):
    names = set(ctx.data["ops"])
    s = trace.device_s_under(ctx.trace, lambda n: n in names)
    return 1e3 * s / ctx.trace_steps if s else None
