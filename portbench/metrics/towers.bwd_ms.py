"""``towers.bwd_ms``: device milliseconds a step launched inside the
autograd engine's ``evaluate_function`` ops (the backward, with the
rematerialized forward it re-runs)."""

from portbench import trace


def read(ctx):
    prefixes = tuple(ctx.data["ranges"])
    s = trace.device_s_under(ctx.trace, lambda n: n.startswith(prefixes))
    return 1e3 * s / ctx.trace_steps if s else None
