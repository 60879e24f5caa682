"""``towers.fwd_ms``: device milliseconds a step of everything launched
outside the backward's and the optimizer's ranges (``towers.fwd_ms.json``):
the towers' forward, the loss, the gradient norm and clip."""

from portbench import trace


def read(ctx):
    outside = tuple(ctx.data["outside"])
    total = trace.device_s(ctx.trace)
    if not total:
        return None
    inside = trace.device_s_under(ctx.trace,
                                  lambda n: n.startswith(outside))
    return 1e3 * (total - inside) / ctx.trace_steps
