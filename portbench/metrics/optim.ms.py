"""``optim.ms``: device milliseconds a step of what the optimizer's update
launched: kernels inside torch's own ``Optimizer.step#<class>.step`` range
(the ranges named in ``optim.ms.json``)."""

from portbench import trace


def read(ctx):
    prefixes = tuple(ctx.data["ranges"])
    s = trace.device_s_under(ctx.trace, lambda n: n.startswith(prefixes))
    return 1e3 * s / ctx.trace_steps if s else None
