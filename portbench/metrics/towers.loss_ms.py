"""``towers.loss_ms``: device milliseconds a step launched inside the
step's ``avion.step.loss`` span (``towers.loss_ms.json``): the loss's
forward, with a MoE tower's router terms and the metrics' group mean."""

from portbench import spans


def read(ctx):
    return spans.span_ms(ctx, ctx.data["span"])
