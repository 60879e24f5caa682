"""``optim.update_ms``: device milliseconds a step launched inside the
step's ``avion.step.update`` span (``optim.update_ms.json``): the gradient
norm and clip, AdamW (``optim.ms`` alone), the logit-scale clamp, the
EMA."""

from portbench import spans


def read(ctx):
    return spans.span_ms(ctx, ctx.data["span"])
