"""``device.idle_bwd_ms``: milliseconds a step in which the card sat idle
while the step was in its backward span (``spans.window_idle_ms``, the
phase in ``device.idle_bwd_ms.json``), scaled to the window's idle as
``device.idle`` reads it."""

from portbench import spans


def read(ctx):
    return spans.window_idle_ms(ctx, ctx.data["phase"])
