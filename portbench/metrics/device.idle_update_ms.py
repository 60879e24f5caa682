"""``device.idle_update_ms``: milliseconds a step in which the card sat
idle while the step was in its update span, the host's read of the loss
included (``spans.window_idle_ms``, the phase in
``device.idle_update_ms.json``), scaled to the window's idle as
``device.idle`` reads it."""

from portbench import spans


def read(ctx):
    return spans.window_idle_ms(ctx, ctx.data["phase"])
