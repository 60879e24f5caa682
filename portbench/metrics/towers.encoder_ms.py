"""``towers.encoder_ms``: device milliseconds a step of VideoMAE's encoder,
from the mask's split through ``encoder_to_decoder`` (``spans.tower_s``,
the tower in ``towers.encoder_ms.json``): its forward span, and its
backward from its mark to the end of the step's backward, the re-run
forward of remat and the patch embedding's weight gradient included."""

from portbench import spans


def read(ctx):
    return spans.tower_ms(ctx, ctx.data["tower"])
