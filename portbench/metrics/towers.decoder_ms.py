"""``towers.decoder_ms``: device milliseconds a step of VideoMAE's decoder,
from its tokens through the head (``spans.tower_s``, the tower in
``towers.decoder_ms.json``): its forward span, and its backward from its
mark to the encoder's, the re-run forward of remat included."""

from portbench import spans


def read(ctx):
    return spans.tower_ms(ctx, ctx.data["tower"])
