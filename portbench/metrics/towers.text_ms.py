"""``towers.text_ms``: device milliseconds a step of CLIP's text tower
(``spans.tower_s``, the tower in ``towers.text_ms.json``): its forward
span, and its backward from its mark to the visual tower's, the re-run
forward of remat included."""

from portbench import spans


def read(ctx):
    return spans.tower_ms(ctx, ctx.data["tower"])
