"""``step.syncs``: host ops a traced step that wait for the card
(``spans.syncs``): each read of a device scalar named in
``step.syncs.json``'s ``reads``, and each runtime synchronization in its
``waits`` outside such a read, inside ``avion.step``."""

from portbench import spans


def read(ctx):
    if not spans.found(ctx.trace):
        return None
    return spans.syncs(ctx.trace, ctx.data["reads"], ctx.data["waits"])
