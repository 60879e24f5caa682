"""``step.mfu``: the train step's model FLOPs (``flops.py``, from the
configuration's widths and the cell's shapes) times the steps a second of
the run's window, as a share of the card's bf16 peak, in percent."""


def read(ctx):
    rate = ctx.window_steps / ctx.window_s
    return 100.0 * ctx.work.model_flops * rate / ctx.data["peak_flops"]
