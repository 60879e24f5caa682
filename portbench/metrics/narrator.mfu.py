"""``narrator.mfu``: the LaViLa narrator's train step's FLOPs as the step
does them (``reference/<family>.py``'s ``train_flops``: the frozen
towers' forward, the backward's products for the gradients it takes),
times the steps a second of the run's window, as a share of the card's
bf16 peak, in percent."""

import importlib


def read(ctx):
    family = importlib.import_module(
        f"portbench.reference.{ctx.config['family']}")
    rate = ctx.window_steps / ctx.window_s
    return (100.0 * family.train_flops(ctx.config, ctx.traffic) * rate
            / ctx.data["peak_flops"])
