"""``narrator.divided_attn_roofline``: the least time of a step's divided
attention (``reference/<family>.py``'s ``divided_attention_least_s``: each
layer's space and time sequences, forward only, their q, k, v and out
moved once in bf16, or their products at the bf16 peak) over the device
time inside its spans (``narrator.divided_attn_ms``, the glue counted
against it), in percent."""

import importlib

from portbench import spans


def read(ctx):
    names = ctx.data["spans"]
    if not spans.found(ctx.trace) or not any(
            spans.named(ctx.trace, n) for n in names):
        return None
    s = sum(spans.device_s_in(ctx.trace, n) for n in names)
    if not s:
        return None
    family = importlib.import_module(
        f"portbench.reference.{ctx.config['family']}")
    least = family.divided_attention_least_s(ctx.config, ctx.traffic)
    return 100.0 * least * ctx.trace_steps / s
