"""``attn_roofline``: the least time of the attention work a step needs
(``flops.attention_step_least_s``: every attention layer's forward and
backward at the cell's shapes, counted from shapes and never from
launches) over the device time under the attention ops (``attn.ms``), in
percent."""

from portbench import flops, trace


def read(ctx):
    names = set(ctx.data["ops"])
    s = trace.device_s_under(ctx.trace, lambda n: n in names)
    if not s:
        return None
    least = flops.attention_step_least_s(ctx.work.attention)
    return 100.0 * least * ctx.trace_steps / s
