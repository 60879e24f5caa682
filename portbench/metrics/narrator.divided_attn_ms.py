"""``narrator.divided_attn_ms``: device milliseconds a step launched inside
the divided attention's spans (``narrator.divided_attn_ms.json``), each
mode's attention between its qkv and output projections: the regrouping,
the CLS query's products and the kernels."""

from portbench import spans


def device_s(ctx):
    """Device seconds of the traced steps inside the spans, or None."""
    names = ctx.data["spans"]
    if not spans.found(ctx.trace) or not any(
            spans.named(ctx.trace, n) for n in names):
        return None
    return sum(spans.device_s_in(ctx.trace, n) for n in names)


def read(ctx):
    s = device_s(ctx)
    return None if s is None else 1e3 * s / ctx.trace_steps
