"""Analytic model-FLOPs helpers (``avion_tpu.core.flops``), with the
H100's peak in place of the TPU's, and the attention kernels' least time
on the card (:func:`attention_bound`, as ``chip_smoke.bound``).

MFU convention: 3x forward matmul FLOPs (fwd + 2x bwd), remat recompute
excluded — the standard accounting, so numbers compare across
frameworks and hardware.
"""

from __future__ import annotations

H100_PEAK_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, H100 SXM data sheet


def clip_fwd_flops(clip_len=4, image=224, patch=16, vw=768, vl=12,
                   tw=512, tl=12, ctx=77) -> float:
    """Forward matmul FLOPs per clip for a CLIP dual encoder
    (vision tower + text tower; attention counted at 4*s^2*w)."""
    s = clip_len * (image // patch) ** 2 + 1
    patchify = 2 * (s - 1) * (patch * patch * 3) * vw
    vis_block = 2 * s * vw * vw * 12 + 4 * s * s * vw
    txt_block = 2 * ctx * tw * tw * 12 + 4 * ctx * ctx * tw
    return patchify + vl * vis_block + tl * txt_block


def mfu(clips_per_sec: float, fwd_flops_per_clip: float,
        peak: float = H100_PEAK_FLOPS) -> float:
    return clips_per_sec * 3 * fwd_flops_per_clip / peak


def attn_flops(b, s, h, d, causal, products) -> float:
    """``products`` S x S x D products, 2 flops a multiply-add, halved when
    causal."""
    return 2 * products * b * h * s * s * d / (2 if causal else 1)


def attention_bound(b, s, h, d, causal, products=2, tensors=4, rows=0):
    """(least ms, ``"operations"`` or ``"bytes"``): ``products`` S x S x D
    bf16 products at :data:`H100_PEAK_FLOPS` against ``tensors`` [B, S,
    H*D] bf16 tensors and ``rows`` [B, H, S] f32 rows, each read or
    written once, at :data:`H100_BYTES_PER_S`."""
    flops = attn_flops(b, s, h, d, causal, products)
    nbytes = tensors * b * s * h * d * 2 + rows * b * h * s * 4
    t_ops, t_bytes = flops / H100_PEAK_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")
