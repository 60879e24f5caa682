"""Analytic model-FLOPs helpers (``avion_tpu.core.flops``), with the
H100's peak in place of the TPU's.

MFU convention: 3x forward matmul FLOPs (fwd + 2x bwd), remat recompute
excluded — the standard accounting, so numbers compare across
frameworks and hardware.
"""

from __future__ import annotations

H100_PEAK_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet


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
