"""Augmentation parameter samplers and input normalization
(``avion_tpu.data.transforms``).

The samplers produce a normalized ``CropSpec`` per clip on the host
(cheap scalar RNG, the same draws as the JAX package's); the decoder does
the pixel work, or, on the device-crop path, ``ops/fused_input``.
``normalize_video`` runs on the batch's device.  Tube masks for VideoMAE
are drawn on the host (``tube_mask``), or on the device from a generator
(``tube_mask_device``).  ``torch`` is imported where a tensor is made, so loader
workers, which import this module, do not load it.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:
    import torch

from avion_tpu_torch.data.video_reader import CropSpec

# OpenAI CLIP channel statistics
OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
# ImageNet channel statistics
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# host-side crop parameter samplers
# ---------------------------------------------------------------------------


def sample_rrc(
    rng: np.random.RandomState,
    scale: Tuple[float, float] = (0.5, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
    hflip_prob: float = 0.0,
    vflip_prob: float = 0.0,
) -> CropSpec:
    """RandomResizedCrop params in normalized coords (torchvision
    semantics; the reference passes scale_min/scale_max to decord's fused
    RRC)."""
    for _ in range(10):
        area = rng.uniform(scale[0], scale[1])
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        w = math.sqrt(area * aspect)
        h = math.sqrt(area / aspect)
        if w <= 1.0 and h <= 1.0:
            x = rng.uniform(0, 1.0 - w)
            y = rng.uniform(0, 1.0 - h)
            return CropSpec(
                x, y, w, h,
                hflip=bool(rng.rand() < hflip_prob),
                vflip=bool(rng.rand() < vflip_prob),
            )
    side = min(1.0, math.sqrt(scale[1]))
    return CropSpec((1 - side) / 2, (1 - side) / 2, side, side,
                    hflip=bool(rng.rand() < hflip_prob))


def center_crop_spec(src_w: int, src_h: int) -> CropSpec:
    """Largest centered square (fused center-crop path)."""
    side = min(src_w, src_h)
    return CropSpec(
        x=(src_w - side) / 2 / src_w,
        y=(src_h - side) / 2 / src_h,
        w=side / src_w,
        h=side / src_h,
    )


def sample_msc(
    rng: np.random.RandomState,
    src_w: int,
    src_h: int,
    input_size: int = 224,
    scales: Sequence[float] = (1.0, 0.875, 0.75, 0.66),
    max_distort: int = 1,
    more_fix_crop: bool = True,
    hflip_prob: float = 0.0,
) -> CropSpec:
    """GroupMultiScaleCrop parameters: crop size from a scale grid of the
    short side, offset from the 13 fixed positions."""
    base = min(src_w, src_h)
    sizes = [int(base * s) for s in scales]
    snap = lambda v: input_size if abs(v - input_size) < 3 else v
    crop_hs = [snap(v) for v in sizes]
    crop_ws = [snap(v) for v in sizes]
    pairs = [
        (w, h)
        for i, h in enumerate(crop_hs)
        for j, w in enumerate(crop_ws)
        if abs(i - j) <= max_distort
    ]
    cw, ch = pairs[rng.randint(len(pairs))]
    w_step = (src_w - cw) // 4
    h_step = (src_h - ch) // 4
    offsets = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
               (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step)]
    if more_fix_crop:
        offsets += [
            (0, 2 * h_step), (4 * w_step, 2 * h_step),
            (2 * w_step, 4 * h_step), (2 * w_step, 0),
            (w_step, h_step), (3 * w_step, h_step),
            (w_step, 3 * h_step), (3 * w_step, 3 * h_step),
        ]
    ox, oy = offsets[rng.randint(len(offsets))]
    return CropSpec(
        ox / src_w, oy / src_h, cw / src_w, ch / src_h,
        hflip=bool(rng.rand() < hflip_prob),
    )


def spatial_three_crops(src_w: int, src_h: int) -> List[CropSpec]:
    """3-crop eval along the long axis (``SpatialCrop``)."""
    side = min(src_w, src_h)
    if src_w >= src_h:
        xs = [0, (src_w - side) // 2, src_w - side]
        return [CropSpec(x / src_w, 0.0, side / src_w, 1.0) for x in xs]
    ys = [0, (src_h - side) // 2, src_h - side]
    return [CropSpec(0.0, y / src_h, 1.0, side / src_h) for y in ys]


def temporal_clip_offsets(
    num_frames_total: int, clip_span: int, num_views: int
) -> List[int]:
    """AdaptiveTemporalCrop start offsets."""
    if num_views <= 1:
        return [max(0, (num_frames_total - clip_span) // 2)]
    max_start = max(0, num_frames_total - clip_span)
    return [int(round(i * max_start / (num_views - 1))) for i in range(num_views)]


# ---------------------------------------------------------------------------
# tube masking
# ---------------------------------------------------------------------------


def tube_mask(
    rng: np.random.RandomState,
    frames: int,
    height: int,
    width: int,
    mask_ratio: float,
) -> np.ndarray:
    """Per-sample tube mask [frames*height*width] bool (True = masked);
    the same spatial pattern repeats across frames
    (``TubeMaskingGenerator``)."""
    per_frame = height * width
    n_mask = int(mask_ratio * per_frame)
    frame_mask = np.zeros(per_frame, bool)
    frame_mask[rng.choice(per_frame, n_mask, replace=False)] = True
    return np.tile(frame_mask, frames)


def tube_mask_batch(rng, batch, frames, height, width, mask_ratio):
    """Batched masks [B, frames*height*width]
    (``TubeMaskingGeneratorGPU``)."""
    per_frame = height * width
    n_mask = int(mask_ratio * per_frame)
    noise = rng.rand(batch, per_frame)
    idx = np.argsort(noise, axis=-1)[:, :n_mask]
    m = np.zeros((batch, per_frame), bool)
    np.put_along_axis(m, idx, True, axis=-1)
    return np.tile(m, (1, frames))


def tube_mask_device(generator, batch: int, frames: int, height: int,
                     width: int, mask_ratio: float, device=None):
    """Tube masks [B, frames*height*width] bool drawn on ``device`` from
    ``generator`` (``avion_tpu.data.transforms.tube_mask_device``): each
    sample hides ``int(mask_ratio * height * width)`` positions of a frame,
    the same ones in every frame."""
    import torch

    per_frame = height * width
    n_mask = int(mask_ratio * per_frame)
    noise = torch.rand(batch, per_frame, generator=generator, device=device)
    ranks = noise.argsort(dim=-1).argsort(dim=-1)
    return (ranks < n_mask).repeat(1, frames)


# ---------------------------------------------------------------------------
# device-side normalization
# ---------------------------------------------------------------------------


def normalize_video(video: torch.Tensor, mean=OPENAI_MEAN, std=OPENAI_STD,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """uint8 [..., 3] RGB -> ``((x / 255) - mean) / std`` in f32, then cast
    to ``dtype`` (default bf16); runs on the tensor's device."""
    import torch

    dtype = dtype or torch.bfloat16
    x = video.to(torch.float32) / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=video.device)
    std = torch.tensor(std, dtype=torch.float32, device=video.device)
    return ((x - mean) / std).to(dtype)
