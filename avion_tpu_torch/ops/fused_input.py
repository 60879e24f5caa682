"""Device-side crop + resize + flip + normalize
(``avion_tpu.ops.fused_input``).

Bilinear resampling is a linear map, so the per-clip crop and resize is
two batched products with interpolation matrices,

    out[b] = R[b] @ img[b] @ C[b]^T

where R [out_h, H] and C [out_w, W] carry the bilinear weights of clip
b's crop window (hflip = C with its rows reversed).  The JAX package
writes this as XLA einsums, not a Pallas kernel; here it is two
``torch.einsum`` products in f32 on the batch's device.  They stay f32:
nothing in the port enables TF32, which would put ~1e-3 relative error on
0-255 pixel values.

Use: the host decoder returns whole frames at a fixed size and the device
does the per-clip augmentation (``data.fused_decode_crop=false``), the
split for hosts whose cores are the bottleneck.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from avion_tpu_torch.data.transforms import OPENAI_MEAN, OPENAI_STD


def _interp_matrix(starts: torch.Tensor, sizes: torch.Tensor, src_len: int,
                   out_len: int) -> torch.Tensor:
    """Batched bilinear interpolation matrices [B, out_len, src_len]
    resampling ``out_len`` points from each [start, start+size) window
    (align_corners=False, as cv2.INTER_LINEAR)."""
    scale = sizes / out_len                                        # [B]
    grid = torch.arange(out_len, device=starts.device, dtype=torch.float32)
    pos = (grid[None, :] + 0.5) * scale[:, None] + starts[:, None] - 0.5
    pos = pos.clamp(0.0, src_len - 1.0)                            # [B, out]
    lo = pos.floor()
    frac = pos - lo
    lo = lo.long()
    hi = (lo + 1).clamp(max=src_len - 1)
    src = torch.arange(src_len, device=starts.device)[None, None, :]
    w_lo = (src == lo[:, :, None]) * (1.0 - frac[:, :, None])
    w_hi = (src == hi[:, :, None]) * frac[:, :, None]
    return (w_lo + w_hi).to(torch.float32)                         # [B, out, S]


def crop_resize_flip_normalize(
    video: torch.Tensor,                  # [B, T, H, W, C] uint8
    crops: torch.Tensor,                  # [B, 4] normalized (x, y, w, h)
    hflip: Optional[torch.Tensor] = None,  # [B] bool
    *,
    out_size: Tuple[int, int] = (224, 224),
    mean=OPENAI_MEAN,
    std=OPENAI_STD,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Returns [B, T, out_h, out_w, C] normalized ``dtype`` frames on
    ``video``'s device.  At B 256, T 4, 256 x 256 input and 224 output the
    f32 copy of the input is 805 MB and the intermediate 705 MB."""
    b, t, h, w, c = video.shape
    out_w, out_h = out_size
    crops = crops.to(device=video.device, dtype=torch.float32)
    x, y, cw, ch = crops[:, 0], crops[:, 1], crops[:, 2], crops[:, 3]
    rows = _interp_matrix(y * h, ch * h, h, out_h)                 # [B, oh, H]
    cols = _interp_matrix(x * w, cw * w, w, out_w)                 # [B, ow, W]
    if hflip is not None:
        flip = hflip.to(device=video.device, dtype=torch.bool)
        cols = torch.where(flip[:, None, None], cols.flip(1), cols)

    xf = video.to(torch.float32)
    # rows contract H, cols contract W: two batched products
    tmp = torch.einsum("bih,bthwc->btiwc", rows, xf)
    out = torch.einsum("bjw,btiwc->btijc", cols, tmp)
    mean = torch.tensor(mean, dtype=torch.float32, device=video.device) * 255.0
    std = torch.tensor(std, dtype=torch.float32, device=video.device) * 255.0
    return ((out - mean) / std).to(dtype)


def batch_crop_array(crop_specs: Sequence) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Stack host ``CropSpec`` objects into the [B, 4] f32 crop tensor and
    the [B] bool flip tensor (on the CPU)."""
    arr = np.array([[c.x, c.y, c.w, c.h] for c in crop_specs], np.float32)
    flips = np.array([c.hflip for c in crop_specs], bool)
    return torch.from_numpy(arr), torch.from_numpy(flips)
