"""Input normalization (``avion_tpu.data.transforms.normalize_video``).

The port keeps its own copy of the channel statistics: the JAX module
imports the decode library at module level.
"""

from __future__ import annotations

import torch

# OpenAI CLIP channel statistics
OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
# ImageNet channel statistics
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_video(video: torch.Tensor, mean=OPENAI_MEAN, std=OPENAI_STD,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 [..., 3] RGB -> ``((x / 255) - mean) / std`` in f32, then cast
    to ``dtype``; runs on the tensor's device."""
    x = video.to(torch.float32) / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=video.device)
    std = torch.tensor(std, dtype=torch.float32, device=video.device)
    return ((x - mean) / std).to(dtype)
