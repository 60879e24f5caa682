"""Video Vision Transformer (``avion_tpu.models.vit``).

- Patchify is one dense product ("fast conv1") over THWC input: the clip
  is cut into [B, T, gh*gw, p*p*C] patch vectors in (p_h, p_w, C) order
  and multiplied by the conv1 weight.  The weight is stored as the
  reference's ``[width, C, p, p]`` conv kernel, so it is permuted to
  (p_h, p_w, C) rows first; flattening it as (C, p_h, p_w) would give
  plausible and wrong embeddings.
- ``input_norm`` (``openai`` / ``imagenet``): a uint8 clip is normalized
  inside the stem, which under ``remat`` is recomputed in the backward, so
  the only copy of the video kept for it is the uint8 batch itself.
- Factorized positional embeddings: spatial (per patch, shared across
  frames) + temporal (per frame, shared across patches).
- A CLS token (``class_embedding + positional_embedding[0]``, added in
  f32), patch dropout when training, ``ln_pre``, the transformer,
  ``ln_post`` on the pooled token.  The projection to the joint space
  lives in ``clip.CLIP`` as ``image_projection``, as in the reference
  state dict.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from avion_tpu_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD,
                                             OPENAI_MEAN, OPENAI_STD,
                                             normalize_video)
from avion_tpu_torch.models.layers import (LayerNorm, Transformer, gelu,
                                           patch_dropout)

INPUT_NORMS = {"none": None, "openai": (OPENAI_MEAN, OPENAI_STD),
               "imagenet": (IMAGENET_MEAN, IMAGENET_STD)}


class PatchEmbed(nn.Module):
    """conv1 as one dense product; ``weight`` is ``[width, C, p, p]``."""

    def __init__(self, width: int, patch_size: int, channels: int = 3):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(width, channels, patch_size, patch_size))
        nn.init.normal_(self.weight, std=(channels * patch_size ** 2) ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, H, W, C] -> [B, T, gh*gw, width]."""
        b, t, h, w, c = x.shape
        p = self.weight.shape[-1]
        gh, gw = h // p, w // p
        x = x.reshape(b, t, gh, p, gw, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        x = x.reshape(b, t, gh * gw, p * p * c)
        kernel = self.weight.permute(0, 2, 3, 1).reshape(-1, p * p * c)
        return F.linear(x, kernel.to(x.dtype))


class VisionTransformer(nn.Module):
    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_frames: int = 16, width: int = 768, layers: int = 12,
                 heads: int = 12, act=gelu,
                 dtype: torch.dtype = torch.bfloat16,
                 patch_dropout: float = 0.0, remat: bool = False,
                 remat_policy: str = "save_attn", input_norm: str = "none"):
        super().__init__()
        if input_norm not in INPUT_NORMS:
            raise ValueError(f"input_norm must be none|openai|imagenet, "
                             f"got {input_norm!r}")
        n = (image_size // patch_size) ** 2
        self.dtype = dtype
        self.patch_dropout_rate = patch_dropout
        self.remat = remat
        self.input_norm = input_norm
        self.conv1 = PatchEmbed(width, patch_size)
        self.class_embedding = nn.Parameter(torch.randn(width) * width ** -0.5)
        self.positional_embedding = nn.Parameter(
            torch.randn(n + 1, width) * width ** -0.5)
        self.temporal_embedding = (
            nn.Parameter(torch.zeros(num_frames, width)) if num_frames > 1
            else None)
        self.ln_pre = LayerNorm(width, dtype)
        self.transformer = Transformer(width, layers, heads, act, dtype,
                                       causal=False, remat=remat,
                                       remat_policy=remat_policy)
        self.ln_post = LayerNorm(width, dtype)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        stats = INPUT_NORMS[self.input_norm]
        if stats is not None and x.dtype == torch.uint8:
            x = normalize_video(x, *stats, dtype=self.dtype)
        return self.conv1(x.to(self.dtype))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, H, W, C], float (already normalized) or, with
        ``input_norm``, uint8.  Returns the ``ln_post``-normalized CLS
        features [B, width].  With ``deterministic=False`` patch dropout
        draws from ``generator``."""
        b, t = x.shape[:2]
        if self.remat and torch.is_grad_enabled():
            x = checkpoint(self._stem, x, use_reentrant=False)
        else:
            x = self._stem(x)
        pos = self.positional_embedding
        x = x + pos[1:].to(self.dtype)[None, None]
        if self.temporal_embedding is not None:
            x = x + self.temporal_embedding[:t].to(self.dtype)[None, :, None]
        x = x.reshape(b, -1, x.shape[-1])
        cls_tok = (self.class_embedding + pos[0]).to(self.dtype)
        x = torch.cat([cls_tok.expand(b, 1, -1), x], dim=1)
        if self.patch_dropout_rate > 0.0 and not deterministic:
            x = patch_dropout(x, self.patch_dropout_rate, generator)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0])
