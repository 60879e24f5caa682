"""CLIP dual encoder, inference only (``avion_tpu.models.clip``): the two
towers, the projections to the joint space, L2-normalized embeddings
(in f32) and the learnable ``logit_scale``."""

from __future__ import annotations

import math

import torch
from torch import nn

from avion_tpu_torch.models.layers import gelu, quick_gelu
from avion_tpu_torch.models.text import TextTransformer
from avion_tpu_torch.models.vit import VisionTransformer


class CLIP(nn.Module):
    def __init__(self, embed_dim: int = 512, image_size: int = 224,
                 patch_size: int = 16, num_frames: int = 16,
                 vision_width: int = 768, vision_layers: int = 12,
                 vision_heads: int = 12, context_length: int = 77,
                 vocab_size: int = 49408, text_width: int = 512,
                 text_heads: int = 8, text_layers: int = 12,
                 use_quick_gelu: bool = True, temperature_init: float = 0.07,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        act = quick_gelu if use_quick_gelu else gelu
        self.dtype = dtype
        self.image_size = image_size
        self.num_frames = num_frames
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.visual = VisionTransformer(
            image_size, patch_size, num_frames, vision_width, vision_layers,
            vision_heads, act, dtype)
        self.textual = TextTransformer(context_length, vocab_size, text_width,
                                       text_heads, text_layers, act, dtype)
        self.image_projection = nn.Parameter(
            torch.randn(vision_width, embed_dim) * vision_width ** -0.5)
        self.text_projection = nn.Parameter(
            torch.randn(text_width, embed_dim) * text_width ** -0.5)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1.0 / temperature_init)))

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, C] normalized video -> [B, embed_dim] unit f32."""
        pooled = self.visual(image)
        return _l2norm(pooled @ self.image_projection.to(pooled.dtype))

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """[B, L] token ids -> [B, embed_dim] unit f32."""
        pooled = self.textual(text)
        return _l2norm(pooled @ self.text_projection.to(pooled.dtype))

    def forward(self, image: torch.Tensor, text: torch.Tensor) -> dict:
        return {"image_embed": self.encode_image(image),
                "text_embed": self.encode_text(text),
                "logit_scale": self.logit_scale.exp()}


def _l2norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)
