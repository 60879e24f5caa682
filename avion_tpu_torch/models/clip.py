"""CLIP dual encoder (``avion_tpu.models.clip``): the two towers, the
projections to the joint space, L2-normalized embeddings (in f32) and the
learnable ``logit_scale``.  The training forward returns
``{"image_embed", "text_embed", "logit_scale"}`` with ``exp(logit_scale)``,
whose gradient is blocked under ``freeze_temperature``; the clamp of the
scale lives in the train step."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from avion_tpu_torch.models.layers import (LayerNorm, gelu, lecun_normal_,
                                           quick_gelu)
from avion_tpu_torch.models.text import TextTransformer
from avion_tpu_torch.models.vit import PatchEmbed, VisionTransformer


class CLIP(nn.Module):
    def __init__(self, embed_dim: int = 512, image_size: int = 224,
                 patch_size: int = 16, num_frames: int = 16,
                 vision_width: int = 768, vision_layers: int = 12,
                 vision_heads: int = 12, context_length: int = 77,
                 vocab_size: int = 49408, text_width: int = 512,
                 text_heads: int = 8, text_layers: int = 12,
                 use_quick_gelu: bool = True, temperature_init: float = 0.07,
                 dtype: torch.dtype = torch.bfloat16,
                 patch_dropout: float = 0.0, remat: bool = False,
                 remat_policy: str = "save_attn", input_norm: str = "none",
                 freeze_temperature: bool = False):
        super().__init__()
        act = quick_gelu if use_quick_gelu else gelu
        self.dtype = dtype
        self.image_size = image_size
        self.num_frames = num_frames
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.temperature_init = temperature_init
        self.freeze_temperature = freeze_temperature
        self.input_norm = input_norm
        self.visual = VisionTransformer(
            image_size, patch_size, num_frames, vision_width, vision_layers,
            vision_heads, act, dtype, patch_dropout, remat, remat_policy,
            input_norm)
        self.textual = TextTransformer(context_length, vocab_size, text_width,
                                       text_heads, text_layers, act, dtype,
                                       remat, remat_policy)
        self.image_projection = nn.Parameter(
            torch.randn(vision_width, embed_dim) * vision_width ** -0.5)
        self.text_projection = nn.Parameter(
            torch.randn(text_width, embed_dim) * text_width ** -0.5)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1.0 / temperature_init)))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "CLIP":
        """Draw every parameter from ``generator`` as the flax CLIP's
        initializers do: dense and patchify kernels lecun-normal (truncated)
        with zero biases, LayerNorm ones and zeros, the visual embeddings
        and both projections normal(width ** -0.5), the token embedding
        normal(text_width ** -0.5), the text positions normal(0.01), the
        temporal table zeros and ``logit_scale`` log(1 / temperature_init).
        The parameters must be on ``generator``'s device."""
        def normal(p, std):
            p.normal_(0.0, std, generator=generator)

        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
            elif isinstance(m, PatchEmbed):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal(m.weight, m.embedding_dim ** -0.5)
        v, t = self.visual, self.textual
        vw = v.class_embedding.shape[0]
        normal(v.class_embedding, vw ** -0.5)
        normal(v.positional_embedding, vw ** -0.5)
        if v.temporal_embedding is not None:
            v.temporal_embedding.zero_()
        normal(t.positional_embedding, 0.01)
        normal(self.image_projection, vw ** -0.5)
        normal(self.text_projection, self.text_projection.shape[0] ** -0.5)
        self.logit_scale.fill_(math.log(1.0 / self.temperature_init))
        return self

    def encode_image(self, image: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """[B, T, H, W, C] video -> [B, embed_dim] unit f32."""
        pooled = self.visual(image, deterministic, generator)
        return _l2norm(pooled @ self.image_projection.to(pooled.dtype))

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """[B, L] token ids -> [B, embed_dim] unit f32."""
        pooled = self.textual(text)
        return _l2norm(pooled @ self.text_projection.to(pooled.dtype))

    def forward(self, image: torch.Tensor, text: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        scale = self.logit_scale.exp()
        if self.freeze_temperature:
            # keep the (possibly loaded) value, block its gradient
            scale = scale.detach()
        return {"image_embed": self.encode_image(image, deterministic,
                                                 generator),
                "text_embed": self.encode_text(text),
                "logit_scale": scale}


def _l2norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)
