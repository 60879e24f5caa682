"""CLIP dual encoder and the classifier head (``avion_tpu.models.clip``).

:class:`CLIP`: the two towers, the projections to the joint space,
L2-normalized embeddings (in f32) and the learnable ``logit_scale``.  The
training forward returns ``{"image_embed", "text_embed", "logit_scale"}``
with ``exp(logit_scale)``, whose gradient is blocked under
``freeze_temperature``; the clamp of the scale lives in the train step.
With ``use_logit_bias`` (SigLIP's head) it also returns the learnable f32
scalar ``logit_bias``, initialised to ``logit_bias_init``.
With pooling ``none`` the visual tower's tokens are normalized without the
projection, as the JAX tower returns them before its ``proj``.  Under a
profiler each tower's forward is the span ``avion.tower.visual`` /
``avion.tower.text``, and its output carries the backward mark
``avion.tower.<tower>.bwd`` (``core.profiling``).

:class:`VideoClassifier`: dropout and a linear f32 ``fc_cls`` on the
visual tower's width features (the reference's ``model_clip.py:15-38``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avion_tpu_torch.core.profiling import backward_mark, span
from avion_tpu_torch.models.layers import (LayerNorm, LayerScale, gelu,
                                           lecun_normal_, quick_gelu)
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
                 freeze_temperature: bool = False, pooling: str = "cls",
                 use_logit_bias: bool = False,
                 logit_bias_init: float = -10.0,
                 sequence_parallel: bool = False, moe_experts: int = 0,
                 pipeline: bool = False, pipeline_microbatches: int = 8):
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
            input_norm, pooling, sequence_parallel=sequence_parallel,
            moe_experts=moe_experts, pipeline=pipeline,
            pipeline_microbatches=pipeline_microbatches)
        self.textual = TextTransformer(context_length, vocab_size, text_width,
                                       text_heads, text_layers, act, dtype,
                                       remat, remat_policy)
        self.image_projection = nn.Parameter(
            torch.randn(vision_width, embed_dim) * vision_width ** -0.5)
        self.text_projection = nn.Parameter(
            torch.randn(text_width, embed_dim) * text_width ** -0.5)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1.0 / temperature_init)))
        self.logit_bias_init = logit_bias_init
        self.logit_bias = (nn.Parameter(torch.tensor(float(logit_bias_init)))
                           if use_logit_bias else None)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "CLIP":
        """Draw every parameter from ``generator`` as the flax CLIP's
        initializers do: dense and patchify kernels lecun-normal (truncated)
        with zero biases, LayerNorm ones and zeros, the visual embeddings
        and both projections normal(width ** -0.5), the token embedding
        normal(text_width ** -0.5), the text positions normal(0.01), the
        temporal table zeros, LayerScale's ``gamma`` its initial value,
        ``logit_scale`` log(1 / temperature_init) and ``logit_bias``
        ``logit_bias_init``.  The parameters must be on ``generator``'s
        device."""
        _init_modules_(self, generator)
        _init_visual_tables_(self.visual, generator)
        vw = self.visual.width
        self.textual.positional_embedding.normal_(0.0, 0.01,
                                                  generator=generator)
        self.image_projection.normal_(0.0, vw ** -0.5, generator=generator)
        self.text_projection.normal_(
            0.0, self.text_projection.shape[0] ** -0.5, generator=generator)
        self.logit_scale.fill_(math.log(1.0 / self.temperature_init))
        if self.logit_bias is not None:
            self.logit_bias.fill_(self.logit_bias_init)
        return self

    def encode_image(self, image: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """[B, T, H, W, C] video -> [B, embed_dim] unit f32 (pooling
        ``none``: [B, S, width], unprojected)."""
        with span("avion.tower.visual"):
            pooled = self.visual(image, deterministic, generator)
            if self.visual.pooling != "none":
                pooled = pooled @ self.image_projection.to(pooled.dtype)
            return backward_mark(_l2norm(pooled), "avion.tower.visual.bwd")

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """[B, L] token ids -> [B, embed_dim] unit f32."""
        with span("avion.tower.text"):
            pooled = self.textual(text)
            return backward_mark(
                _l2norm(pooled @ self.text_projection.to(pooled.dtype)),
                "avion.tower.text.bwd")

    def forward(self, image: torch.Tensor, text: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        scale = self.logit_scale.exp()
        if self.freeze_temperature:
            # keep the (possibly loaded) value, block its gradient
            scale = scale.detach()
        out = {"image_embed": self.encode_image(image, deterministic,
                                                generator),
               "text_embed": self.encode_text(text), "logit_scale": scale}
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out


def _init_modules_(module: nn.Module,
                   generator: Optional[torch.Generator]) -> None:
    """Dense and patchify kernels lecun-normal (truncated) with zero
    biases, LayerNorm ones and zeros, LayerScale its initial value, token
    embeddings normal(width ** -0.5), in module order."""
    from avion_tpu_torch.ops.moe import MoEMlp

    moe = [m for m in module.modules() if isinstance(m, MoEMlp)]
    routers = {id(m.router) for m in moe}
    for m in module.modules():
        if isinstance(m, MoEMlp):
            m.init_weights(generator)
        elif isinstance(m, nn.Linear) and id(m) in routers:
            continue  # drawn with its MoE layer
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            m.bias.zero_()
        elif isinstance(m, PatchEmbed):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, LayerScale):
            m.gamma.fill_(m.init_value)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m.embedding_dim ** -0.5,
                             generator=generator)


def _init_visual_tables_(visual: VisionTransformer,
                         generator: Optional[torch.Generator]) -> None:
    """The class and positional embeddings normal(width ** -0.5), the
    temporal table zeros."""
    vw = visual.width
    if visual.class_embedding is not None:  # none under sequence_parallel
        visual.class_embedding.normal_(0.0, vw ** -0.5, generator=generator)
    visual.positional_embedding.normal_(0.0, vw ** -0.5, generator=generator)
    if visual.temporal_embedding is not None:
        visual.temporal_embedding.zero_()


class VideoClassifier(nn.Module):
    """``visual``'s width features, dropout (``dropout``, drawn from the
    forward's generator when training), and ``fc_cls`` applied in f32 to
    the features cast to f32: logits [B, num_classes] f32."""

    def __init__(self, visual: VisionTransformer, num_classes: int,
                 dropout: float = 0.0):
        super().__init__()
        self.visual = visual
        self.dtype = visual.dtype
        self.dropout = dropout
        self.fc_cls = nn.Linear(visual.width, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "VideoClassifier":
        """The tower as :meth:`CLIP.init_weights` draws it, then
        ``fc_cls``'s kernel truncated-normal(0.02) (cut at two standard
        deviations) and its bias zeros, from ``generator``."""
        _init_modules_(self.visual, generator)
        _init_visual_tables_(self.visual, generator)
        nn.init.trunc_normal_(self.fc_cls.weight, std=0.02, a=-0.04, b=0.04,
                              generator=generator)
        self.fc_cls.bias.zero_()
        return self

    def forward(self, image: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.visual(image, deterministic, generator)
        if self.dropout > 0.0 and not deterministic:
            keep = 1.0 - self.dropout
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
            x = torch.where(mask, x / keep, 0.0).to(x.dtype)
        return F.linear(x.float(), self.fc_cls.weight.float(),
                        self.fc_cls.bias.float())


def _l2norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)
