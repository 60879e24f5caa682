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
- ``ls_init_value`` gives every block LayerScale (``layers.LayerScale``);
  it defaults to None, and CLIP does not pass it, as in the JAX package.
- Factorized positional embeddings: spatial (per patch, shared across
  frames) + temporal (per frame, shared across patches).
- A CLS token (``class_embedding + positional_embedding[0]``, added in
  f32), patch dropout when training, ``ln_pre``, the transformer (with
  DropPath when training), and pooling: ``cls`` the CLS token, ``gap``
  the mean over all tokens (the CLS token too, accumulated in f32), each
  then ``ln_post``; ``none`` returns ``ln_post`` of every token.
- The tower returns width features, the JAX tower's ``output_dim=None``:
  the projection to the joint space lives in ``clip.CLIP`` as
  ``image_projection``, as in the reference state dict.
- ``sequence_parallel`` (gap or none pooling, no patch dropout, no CLS
  token and so no ``class_embedding``, as in the JAX tower): each rank of
  the current mesh's ``sp`` group keeps its S / sp tokens after the patch
  embedding, attention runs the ring, and gap pooling sums the shards'
  token sums by an all-reduce whose backward sums too, so that the average
  of the ranks' gradients is the gradient of the whole sequence.
- ``moe_experts`` > 0: every block's MLP is a mixture of experts
  (``ops.moe``); in a sequence-parallel tower it gathers its rows' tokens
  over ``sp`` and routes them in JAX's global order.
- ``pipeline``: the layer stack is ``parallel.pipeline.
  PipelinedTransformer`` over ``mesh.pp`` (``pipeline_microbatches``
  microbatches; ``remat`` checkpoints each block under ``save_attn``, the
  JAX pipeline's policy), without MoE, sequence parallelism, LayerScale or
  DropPath, as the JAX tower asserts.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from avion_tpu_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD,
                                             OPENAI_MEAN, OPENAI_STD,
                                             normalize_video)
from avion_tpu_torch.models.layers import (LayerNorm, Transformer, gelu,
                                           patch_dropout)
from avion_tpu_torch.ops.ring_attention import group_rank_size, sp_group

INPUT_NORMS = {"none": None, "openai": (OPENAI_MEAN, OPENAI_STD),
               "imagenet": (IMAGENET_MEAN, IMAGENET_STD)}
POOLINGS = ("cls", "gap", "none")


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
                 remat_policy: str = "save_attn", input_norm: str = "none",
                 pooling: str = "cls", drop_path_rate: float = 0.0,
                 ls_init_value: Optional[float] = None,
                 sequence_parallel: bool = False, moe_experts: int = 0,
                 pipeline: bool = False, pipeline_microbatches: int = 8):
        super().__init__()
        if input_norm not in INPUT_NORMS:
            raise ValueError(f"input_norm must be none|openai|imagenet, "
                             f"got {input_norm!r}")
        if pooling not in POOLINGS:
            raise ValueError(f"pooling must be cls|gap|none, got {pooling!r}")
        if sequence_parallel and (pooling == "cls" or patch_dropout):
            raise ValueError("sequence_parallel needs gap or none pooling "
                             "(no CLS token) and no patch dropout")
        self.pooling = pooling
        self.width = width
        self.sequence_parallel = sequence_parallel
        n = (image_size // patch_size) ** 2
        self.dtype = dtype
        self.patch_dropout_rate = patch_dropout
        self.remat = remat
        self.input_norm = input_norm
        self.conv1 = PatchEmbed(width, patch_size)
        self.class_embedding = (
            None if sequence_parallel
            else nn.Parameter(torch.randn(width) * width ** -0.5))
        self.positional_embedding = nn.Parameter(
            torch.randn(n + 1, width) * width ** -0.5)
        self.temporal_embedding = (
            nn.Parameter(torch.zeros(num_frames, width)) if num_frames > 1
            else None)
        self.ln_pre = LayerNorm(width, dtype)
        if pipeline:
            if moe_experts or sequence_parallel:
                raise ValueError("pipeline excludes moe/sequence_parallel in "
                                 "the same tower")
            if ls_init_value is not None or drop_path_rate:
                raise ValueError("a pipelined tower has no LayerScale or "
                                 "DropPath")
            from avion_tpu_torch.parallel.pipeline import (
                PipelinedTransformer)

            self.transformer = PipelinedTransformer(
                width, layers, heads, act, dtype,
                num_microbatches=pipeline_microbatches, remat=remat)
        else:
            self.transformer = Transformer(
                width, layers, heads, act, dtype, causal=False, remat=remat,
                remat_policy=remat_policy, drop_path_rate=drop_path_rate,
                ls_init_value=ls_init_value,
                sequence_parallel=sequence_parallel, moe_experts=moe_experts)
        self.ln_post = LayerNorm(width, dtype)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        stats = INPUT_NORMS[self.input_norm]
        if stats is not None and x.dtype == torch.uint8:
            x = normalize_video(x, *stats, dtype=self.dtype)
        return self.conv1(x.to(self.dtype))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, H, W, C], float (already normalized) or, with
        ``input_norm``, uint8.  Returns the ``ln_post``-normalized pooled
        features [B, width] (pooling ``none``: [B, S, width]).  With
        ``deterministic=False`` patch dropout and DropPath draw from
        ``generator``."""
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
        if self.sequence_parallel:
            group, tokens = sp_group(), x.shape[1]
            x = _local_tokens(x, group)
        else:
            cls_tok = (self.class_embedding + pos[0]).to(self.dtype)
            x = torch.cat([cls_tok.expand(b, 1, -1), x], dim=1)
        if self.patch_dropout_rate > 0.0 and not deterministic:
            x = patch_dropout(x, self.patch_dropout_rate, generator)
        keep = (None if deterministic else
                self.transformer.draw_drop_path(b, generator, x.device))
        x = self.transformer(self.ln_pre(x), keep)
        if self.pooling == "none":
            return self.ln_post(x)
        if self.pooling == "gap":
            if self.sequence_parallel:
                pooled = _all_reduce_sum(x.float().sum(dim=1), group)
                return self.ln_post((pooled / tokens).to(x.dtype))
            return self.ln_post(x.float().mean(dim=1).to(x.dtype))
        return self.ln_post(x[:, 0])


def _local_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """This ``sp`` rank's contiguous shard of the token dim."""
    rank, n = group_rank_size(group)
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} tokens do not divide by sp={n}")
    per = x.shape[1] // n
    return x[:, rank * per:(rank + 1) * per]


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the cotangents too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    if group_rank_size(group)[1] == 1:
        return x
    return _AllReduceSum.apply(x, group)
