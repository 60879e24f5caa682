"""Transformer building blocks (``avion_tpu.models.layers``).

Parameter names follow the reference's torch layout that
``avion_tpu.tools.convert_checkpoint.export_clip_to_pt`` writes
(``ln_1``, ``attn.Wqkv``, ``attn.out_proj``, ``mlp.fc1`` / ``mlp.fc2``),
so such a file loads with ``load_state_dict(strict=True)``.

Rounding follows the JAX modules: parameters may be stored in f32 or
pre-cast to bf16 (``eval.runners.cast_inference_params``); a dense layer
casts its weight and bias to the compute dtype at use, as flax's
``promote_dtype`` does, and LayerNorm reduces in f32 and casts back.

Training: :func:`patch_dropout` draws from an explicit generator, and
:class:`Transformer` rematerializes its blocks under the JAX package's
policies (``full``, ``save_attn``, ``save_attn_kN``) with PyTorch's
selective activation checkpointing.  DropPath and LayerScale (no CLIP
configuration uses them), MoE and sequence parallelism are not ported yet.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from avion_tpu_torch.ops.flash_attention import (FWD_LSE_OP,
                                                 flash_attention_fused_qkv)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # flax nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's default Dense kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def patch_dropout(x: torch.Tensor, prob: float,
                  generator: Optional[torch.Generator] = None,
                  keep_cls: bool = True) -> torch.Tensor:
    """Keep a random subset of ``max(1, int((s - 1) * (1 - prob)))`` tokens
    per batch element (the CLS token always), in random order, as
    ``avion_tpu.models.layers.patch_dropout`` does; the draw comes from
    ``generator`` (on ``x``'s device)."""
    if prob == 0.0:
        return x
    b, s, _ = x.shape
    start = 1 if keep_cls else 0
    n_keep = max(1, int((s - start) * (1.0 - prob)))
    noise = torch.rand(b, s - start, generator=generator, device=x.device)
    idx = noise.argsort(dim=-1)[:, :n_keep]
    tokens = x[:, start:].gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.cat([x[:, :1], tokens], dim=1) if keep_cls else tokens


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in ``x``'s dtype (weights cast at use)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm with f32 reductions regardless of input dtype."""

    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), 1e-5)
        return y.to(self.dtype)


class Mlp(nn.Module):
    def __init__(self, width: int, act=gelu):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.act(dense(x, self.fc1)), self.fc2)


class SelfAttention(nn.Module):
    """Fused-qkv self-attention.  The projection's output lanes are
    ``[q_all | k_all | v_all]``; the attention reads them in place, on
    CUDA through the flash kernel (no padding of the token dim)."""

    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.Wqkv = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = dense(x, self.Wqkv)
        o = flash_attention_fused_qkv(qkv, self.heads, x.shape[1],
                                      causal=self.causal)
        return dense(o, self.out_proj)


class Block(nn.Module):
    """Pre-LN residual attention block."""

    def __init__(self, width: int, heads: int, act=gelu,
                 dtype: torch.dtype = torch.bfloat16, causal: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width, dtype)
        self.attn = SelfAttention(width, heads, causal)
        self.ln_2 = LayerNorm(width, dtype)
        self.mlp = Mlp(width, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


def saved_attn_layers(remat_policy: str, layers: int) -> int:
    """How many leading layers keep their attention output and lse under
    ``remat_policy``: ``full`` none, ``save_attn`` all, ``save_attn_kN``
    the first N."""
    if remat_policy == "full":
        return 0
    m = re.fullmatch(r"save_attn(?:_k(\d+))?", remat_policy)
    if not m:
        raise ValueError(f"unknown remat_policy {remat_policy!r} (expected "
                         f"'save_attn', 'save_attn_kN' or 'full')")
    return layers if m.group(1) is None else int(m.group(1))


def _save_attn(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``save_attn``: keep the training
    attention forward's outputs (out and lse), so the backward never
    re-runs that kernel; recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op is FWD_LSE_OP
            else CheckpointPolicy.PREFER_RECOMPUTE)


class Transformer(nn.Module):
    """Stack of blocks.  With ``remat`` each block runs under activation
    checkpointing when a gradient is taken: its inputs are kept and its
    activations recomputed in the backward, except, for the first
    ``saved_attn_layers(remat_policy)`` layers, the attention forward's
    outputs (``avion_tpu.models.layers.Transformer``'s policies)."""

    def __init__(self, width: int, layers: int, heads: int, act=gelu,
                 dtype: torch.dtype = torch.bfloat16, causal: bool = False,
                 remat: bool = False, remat_policy: str = "save_attn"):
        super().__init__()
        self.resblocks = nn.ModuleList(
            Block(width, heads, act, dtype, causal)
            for _ in range(layers))
        self.remat = remat
        self.save_k = saved_attn_layers(remat_policy, layers) if remat else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.resblocks):
            if not remat:
                x = blk(x)
                continue
            context_fn = (functools.partial(
                create_selective_checkpoint_contexts, _save_attn)
                if i < self.save_k else noop_context_fn)
            x = checkpoint(blk, x, use_reentrant=False, context_fn=context_fn)
        return x
