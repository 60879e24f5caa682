"""Transformer building blocks, inference only (``avion_tpu.models.layers``).

Parameter names follow the reference's torch layout that
``avion_tpu.tools.convert_checkpoint.export_clip_to_pt`` writes
(``ln_1``, ``attn.Wqkv``, ``attn.out_proj``, ``mlp.fc1`` / ``mlp.fc2``),
so such a file loads with ``load_state_dict(strict=True)``.

Rounding follows the JAX modules: parameters may be stored in f32 or
pre-cast to bf16 (``eval.runners.cast_inference_params``); a dense layer
casts its weight and bias to the compute dtype at use, as flax's
``promote_dtype`` does, and LayerNorm reduces in f32 and casts back.
Remat, DropPath, LayerScale, patch dropout, MoE and sequence parallelism
are training or non-CLIP features and are not in this port yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from avion_tpu_torch.ops.flash_attention import flash_attention_fused_qkv


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # flax nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


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


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, act=gelu,
                 dtype: torch.dtype = torch.bfloat16, causal: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            Block(width, heads, act, dtype, causal)
            for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x)
        return x
