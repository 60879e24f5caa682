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
selective activation checkpointing.  DropPath's per-sample keep masks
are drawn for every layer before the blocks run (:meth:`Transformer.
draw_drop_path`) and passed in as tensors, so a rematerialized block sees
the same mask in its recompute.  LayerScale (``ls_init_value``; no registry
configuration sets it) scales each residual branch before its DropPath and
is recomputed with the rest of the block.  With ``sequence_parallel`` the
attention runs the ring of ``ops.ring_attention`` over the current mesh's
``sp`` group, on this rank's shard of the tokens.  ``moe_experts`` > 0
swaps a block's MLP for ``ops.moe.MoEMlp`` (``moe_mlp``, no ``mlp``), as
the JAX block does.
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

from avion_tpu_torch.ops.activation import quick_gelu  # noqa: F401
from avion_tpu_torch.ops.attention import cached_decode_attention
from avion_tpu_torch.ops.flash_attention import (FWD_LSE_OP, HOP_FWD_OP,
                                                 flash_attention_fused_qkv)
from avion_tpu_torch.ops.ring_attention import ring_flash_attention_packed
from avion_tpu_torch.parallel.tensor_parallel import (column, gather_qkv,
                                                      local_heads, own_columns,
                                                      row)


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
    """LayerNorm with f32 reductions regardless of input dtype; the output
    in ``dtype``."""

    def __init__(self, width: int, dtype: torch.dtype, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


class Mlp(nn.Module):
    """``fc2(act(fc1(x)))``; under ``mesh.tensor`` (``tensor``, set by
    ``parallel.tensor_parallel``) each rank computes its columns."""

    def __init__(self, width: int, act=gelu):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)
        self.act = act
        self.tensor = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(column(x, self.fc1, self.tensor, "fc1"))
        return row(h, self.fc2, self.tensor, "fc2")


class SelfAttention(nn.Module):
    """Fused-qkv self-attention.  The projection's output lanes are
    ``[q_all | k_all | v_all]``; the attention reads them in place, on
    CUDA through the flash kernel (no padding of the token dim).  Under
    ``mesh.tensor`` (``tensor``, set by ``parallel.tensor_parallel``) each
    rank computes its heads' lanes and attention (the ring's too), or,
    where ``tensor`` does not divide the heads, its block of the lanes,
    gathered whole for the attention."""

    def __init__(self, width: int, heads: int, causal: bool = False,
                 sequence_parallel: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.sequence_parallel = sequence_parallel
        self.Wqkv = nn.Linear(width, 3 * width)
        self.out_proj = nn.Linear(width, width)
        self.tensor = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = gather_qkv(column(x, self.Wqkv, self.tensor, "Wqkv"),
                         self.tensor)
        heads = local_heads(self.heads, self.tensor)
        if self.sequence_parallel:
            w = qkv.shape[-1] // 3
            o = ring_flash_attention_packed(
                qkv[..., :w], qkv[..., w:2 * w], qkv[..., 2 * w:],
                heads, causal=self.causal)
        else:
            o = flash_attention_fused_qkv(qkv, heads, x.shape[1],
                                          causal=self.causal)
        return row(own_columns(o, self.tensor), self.out_proj, self.tensor,
                   "out_proj")

    def decode_step(self, x1: torch.Tensor, pos: int, k_cache: torch.Tensor,
                    v_cache: torch.Tensor):
        """KV-cached single-token causal attention for autoregressive
        decoding (``ops.attention.cached_decode_attention``, plain f32).
        ``x1``: [B, 1, W]; caches [B, L, W], written at ``pos`` in place.
        Returns (out [B, 1, W] in ``x1``'s dtype, k_cache, v_cache).  A
        whole model only (not under ``mesh.tensor``)."""
        if self.tensor is not None:
            raise NotImplementedError("cached decoding runs a whole model, "
                                      "not one split over mesh.tensor")
        o, k_cache, v_cache = cached_decode_attention(
            dense(x1, self.Wqkv), pos, k_cache, v_cache, self.heads)
        return dense(o.to(x1.dtype), self.out_proj), k_cache, v_cache


def drop_path(y: torch.Tensor, keep: Optional[torch.Tensor],
              rate: float) -> torch.Tensor:
    """Stochastic depth of one residual branch (``avion_tpu.models.layers.
    DropPath``): ``y / (1 - rate)`` where the per-sample ``keep`` [B] bool
    holds, else 0, in ``y``'s dtype.  ``keep=None`` is the identity."""
    if keep is None or rate == 0.0:
        return y
    return torch.where(keep[:, None, None], y / (1.0 - rate), 0.0).to(y.dtype)


class LayerScale(nn.Module):
    """``x * gamma`` (``avion_tpu.models.layers.LayerScale``): an f32
    ``gamma`` [width] initialised to ``init_value``, cast to ``x``'s dtype
    at use."""

    def __init__(self, width: int, init_value: float):
        super().__init__()
        self.init_value = float(init_value)
        self.gamma = nn.Parameter(torch.full((width,), self.init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """Pre-LN residual attention block; ``drop_path`` is the rate of both
    residual branches; with ``ls_init_value`` each branch is scaled by a
    :class:`LayerScale` (``ls_1``, ``ls_2``) before its DropPath; with
    ``moe_experts`` > 0 the MLP is ``ops.moe.MoEMlp`` (``moe_mlp``)."""

    def __init__(self, width: int, heads: int, act=gelu,
                 dtype: torch.dtype = torch.bfloat16, causal: bool = False,
                 drop_path: float = 0.0,
                 ls_init_value: Optional[float] = None,
                 sequence_parallel: bool = False, moe_experts: int = 0):
        super().__init__()
        self.ln_1 = LayerNorm(width, dtype)
        self.attn = SelfAttention(width, heads, causal, sequence_parallel)
        self.ln_2 = LayerNorm(width, dtype)
        if moe_experts > 0:
            from avion_tpu_torch.ops.moe import MoEMlp

            self.moe_mlp = MoEMlp(width, experts=moe_experts, act=act,
                                  dtype=dtype,
                                  sequence_parallel=sequence_parallel)
        else:
            self.mlp = Mlp(width, act)
        self.drop_path = drop_path
        self.ls_1, self.ls_2 = (
            (LayerScale(width, ls_init_value), LayerScale(width, ls_init_value))
            if ls_init_value is not None else (nn.Identity(), nn.Identity()))

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: None, or [2, B] bool, the keep masks of the attention
        and MLP branches."""
        k1, k2 = (None, None) if keep is None else keep
        x = x + drop_path(self.ls_1(self.attn(self.ln_1(x))), k1,
                          self.drop_path)
        mlp = self.moe_mlp if hasattr(self, "moe_mlp") else self.mlp
        return x + drop_path(self.ls_2(mlp(self.ln_2(x))), k2,
                             self.drop_path)


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
    attention forward's outputs (out and lse; under sequence parallelism
    each ring hop's), so the backward never re-runs that kernel; recompute
    everything else (the ring's merge and rotations too)."""
    return (CheckpointPolicy.MUST_SAVE if op is FWD_LSE_OP
            or op is HOP_FWD_OP else CheckpointPolicy.PREFER_RECOMPUTE)


class Transformer(nn.Module):
    """Stack of blocks.  With ``remat`` each block runs under activation
    checkpointing when a gradient is taken: its inputs are kept and its
    activations recomputed in the backward, except, for the first
    ``saved_attn_layers(remat_policy)`` layers, the attention forward's
    outputs (``avion_tpu.models.layers.Transformer``'s policies)."""

    def __init__(self, width: int, layers: int, heads: int, act=gelu,
                 dtype: torch.dtype = torch.bfloat16, causal: bool = False,
                 remat: bool = False, remat_policy: str = "save_attn",
                 drop_path_rate: float = 0.0,
                 ls_init_value: Optional[float] = None,
                 sequence_parallel: bool = False, moe_experts: int = 0):
        super().__init__()
        # layer i drops at rate * i / (layers - 1), as the JAX stack
        self.drop_rates = [drop_path_rate * i / max(1, layers - 1)
                           for i in range(layers)]
        self.resblocks = nn.ModuleList(
            Block(width, heads, act, dtype, causal, rate, ls_init_value,
                  sequence_parallel, moe_experts)
            for rate in self.drop_rates)
        self.remat = remat
        self.save_k = saved_attn_layers(remat_policy, layers) if remat else 0

    def draw_drop_path(self, batch: int, generator: Optional[torch.Generator],
                       device) -> Optional[torch.Tensor]:
        """Every layer's DropPath keep masks, [layers, 2, batch] bool, drawn
        from ``generator`` (on ``device``); None when no layer drops."""
        if not any(self.drop_rates):
            return None
        keep = torch.tensor([1.0 - r for r in self.drop_rates], device=device)
        u = torch.rand(len(self.drop_rates), 2, batch, generator=generator,
                       device=device)
        return u < keep[:, None, None]

    def forward(self, x: torch.Tensor,
                drop_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``drop_keep``: :meth:`draw_drop_path`'s masks, or None (no
        DropPath)."""
        remat = self.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.resblocks):
            keep = None if drop_keep is None else drop_keep[i]
            if not remat:
                x = blk(x, keep)
                continue
            context_fn = (functools.partial(
                create_selective_checkpoint_contexts, _save_attn)
                if i < self.save_k else noop_context_fn)
            x = checkpoint(blk, x, keep, use_reentrant=False,
                           context_fn=context_fn)
        return x
