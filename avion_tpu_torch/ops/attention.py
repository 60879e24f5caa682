"""Attention that is no kernel (``avion_tpu.ops.attention``): the plain math
of the JAX package's XLA path, and its dispatch to the flash kernels.

Layout everywhere is BSHD: ``[batch, seq, heads, head_dim]``.

- :func:`xla_attention`: f32 logits, softmax in f32, the probabilities cast
  to ``v``'s dtype before the second product (in bf16 that rounding is
  part of the result, as in JAX).
- :func:`attention_packed`: attention over packed ``[B, S, H*D]`` lane
  sections.  ``use_flash`` on a CUDA tensor goes through
  ``ops.flash_attention.flash_attention_fused_qkv`` (the hand-written
  kernels; anything they refuse raises); otherwise, and on the CPU, the
  plain math.
- :func:`cached_decode_attention`: one token's causal attention against
  k / v caches, plain f32 math (single-token attention reads the caches
  once; the JAX package has no kernel for it either).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from avion_tpu_torch.ops.flash_attention import flash_attention_fused_qkv


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention over BSHD ``q`` [B, S, H, D] and ``k`` / ``v``
    [B, Sk, H, D]; the output has ``q``'s dtype."""
    s, d = q.shape[1], q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, *, causal: bool = False,
                     sm_scale: Optional[float] = None,
                     use_flash: bool = True) -> torch.Tensor:
    """Multi-head attention over packed [B, S, H*D] tensors; returns
    [B, S, H*D].  With ``use_flash`` a CUDA tensor takes the flash kernels
    (q, k and v joined into one fused operand)."""
    b, s, w = q.shape
    if use_flash and q.is_cuda:
        return flash_attention_fused_qkv(torch.cat([q, k, v], dim=-1), heads,
                                         s, causal=causal, sm_scale=sm_scale)
    d = w // heads
    unpack = lambda x: x.reshape(b, x.shape[1], heads, d)  # noqa: E731
    out = xla_attention(unpack(q), unpack(k), unpack(v), causal=causal,
                        sm_scale=sm_scale)
    return out.reshape(b, s, w)


def cached_decode_attention(qkv: torch.Tensor, pos: int,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """KV-cached single-token causal attention of every autoregressive
    decoder (``layers.SelfAttention`` and ``gpt2_gated.GPT2SelfAttention``).

    ``qkv``: [B, 1, 3W], the fused projection of the token at ``pos``;
    caches [B, L, W].  The token's k and v are written into the caches at
    ``pos`` (in place, in the caches' dtype) and the query attends over
    positions ``<= pos`` in f32.  Returns (o [B, 1, W] f32, k_cache,
    v_cache)."""
    w = qkv.shape[-1] // 3
    d = w // heads
    b = qkv.shape[0]
    q = qkv[:, 0, :w].float().reshape(b, heads, d)
    k_cache[:, pos] = qkv[:, 0, w:2 * w].to(k_cache.dtype)
    v_cache[:, pos] = qkv[:, 0, 2 * w:].to(v_cache.dtype)
    length = k_cache.shape[1]
    k = k_cache.float().reshape(b, length, heads, d)
    v = v_cache.float().reshape(b, length, heads, d)
    s = torch.einsum("bhd,blhd->bhl", q, k) / math.sqrt(d)
    visible = torch.arange(length, device=s.device) <= pos
    s = torch.where(visible, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhl,blhd->bhd", p, v).reshape(b, 1, w)
    return o, k_cache, v_cache
