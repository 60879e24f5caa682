"""GPT-2 with gated cross-attention, the LaViLa narrator's text decoder
(``avion_tpu.models.gpt2_gated``).

A GPT-2 language model whose every ``cross_freq``-th block gains a gated
cross-attention sub-block that runs BEFORE the self-attention::

    r = x; x = ln_cross_attn(x)
    x = r + tanh(alpha_cattn) * crossattn(x, visual_tokens)
    r = x; x = ln_2_crossattention(x)
    x = r + tanh(alpha_dense) * mlp_sqrelu(x)
    # then the ordinary GPT-2 block:
    x = x + attn(ln_1(x));  x = x + mlp(ln_2(x))

- HF's ``Conv1D`` layers are kept as :class:`Conv1D`, weight ``[in,
  out]``, and the modules carry the released names
  (``transformer.{wte, wpe, h.{i}, ln_f}``, ``attn.c_attn``,
  ``crossattention.q_attn``, ...), so a released state dict loads with
  ``strict=True`` and no transposes.  The LM head is tied to ``wte``.
- LayerNorms are f32 (eps 1e-5); the MLP's activation is ``gelu_new`` (the
  tanh approximation), the cross MLP's squared ReLU.  A gate multiplies in
  f32, as JAX promotes a bf16 branch by an f32 gate.
- In bf16 on CUDA the self-attention runs the flash kernels, straight off
  the fused ``c_attn`` output (``[q | k | v]``, as CLIP's text tower): the
  forward with lse and its backward when training, the inference forward
  otherwise.  Elsewhere it is ``ops.attention.attention_packed``'s plain
  math, as in the JAX package (which never routes it to its kernel).  The
  cross-attention is plain f32 math.
- Cached decoding: :meth:`GatedGPT2LMHead.precompute_cross`,
  :meth:`~GatedGPT2LMHead.decode_one` and :func:`make_decode_cache`, with
  ``ops.attention.cached_decode_attention`` against the caches.
- ``pipeline``: ``transformer.h`` is ``parallel.pipeline_gated.
  PipelinedGatedDecoder`` (cross position ``"pre"``, the same blocks and
  names) over ``mesh.pp``; teacher-forced only (cached decoding raises),
  and the gated variant only, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avion_tpu_torch.models.layers import LayerNorm, gelu, lecun_normal_
from avion_tpu_torch.ops.attention import (attention_packed,
                                           cached_decode_attention)
from avion_tpu_torch.ops.flash_attention import flash_attention_fused_qkv

gelu_new = gelu  # HF's "gelu_new": the tanh approximation


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = F.relu(x)
    return r * r


def _ln(width: int) -> LayerNorm:
    return LayerNorm(width, torch.float32, 1e-5)


class Conv1D(nn.Module):
    """HF GPT-2's linear layer: ``x @ weight + bias`` with ``weight``
    [in, out], both cast to ``x``'s dtype."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype).t(), self.bias.to(x.dtype))


class GPT2SelfAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        self.c_attn = Conv1D(width, 3 * width)
        self.c_proj = Conv1D(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.width
        qkv = self.c_attn(x)
        if qkv.is_cuda and qkv.dtype == torch.bfloat16:
            o = flash_attention_fused_qkv(qkv, self.heads, qkv.shape[1],
                                          causal=True)
        else:
            o = attention_packed(qkv[..., :w], qkv[..., w:2 * w],
                                 qkv[..., 2 * w:], self.heads, causal=True,
                                 use_flash=False)
        return self.c_proj(o)

    def decode_step(self, x1: torch.Tensor, pos: int, k_cache: torch.Tensor,
                    v_cache: torch.Tensor):
        """Single-token cached attention: ``x1`` [B, 1, W] at ``pos``;
        caches [B, L, W], written in place.  Returns (out [B, 1, W],
        k_cache, v_cache)."""
        o, k_cache, v_cache = cached_decode_attention(
            self.c_attn(x1), pos, k_cache, v_cache, self.heads)
        return self.c_proj(o.to(self.dtype)), k_cache, v_cache


class GPT2CrossAttention(nn.Module):
    """q from the text, k / v from the visual tokens (``q_attn`` [W, W],
    ``c_attn`` [W_enc, 2W])."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        self.q_attn = Conv1D(width, width)
        self.c_attn = Conv1D(width, 2 * width)
        self.c_proj = Conv1D(width, width)

    def kv(self, enc: torch.Tensor):
        """k / v heads [B, H, M, D] in f32 from the visual tokens: constant
        per clip, so cached generation computes them once."""
        w, h = self.width, self.heads
        b, m, _ = enc.shape
        kv = self.c_attn(enc)
        k = kv[..., :w].reshape(b, m, h, w // h).transpose(1, 2)
        v = kv[..., w:].reshape(b, m, h, w // h).transpose(1, 2)
        return k.float(), v.float()

    def attend(self, x: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        w, h = self.width, self.heads
        b, s, _ = x.shape
        q = self.q_attn(x).reshape(b, s, h, w // h).transpose(1, 2)
        logits = q.float() @ k.transpose(-1, -2) / math.sqrt(w // h)
        o = torch.softmax(logits, dim=-1) @ v
        return self.c_proj(o.transpose(1, 2).reshape(b, s, w).to(self.dtype))

    def forward(self, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        return self.attend(x, *self.kv(enc))


class GPT2MLP(nn.Module):
    def __init__(self, width: int, inner: int, act=gelu_new):
        super().__init__()
        self.c_fc = Conv1D(width, inner)
        self.c_proj = Conv1D(inner, width)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class GatedGPT2Block(nn.Module):
    def __init__(self, width: int, heads: int, has_cross: bool = False,
                 gated: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.has_cross, self.gated, self.dtype = has_cross, gated, dtype
        if has_cross:
            self.ln_cross_attn = _ln(width)
            self.crossattention = GPT2CrossAttention(width, heads, dtype)
            self.ln_2_crossattention = _ln(width)
            self.mlp_crossattention = GPT2MLP(width, 4 * width, squared_relu)
            if gated:
                self.alpha_cattn = nn.Parameter(torch.zeros(()))
                self.alpha_dense = nn.Parameter(torch.zeros(()))
        self.ln_1 = _ln(width)
        self.attn = GPT2SelfAttention(width, heads, dtype)
        self.ln_2 = _ln(width)
        self.mlp = GPT2MLP(width, 4 * width, gelu_new)

    def _cross(self, x: torch.Tensor, attend) -> torch.Tensor:
        y = attend(self.ln_cross_attn(x).to(self.dtype))
        if self.gated:
            y = torch.tanh(self.alpha_cattn) * y.float()
        x = x + y
        y = self.mlp_crossattention(
            self.ln_2_crossattention(x).to(self.dtype))
        if self.gated:
            y = torch.tanh(self.alpha_dense) * y.float()
        return x + y

    def forward(self, x: torch.Tensor,
                enc: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.has_cross and enc is not None:
            x = self._cross(x, lambda y: self.crossattention(y, enc))
        x = x + self.attn(self.ln_1(x).to(self.dtype))
        return x + self.mlp(self.ln_2(x).to(self.dtype))

    def cross_kv(self, enc: torch.Tensor):
        return self.crossattention.kv(enc) if self.has_cross else None

    def decode_step(self, x1: torch.Tensor, pos: int, kv_self, ckv):
        """Cached single-token block step: ``kv_self`` the (k, v) caches
        [B, L, W]; ``ckv`` the precomputed cross (k, v) or None."""
        if self.has_cross and ckv is not None:
            x1 = self._cross(x1,
                             lambda y: self.crossattention.attend(y, *ckv))
        o, kc, vc = self.attn.decode_step(self.ln_1(x1).to(self.dtype), pos,
                                          *kv_self)
        x1 = x1 + o
        x1 = x1 + self.mlp(self.ln_2(x1).to(self.dtype))
        return x1, (kc, vc)


def make_decode_cache(layers: int, batch: int, max_len: int, width: int,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """Zeroed per-layer (k, v) caches [batch, max_len, width] for
    ``decode_one``."""
    z = lambda: torch.zeros(batch, max_len, width, dtype=dtype,  # noqa: E731
                            device=device)
    return tuple((z(), z()) for _ in range(layers))


class _GPT2Body(nn.Module):
    """HF's ``GPT2Model`` part of the LM: ``wte``, ``wpe``, ``h``,
    ``ln_f``."""

    def __init__(self, vocab_size: int, max_positions: int, width: int,
                 layers: int, heads: int, cross_freq: int, gated: bool,
                 dtype: torch.dtype, pipeline: bool = False,
                 pipeline_microbatches: int = 8,
                 pipeline_remat: bool = False):
        super().__init__()
        self.wte = nn.Embedding(vocab_size, width)
        self.wpe = nn.Embedding(max_positions, width)
        if pipeline:
            from avion_tpu_torch.parallel.pipeline_gated import (
                PipelinedGatedDecoder)

            self.h = PipelinedGatedDecoder(
                width, layers, heads, cross_freq, "pre", dtype,
                num_microbatches=pipeline_microbatches,
                remat=pipeline_remat, gated=gated)
        else:
            self.h = nn.ModuleList(
                GatedGPT2Block(width, heads, has_cross=(i % cross_freq == 0),
                               gated=gated, dtype=dtype)
                for i in range(layers))
        self.ln_f = _ln(width)


class GatedGPT2LMHead(nn.Module):
    """GPT-2 LM with cross-attention in the blocks ``i % cross_freq ==
    0``.  The LaViLa narrator's GPT-2 XL: width 1600, 48 layers, 25 heads,
    ``cross_freq`` 3."""

    def __init__(self, vocab_size: int = 50257, max_positions: int = 1024,
                 width: int = 1600, layers: int = 48, heads: int = 25,
                 cross_freq: int = 3, gated: bool = True,
                 dtype: torch.dtype = torch.float32, pipeline: bool = False,
                 pipeline_microbatches: int = 8,
                 pipeline_remat: bool = False):
        super().__init__()
        self.width, self.layers, self.dtype = width, layers, dtype
        self.pipeline = pipeline
        self.transformer = _GPT2Body(vocab_size, max_positions, width, layers,
                                     heads, cross_freq, gated, dtype,
                                     pipeline, pipeline_microbatches,
                                     pipeline_remat)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "GatedGPT2LMHead":
        """The flax initializers: ``wte`` normal(0.02), ``wpe``
        normal(0.01), dense kernels lecun-normal (truncated) with zero
        biases, LayerNorm ones and zeros, the gates zeros."""
        for m in self.modules():
            if isinstance(m, Conv1D):
                lecun_normal_(m.weight, m.weight.shape[0], generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, GatedGPT2Block) and m.has_cross and m.gated:
                m.alpha_cattn.zero_()
                m.alpha_dense.zero_()
        self.transformer.wte.weight.normal_(0.0, 0.02, generator=generator)
        self.transformer.wpe.weight.normal_(0.0, 0.01, generator=generator)
        return self

    def _sequential_only(self) -> None:
        if self.pipeline:
            raise RuntimeError(
                "KV-cached decoding needs the sequential block layout; load "
                "the checkpoint (the same names) into the model with "
                "pipeline=False")

    def _embed(self, tokens: torch.Tensor, start: int = 0) -> torch.Tensor:
        t = self.transformer
        s = tokens.shape[1]
        return (t.wte.weight.float()[tokens.long()]
                + t.wpe.weight.float()[start:start + s][None]).to(self.dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transformer.ln_f(x)  # f32
        return x @ self.transformer.wte.weight.to(x.dtype).t()  # tied

    def forward(self, tokens: torch.Tensor,
                enc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S]; enc [B, M, width] visual tokens.  Returns logits
        [B, S, vocab] in f32."""
        x = self._embed(tokens)
        if self.pipeline:
            if enc is None:
                raise ValueError("pipelined GPT-2 requires visual tokens")
            return self._head(self.transformer.h(x, enc))
        for blk in self.transformer.h:
            x = blk(x, enc)
        return self._head(x)

    def precompute_cross(self, enc: torch.Tensor) -> tuple:
        """Per-block cross-attention (k, v) of the visual tokens (None for
        the blocks without cross-attention)."""
        self._sequential_only()
        return tuple(blk.cross_kv(enc) for blk in self.transformer.h)

    def decode_one(self, tok: torch.Tensor, pos: int, kv, cross):
        """One cached decode step: ``tok`` [B, 1] at position ``pos``;
        ``kv`` the per-layer caches (:func:`make_decode_cache`, written in
        place); ``cross`` from :meth:`precompute_cross`.  Returns
        (next-token logits [B, vocab], kv)."""
        self._sequential_only()
        x = self._embed(tok, pos)
        new_kv = []
        for blk, kvi, ci in zip(self.transformer.h, kv, cross):
            x, kvi = blk.decode_step(x, pos, kvi, ci)
            new_kv.append(kvi)
        return self._head(x)[:, 0], tuple(new_kv)
