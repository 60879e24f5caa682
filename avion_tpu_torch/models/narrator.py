"""VCLM narrator (``avion_tpu.models.narrator``): a video-conditioned causal
language model that writes pseudo-narrations for unlabeled clips.

A GPT-2-style causal decoder whose every ``cross_every``-th block carries
tanh-gated cross-attention over the visual tokens (the Flamingo / LaViLa
construction: the gates, scalar f32 parameters, start at 0, so the
language model is unperturbed at the start), fed by the port's
``models.vit.VisionTransformer`` with pooling ``none`` (every token,
``ln_post``-normalized) and a dense ``visual_proj`` to the decoder's width.

- The decoder's self-attention is the port's ``layers.SelfAttention``,
  causal: on CUDA the flash kernels (the forward with lse and the
  backward when training, the inference forward when generating
  uncached).  The cross-attention is ``ops.attention.xla_attention``,
  plain math with its bf16 cast of the probabilities, as in JAX.
- The output head is tied to the token embedding and runs in f32.
- Generation (:func:`make_generator`) is a Python loop over ``max_len -
  1`` steps with nucleus sampling drawn from a ``torch.Generator`` that is
  passed in; by default each step is a KV-cached single-token decode
  (:meth:`VCLM.decode_one`, plain f32 attention against the caches, no
  kernel), else the full prefix is re-decoded every step.
- Parameter names follow the flax module's (``blocks.{i}`` for
  ``block_{i}``, ``pos_embed``, ``attn_gate`` / ``mlp_gate``), so the
  optimizer's weight-decay mask and layer ids are the JAX package's.
- ``pipeline``: the decoder stack is ``parallel.pipeline_gated.
  PipelinedGatedDecoder`` over ``mesh.pp`` (the same blocks and names,
  ``pipeline_microbatches`` microbatches, ``pipeline_remat`` checkpoints
  each cross-attention group).  Cached decoding needs the sequential
  stack and raises on it, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avion_tpu_torch.models.clip import _init_modules_, _init_visual_tables_
from avion_tpu_torch.models.gpt2_gated import make_decode_cache
from avion_tpu_torch.models.layers import (LayerNorm, Mlp, SelfAttention,
                                           dense, gelu)
from avion_tpu_torch.models.vit import VisionTransformer
from avion_tpu_torch.ops.attention import xla_attention
from avion_tpu_torch.parallel.tensor_parallel import whole_linear


class CrossAttention(nn.Module):
    """Decoder-to-visual cross-attention: ``q`` from the text stream,
    ``kv`` (one fused projection) from the visual tokens."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.width, self.heads = width, heads
        self.q = nn.Linear(width, width)
        self.kv = nn.Linear(width, 2 * width)
        self.out_proj = nn.Linear(width, width)
        # under mesh.tensor, the matrices held in part and gathered on use
        # (parallel.tensor_parallel)
        self.tensor = None

    def kv_heads(self, visual: torch.Tensor):
        """Visual-token (k, v), each [B, Sv, H, D]: constant per clip, so
        cached generation computes them once."""
        b, sv, _ = visual.shape
        d = self.width // self.heads
        k, v = whole_linear(visual, self.kv, self.tensor, "kv").chunk(
            2, dim=-1)
        return (k.reshape(b, sv, self.heads, d),
                v.reshape(b, sv, self.heads, d))

    def attend(self, x: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        q = whole_linear(x, self.q, self.tensor, "q").reshape(
            b, s, self.heads, -1)
        o = xla_attention(q, k, v).reshape(b, s, self.width)
        return whole_linear(o, self.out_proj, self.tensor, "out_proj")

    def forward(self, x: torch.Tensor, visual: torch.Tensor) -> torch.Tensor:
        return self.attend(x, *self.kv_heads(visual))


class GatedDecoderBlock(nn.Module):
    """Causal self-attention, then (with ``cross_attend``) the gated
    cross-attention and its gated MLP, then the MLP."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype,
                 cross_attend: bool = True):
        super().__init__()
        self.cross_attend = cross_attend
        self.ln_1 = LayerNorm(width, dtype)
        self.attn = SelfAttention(width, heads, causal=True)
        if cross_attend:
            self.attn_gate = nn.Parameter(torch.zeros(()))
            self.ln_x = LayerNorm(width, dtype)
            self.xattn = CrossAttention(width, heads)
            self.mlp_gate = nn.Parameter(torch.zeros(()))
            self.ln_xm = LayerNorm(width, dtype)
            self.xmlp = Mlp(width, gelu)
        self.ln_2 = LayerNorm(width, dtype)
        self.mlp = Mlp(width, gelu)

    def _cross(self, x: torch.Tensor, attend) -> torch.Tensor:
        y = attend(self.ln_x(x))
        x = x + torch.tanh(self.attn_gate).to(x.dtype) * y
        y = self.xmlp(self.ln_xm(x))
        return x + torch.tanh(self.mlp_gate).to(x.dtype) * y

    def forward(self, x: torch.Tensor, visual: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        if self.cross_attend:
            x = self._cross(x, lambda y: self.xattn(y, visual))
        return x + self.mlp(self.ln_2(x))

    def cross_kv(self, visual: torch.Tensor):
        return self.xattn.kv_heads(visual) if self.cross_attend else None

    def decode_step(self, x1: torch.Tensor, pos: int, kv_self, ckv):
        o, kc, vc = self.attn.decode_step(self.ln_1(x1), pos, *kv_self)
        x1 = x1 + o
        if self.cross_attend and ckv is not None:
            x1 = self._cross(x1, lambda y: self.xattn.attend(y, *ckv))
        x1 = x1 + self.mlp(self.ln_2(x1))
        return x1, (kc, vc)


class VCLM(nn.Module):
    """Video-conditioned LM: ``forward(video, tokens)`` returns next-token
    logits [B, S, vocab] in f32; :meth:`encode_video` gives the visual
    tokens for cached generation."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8,
                 cross_every: int = 2, image_size: int = 224,
                 patch_size: int = 16, num_frames: int = 4,
                 vision_width: int = 768, vision_layers: int = 12,
                 vision_heads: int = 12,
                 dtype: torch.dtype = torch.bfloat16, pipeline: bool = False,
                 pipeline_microbatches: int = 8,
                 pipeline_remat: bool = False):
        super().__init__()
        self.vocab_size, self.context_length = vocab_size, context_length
        self.width, self.layers, self.heads = width, layers, heads
        self.image_size, self.num_frames = image_size, num_frames
        self.vision_layers = vision_layers
        self.dtype = dtype
        self.visual = VisionTransformer(
            image_size, patch_size, num_frames, vision_width, vision_layers,
            vision_heads, act=gelu, dtype=dtype, pooling="none")
        self.visual_proj = nn.Linear(vision_width, width)
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.pos_embed = nn.Parameter(torch.zeros(context_length, width))
        self.pipeline = pipeline
        if pipeline:
            from avion_tpu_torch.parallel.pipeline_gated import (
                PipelinedGatedDecoder)

            self.blocks = PipelinedGatedDecoder(
                width, layers, heads, cross_every, "mid", dtype,
                num_microbatches=pipeline_microbatches,
                remat=pipeline_remat)
        else:
            self.blocks = nn.ModuleList(
                GatedDecoderBlock(width, heads, dtype,
                                  cross_attend=(i % cross_every == 0))
                for i in range(layers))
        self.ln_f = LayerNorm(width, dtype)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "VCLM":
        """Draw every parameter from ``generator`` as the flax VCLM's
        initializers do: dense and patchify kernels lecun-normal
        (truncated) with zero biases, LayerNorm ones and zeros, the visual
        tower's class and positional embeddings normal(vision_width **
        -0.5) and temporal table zeros, the token embedding normal(width **
        -0.5), ``pos_embed`` normal(0.01), the gates zeros.  The parameters
        must be on ``generator``'s device."""
        _init_modules_(self, generator)
        _init_visual_tables_(self.visual, generator)
        self.pos_embed.normal_(0.0, 0.01, generator=generator)
        for blk in self.blocks:
            if blk.cross_attend:
                blk.attn_gate.zero_()
                blk.mlp_gate.zero_()
        return self

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, C] normalized video -> [B, S_v, width]."""
        return dense(self.visual(video), self.visual_proj)

    def _embed(self, tokens: torch.Tensor, start: int = 0) -> torch.Tensor:
        x = self.token_embedding(tokens.long()).to(self.dtype)
        s = tokens.shape[1]
        return x + self.pos_embed[start:start + s].to(self.dtype)[None]

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        # weight-tied output head, in f32
        return self.ln_f(x).float() @ self.token_embedding.weight.float().t()

    def decode(self, tokens: torch.Tensor,
               visual: torch.Tensor) -> torch.Tensor:
        x = self._embed(tokens)
        if self.pipeline:
            return self._head(self.blocks(x, visual))
        for blk in self.blocks:
            x = blk(x, visual)
        return self._head(x)

    def forward(self, video: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
        return self.decode(tokens, self.encode_video(video))

    # -- KV-cached decoding ---------------------------------------------

    def precompute_cross(self, visual: torch.Tensor) -> tuple:
        """Per-block cross-attention (k, v) (None for non-cross blocks)."""
        _sequential_only(self.pipeline)
        return tuple(blk.cross_kv(visual) for blk in self.blocks)

    def decode_one(self, tok: torch.Tensor, pos: int, kv, cross):
        """One cached decode step: ``tok`` [B, 1] at position ``pos``;
        ``kv`` per-layer (k, v) caches (:func:`make_decode_cache`, written
        in place); ``cross`` from :meth:`precompute_cross`.  Returns
        (logits [B, vocab] f32, kv)."""
        _sequential_only(self.pipeline)
        x = self._embed(tok, pos)
        new_kv = []
        for blk, kvi, ci in zip(self.blocks, kv, cross):
            x, kvi = blk.decode_step(x, pos, kvi, ci)
            new_kv.append(kvi)
        return self._head(x)[:, 0], tuple(new_kv)


def _sequential_only(pipeline: bool) -> None:
    if pipeline:
        raise RuntimeError(
            "KV-cached decoding needs the sequential block layout; load the "
            "checkpoint (the same names) into the model with pipeline=False")


def caption_loss(logits: torch.Tensor, tokens: torch.Tensor,
                 pad_id: int = 0) -> torch.Tensor:
    """Shifted next-token cross-entropy, ignoring padding targets."""
    nll, count = caption_nll(logits, tokens, pad_id)
    return nll / count.clamp_min(1.0)


def caption_nll(logits: torch.Tensor, tokens: torch.Tensor,
                pad_id: int = 0):
    """(summed next-token NLL over the non-padding targets, their count),
    the two parts of :func:`caption_loss`."""
    return label_nll(logits[:, :-1], tokens[:, 1:], pad_id)


def label_nll(logits: torch.Tensor, labels: torch.Tensor, pad_id: int = 0):
    """(summed NLL of ``labels`` [B, S] under ``logits`` [B, S, V] over the
    non-padding labels, their count)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    targets = labels.long()
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    mask = (targets != pad_id).float()
    return (nll * mask).sum(), mask.sum()


def nucleus_filter(logits: torch.Tensor, top_p: float = 0.95,
                   temperature: float = 0.7) -> torch.Tensor:
    """``logits`` / temperature with every token below the top-p cutoff
    set to -inf: the smallest set whose cumulative probability reaches
    ``top_p`` (the first sorted index where it does) stays."""
    logits = logits / max(temperature, 1e-6)
    sorted_logits = logits.sort(dim=-1, descending=True).values
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    idx = (cum >= top_p).int().argmax(dim=-1, keepdim=True)
    cutoff = sorted_logits.gather(-1, idx)
    return torch.where(logits < cutoff, float("-inf"), logits)


def categorical(logits: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """One draw per row of softmax(``logits``) [B, V] (Gumbel-max) from
    ``generator`` (on ``logits``' device)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (logits + gumbel).argmax(dim=-1)


def nucleus_sample_step(generator: torch.Generator, logits: torch.Tensor,
                        top_p: float = 0.95,
                        temperature: float = 0.7) -> torch.Tensor:
    """Top-p filtered categorical sample from [B, vocab] logits."""
    return categorical(nucleus_filter(logits, top_p, temperature), generator)


def make_generator(model: VCLM, *, max_len: int = 30, top_p: float = 0.95,
                   temperature: float = 0.7, sot: int = 49406,
                   eot: int = 49407, use_cache: bool = True):
    """Returns ``generate(video, generator) -> tokens [B, max_len]`` (int64,
    on the video's device): ``sot`` first, then ``max_len - 1`` sampled
    tokens, 0 after a row's ``eot``.  ``use_cache`` (default) runs
    KV-cached single-token decode; ``use_cache=False`` re-decodes the whole
    prefix each step (the same tokens for the same draws)."""

    @torch.inference_mode()
    def generate(video: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        b = video.shape[0]
        visual = model.encode_video(video)
        tokens = torch.zeros(b, max_len, dtype=torch.long,
                             device=video.device)
        tokens[:, 0] = sot
        done = torch.zeros(b, dtype=torch.bool, device=video.device)
        if use_cache:
            cross = model.precompute_cross(visual)
            kv = make_decode_cache(model.layers, b, max_len, model.width,
                                   model.dtype, video.device)
        for i in range(1, max_len):
            if use_cache:
                step_logits, kv = model.decode_one(tokens[:, i - 1:i], i - 1,
                                                   kv, cross)
            else:
                step_logits = model.decode(tokens, visual)[:, i - 1]
            nxt = nucleus_sample_step(generator, step_logits, top_p,
                                      temperature)
            nxt = torch.where(done, 0, nxt)
            tokens[:, i] = nxt
            done |= nxt == eot
        return tokens

    return generate

