"""LaViLa narrator (``VCLM_HF``; ``avion_tpu.models.lavila``): TimeSformer
video tokens pooled into learned queries that a gated GPT-2 decoder
cross-attends.

- :class:`AttentionPool` is CoCa's multi-query pooling: ``heads`` query
  heads of ``dim_head``, one k / v head; its LayerNorms have a zero bias
  (the released file stores only their gamma; ``models.lavila_import``
  turns that into weight and bias).
- :meth:`LavilaNarrator.generate` continues a prompt: cached by default
  (the prompt is prefilled through the cache and written only at ``i >=
  s0``), or re-decoding the prefix.  Sampling is greedy without a
  generator, else nucleus sampling with its own cutoff rule (``sum(cum <
  top_p)``, the rest set to -1e30), not the VCLM's.
- Parameter names are the released checkpoint's (``visual.*``,
  ``text_decoder.transformer.*``, ``img_queries``, ``img_attn_pool.*``,
  ``img_attn_pool_norm``).
- :meth:`LavilaNarrator.freeze` is LaViLa's narrator recipe
  (``--freeze-lm-vclm --freeze-visual-vclm``): the GPT-2's own leaves and
  the whole TimeSformer stop training.  A TimeSformer whose every leaf is
  frozen runs its forward without recording a graph.
- Under a profiler the forward records the spans ``avion.tower.visual``
  (the TimeSformer), ``avion.tower.pool`` (the queries' pool) and
  ``avion.tower.text`` (the gated GPT-2), and the marks
  ``avion.tower.<tower>.bwd`` where each tower's backward starts.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn

from avion_tpu_torch.core.profiling import backward_mark, span
from avion_tpu_torch.models.gpt2_gated import (GatedGPT2LMHead,
                                               make_decode_cache)
from avion_tpu_torch.models.layers import LayerNorm, dense, lecun_normal_
from avion_tpu_torch.models.narrator import categorical
from avion_tpu_torch.models.timesformer import SpaceTimeTransformer


class AttentionPool(nn.Module):
    """Learned queries over the visual tokens (``coca.py``'s
    ``CrossAttention``)."""

    def __init__(self, dim: int, context_dim: int, heads: int = 8,
                 dim_head: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.norm = LayerNorm(dim, torch.float32)
        self.context_norm = LayerNorm(context_dim, torch.float32)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(context_dim, 2 * dim_head, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, queries: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        dh = self.dim_head
        q = dense(self.norm(queries).to(self.dtype), self.to_q)
        kv = dense(self.context_norm(context).to(self.dtype), self.to_kv)
        k, v = kv[..., :dh].float(), kv[..., dh:].float()
        b, n, _ = q.shape
        q = q.reshape(b, n, self.heads, dh).transpose(1, 2).float()
        sim = torch.einsum("bhid,bjd->bhij", q / math.sqrt(dh), k)
        out = torch.einsum("bhij,bjd->bhid", torch.softmax(sim, dim=-1), v)
        out = out.transpose(1, 2).reshape(b, n, self.heads * dh)
        return dense(out.to(self.dtype), self.to_out)


# LaViLa's --freeze-lm-vclm keeps an LM leaf training iff its name holds
# one of these: the gated cross sub-blocks (ln_cross_attn, crossattention,
# ln_2_crossattention, mlp_crossattention) and their gates
CROSS_LEAVES = ("crossattention", "cross_attn", "alpha_")


def _frozen(module: nn.Module) -> bool:
    return not any(p.requires_grad for p in module.parameters())


class LavilaNarrator(nn.Module):
    """VCLM_HF: SpaceTimeTransformer + query pool + gated GPT-2."""

    def __init__(self, image_size: int = 336, patch_size: int = 14,
                 num_frames: int = 4, vision_width: int = 1024,
                 vision_layers: int = 24, vision_heads: int = 16,
                 vocab_size: int = 50257, max_positions: int = 1024,
                 text_width: int = 1600, text_layers: int = 48,
                 text_heads: int = 25, cross_freq: int = 3,
                 gated_xattn: bool = True, num_img_queries: int = 256,
                 pool_heads: int = 8, pool_dim_head: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_size, self.num_frames = image_size, num_frames
        self.text_width, self.dtype = text_width, dtype
        self.layers = text_layers  # the decoder's, for layer decay
        self.visual = SpaceTimeTransformer(
            image_size=image_size, patch_size=patch_size,
            num_frames=num_frames, width=vision_width, layers=vision_layers,
            heads=vision_heads, dtype=dtype)
        self.text_decoder = GatedGPT2LMHead(
            vocab_size=vocab_size, max_positions=max_positions,
            width=text_width, layers=text_layers, heads=text_heads,
            cross_freq=cross_freq, gated=gated_xattn, dtype=dtype)
        self.img_queries = nn.Parameter(
            torch.zeros(num_img_queries, text_width))
        self.img_attn_pool = AttentionPool(text_width, vision_width,
                                           pool_heads, pool_dim_head, dtype)
        self.img_attn_pool_norm = LayerNorm(text_width, torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "LavilaNarrator":
        """The flax initializers (see the towers' ``init_weights``; the
        pool's kernels lecun-normal, its norms ones and zeros,
        ``img_queries`` normal(text_width ** -0.5)), drawn from
        ``generator`` on the parameters' device."""
        self.visual.init_weights(generator)
        self.text_decoder.init_weights(generator)
        for m in (self.img_attn_pool.to_q, self.img_attn_pool.to_kv,
                  self.img_attn_pool.to_out):
            lecun_normal_(m.weight, m.in_features, generator)
        for ln in (self.img_attn_pool.norm, self.img_attn_pool.context_norm,
                   self.img_attn_pool_norm):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
        self.img_queries.normal_(0.0, self.text_width ** -0.5,
                                 generator=generator)
        return self

    def freeze(self) -> "LavilaNarrator":
        """LaViLa's narrator recipe: every GPT-2 leaf but the gated cross
        sub-blocks' (:data:`CROSS_LEAVES`) and the whole TimeSformer stop
        training; the queries and their pool keep training."""
        for name, p in self.text_decoder.named_parameters():
            if not any(t in name for t in CROSS_LEAVES):
                p.requires_grad_(False)
        self.visual.requires_grad_(False)
        return self

    def encode_image(self, video: torch.Tensor) -> torch.Tensor:
        """video [B, T, H, W, C] normalized -> [B, num_queries, text_w]."""
        with span("avion.tower.visual"), (
                torch.no_grad() if _frozen(self.visual)
                else contextlib.nullcontext()):
            tokens = self.visual(video, cls_at_last=False)
        tokens = backward_mark(tokens, "avion.tower.visual.bwd")
        with span("avion.tower.pool"):
            q = self.img_queries.to(self.dtype)[None].expand(
                tokens.shape[0], -1, -1)
            img = self.img_attn_pool_norm(
                self.img_attn_pool(q, tokens)).to(self.dtype)
        return backward_mark(img, "avion.tower.pool.bwd")

    def forward(self, video: torch.Tensor, text: torch.Tensor) -> dict:
        """Teacher-forced logits over ``text[:, :-1]`` predicting
        ``text[:, 1:]`` (``VCLM_HF.forward``)."""
        img = self.encode_image(video)
        with span("avion.tower.text"):
            logits = self.text_decoder(text[:, :-1], img)
        return {"logits": backward_mark(logits, "avion.tower.text.bwd"),
                "labels": text[:, 1:]}

    @staticmethod
    def _sample(logit: torch.Tensor, generator: Optional[torch.Generator],
                temperature: float, top_p: float) -> torch.Tensor:
        """Greedy (no generator) or nucleus sample from [B, V] logits."""
        logit = logit / max(temperature, 1e-6)
        if generator is None:
            return logit.argmax(dim=-1)
        sorted_logits = logit.sort(dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        # an index past the end takes the last, as JAX's gather clamps
        cutoff = sorted_logits.gather(
            -1, cutoff_idx.clamp_max(logit.shape[-1] - 1))
        filtered = torch.where(logit < cutoff, -1e30, logit)
        return categorical(filtered, generator)

    @torch.inference_mode()
    def generate(self, video: torch.Tensor, prompt: torch.Tensor, *,
                 max_len: int = 77, temperature: float = 0.7,
                 top_p: float = 0.95,
                 generator: Optional[torch.Generator] = None,
                 use_cache: bool = True) -> torch.Tensor:
        """Continue ``prompt`` [B, S0] given the clip; greedy without a
        ``generator``.  Returns [B, max_len] ids (int64)."""
        img = self.encode_image(video)
        b, s0 = prompt.shape
        tokens = torch.zeros(b, max_len, dtype=torch.long,
                             device=video.device)
        tokens[:, :s0] = prompt
        dec = self.text_decoder
        if use_cache:
            cross = dec.precompute_cross(img)
            kv = make_decode_cache(dec.layers, b, max_len, self.text_width,
                                   self.dtype, video.device)
            for i in range(1, max_len):
                # feed the token at i - 1 (the prompt's while i < s0);
                # the logits predict position i
                logit, kv = dec.decode_one(tokens[:, i - 1:i], i - 1, kv,
                                           cross)
                nxt = self._sample(logit, generator, temperature, top_p)
                if i >= s0:
                    tokens[:, i] = nxt
            return tokens
        for i in range(s0, max_len):
            logits = dec(tokens, img)
            tokens[:, i] = self._sample(logits[:, i - 1], generator,
                                        temperature, top_p)
        return tokens
