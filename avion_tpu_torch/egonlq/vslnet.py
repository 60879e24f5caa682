"""VSLNet span-localization head for Ego4D NLQ (``avion_tpu.egonlq.vslnet``).

The grounding head trained on frozen dual-encoder features (the
reference's ``egonlq/model/VSLNet.py`` and ``layers.py``):

- an input dropout and ``video_affine`` / ``query_affine`` to the model
  width; their input widths are the data's, not the config's (the flax
  ``Dense`` takes its width from the first batch);
- one ``feature_encoder`` for both the query and the video: a learned
  positional table, 4 x [LN, depthwise conv (k 7), pointwise conv, ReLU,
  dropout, residual] and a post-residual multi-head attention block;
- ``cq_attention`` (trilinear context-query attention; left out by the
  ``use_cq_attention=False`` "small" variant) and ``cq_concat`` (the
  query pooled by a learned weight, concatenated to every video row);
- a sigmoid highlight that weighs the features, then one
  ``predictor_encoder`` run twice (start, then end from start) and the
  start / end heads, masked to -1e30 outside the video.

Everything is f32 with no autocast: -1e30 overflows in half precision.
The depthwise convolution is 7 shifted f32 products over ``dw.i``'s
``Conv1d`` weight [dim, 1, 7], not a cuDNN call, so no TF32 enters its
forward or its backward; the matmuls are f32 under PyTorch's default
(``torch.backends.cuda.matmul.allow_tf32`` false).  The attention is plain
math, not the flash kernel: it holds at most ``max_pos_len`` rows and its
-1e30 mask must match the JAX module's within f32 rounding.

Dropout (9 sites, those of the flax module, the attention probabilities
and ``cq_attention``'s inputs among them) draws its keep mask from the
forward's ``generator`` and scales the kept values by ``1 / (1 - rate)``,
as flax does; the bits differ from ``jax.random``'s.

:func:`extract_top_spans` sorts with a stable descending sort, so tied
joint probabilities (the exact zeros of masked rows and of the lower
triangle) go to the lower flat index first, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avion_tpu_torch.losses.losses import softmax_cross_entropy
from avion_tpu_torch.models.layers import lecun_normal_

MASK_VALUE = -1e30
LN_EPS = 1e-6


def mask_logits(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return x + (1.0 - mask) * MASK_VALUE


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep each value with probability ``1 -
    rate`` (the mask drawn from ``generator``, on ``x``'s device) and scale
    the kept ones by ``1 / (1 - rate)``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def _depthwise(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Conv(dim, (k,), feature_group_count=dim, padding="SAME",
    use_bias=False)`` on x [B, L, C] with the ``Conv1d`` weight [C, 1, k]:
    a cross-correlation over L, zero padded to keep L."""
    k = weight.shape[-1]
    lo = (k - 1) // 2
    length = x.shape[1]
    xp = F.pad(x, (0, 0, lo, k - 1 - lo))
    w = weight[:, 0].t()  # [k, C]
    out = xp[:, :length] * w[0]
    for j in range(1, k):
        out = out + xp[:, j:j + length] * w[j]
    return out


class ConvBlock(nn.Module):
    """4x [LN -> depthwise conv(k) -> pointwise conv -> ReLU -> dropout ->
    +res]; the pointwise conv (a [1, dim, dim] kernel in flax) is a
    ``Linear``."""

    def __init__(self, dim: int, kernel_size: int = 7, num_layers: int = 4,
                 drop_rate: float = 0.0):
        super().__init__()
        self.drop_rate = drop_rate
        self.ln = nn.ModuleList(_layer_norm(dim) for _ in range(num_layers))
        self.dw = nn.ModuleList(
            nn.Conv1d(dim, dim, kernel_size, groups=dim, bias=False)
            for _ in range(num_layers))
        self.pw = nn.ModuleList(nn.Linear(dim, dim) for _ in range(num_layers))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for ln, dw, pw in zip(self.ln, self.dw, self.pw):
            h = F.relu(pw(_depthwise(ln(x), dw.weight)))
            x = dropout(h, self.drop_rate, deterministic, generator) + x
        return x


class AttentionBlock(nn.Module):
    """Post-residual multi-head attention block (``layers.py:252-323``)."""

    def __init__(self, dim: int, num_heads: int, drop_rate: float = 0.0):
        super().__init__()
        self.dim, self.num_heads, self.drop_rate = dim, num_heads, drop_rate
        self.ln_1 = _layer_norm(dim)
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.ln_2 = _layer_norm(dim)
        self.out_layer = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(t):
            return dropout(t, self.drop_rate, deterministic, generator)

        b, s, _ = x.shape
        hd = self.dim // self.num_heads
        h = drop(self.ln_1(x))

        def heads(t):
            return t.reshape(b, s, self.num_heads, hd).transpose(1, 2)

        q, k, v = (heads(f(h)) for f in (self.query, self.key, self.value))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            scores = mask_logits(scores, mask[:, None, None, :])
        probs = drop(torch.softmax(scores, dim=-1))
        out = (probs @ v).transpose(1, 2).reshape(b, s, self.dim)
        residual = drop(out) + x
        h = drop(self.out_layer(drop(self.ln_2(residual))))
        return h + residual


class FeatureEncoder(nn.Module):
    def __init__(self, dim: int, num_heads: int, max_pos_len: int,
                 kernel_size: int = 7, num_layers: int = 4,
                 drop_rate: float = 0.0):
        super().__init__()
        self.pos_embedding = nn.Embedding(max_pos_len, dim)
        self.conv_block = ConvBlock(dim, kernel_size, num_layers, drop_rate)
        self.attention_block = AttentionBlock(dim, num_heads, drop_rate)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.pos_embedding.weight[:x.shape[1]][None]
        x = self.conv_block(x, deterministic, generator)
        return self.attention_block(x, mask, deterministic, generator)


class CQAttention(nn.Module):
    def __init__(self, dim: int, drop_rate: float = 0.0):
        super().__init__()
        self.drop_rate = drop_rate
        self.w4C = nn.Parameter(torch.zeros(dim, 1))
        self.w4Q = nn.Parameter(torch.zeros(dim, 1))
        self.w4mlu = nn.Parameter(torch.zeros(1, 1, dim))
        self.cqa_linear = nn.Linear(4 * dim, dim)

    def forward(self, context: torch.Tensor, query: torch.Tensor,
                c_mask: torch.Tensor, q_mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = dropout(context, self.drop_rate, deterministic, generator)
        q = dropout(query, self.drop_rate, deterministic, generator)
        s0 = c @ self.w4C                               # [B, Lc, 1]
        s1 = (q @ self.w4Q).transpose(1, 2)             # [B, 1, Lq]
        s2 = (c * self.w4mlu) @ q.transpose(1, 2)       # [B, Lc, Lq]
        score = s0 + s1 + s2
        score_q = torch.softmax(mask_logits(score, q_mask[:, None, :]), dim=2)
        score_c = torch.softmax(mask_logits(score, c_mask[:, :, None]), dim=1)
        c2q = score_q @ query
        q2c = (score_q @ score_c.transpose(1, 2)) @ context
        out = torch.cat([context, c2q, context * c2q, context * q2c], dim=2)
        return self.cqa_linear(out)


class CQConcatenate(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.pool_weight = nn.Parameter(torch.zeros(dim, 1))
        self.concat_linear = nn.Linear(2 * dim, dim)

    def forward(self, context: torch.Tensor, query: torch.Tensor,
                q_mask: torch.Tensor) -> torch.Tensor:
        alpha = torch.softmax(
            mask_logits(query @ self.pool_weight, q_mask[:, :, None]), dim=1)
        pooled = (query.transpose(1, 2) @ alpha)[:, :, 0]  # [B, dim]
        pooled = pooled[:, None].expand_as(context)
        return self.concat_linear(torch.cat([context, pooled], dim=2))


class VSLNet(nn.Module):
    """video features [B, Lv, video_dim] + query features [B, Lq,
    query_dim] -> (highlight scores, start logits, end logits), each
    [B, Lv] f32.  ``use_cq_attention=False`` is the reference's "small"
    variant (``VSLNet_small.py:59-135``): the encoded video goes straight
    into ``cq_concat``."""

    def __init__(self, video_dim: int, query_dim: int, dim: int = 128,
                 num_heads: int = 8, max_pos_len: int = 128,
                 drop_rate: float = 0.2, use_cq_attention: bool = True):
        super().__init__()
        self.drop_rate = drop_rate
        self.video_affine = nn.Linear(video_dim, dim)
        self.query_affine = nn.Linear(query_dim, dim)
        self.feature_encoder = FeatureEncoder(dim, num_heads, max_pos_len,
                                              drop_rate=drop_rate)
        self.cq_attention = (CQAttention(dim, drop_rate) if use_cq_attention
                             else None)
        self.cq_concat = CQConcatenate(dim)
        self.highlight = nn.Linear(dim, 1)
        self.predictor_encoder = FeatureEncoder(dim, num_heads, max_pos_len,
                                                drop_rate=drop_rate)
        self.start_ln = _layer_norm(dim)
        self.end_ln = _layer_norm(dim)
        self.start_fc1 = nn.Linear(2 * dim, dim)
        self.start_fc2 = nn.Linear(dim, 1)
        self.end_fc1 = nn.Linear(2 * dim, dim)
        self.end_fc2 = nn.Linear(dim, 1)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "VSLNet":
        """flax's initializers, drawn from ``generator`` (on the
        parameters' device): dense and conv kernels lecun-normal
        (truncated; a depthwise kernel's fan-in is its width 7), zero
        biases, the positional tables normal(dim ** -0.5) (``nn.Embed``'s
        variance scaling), ``w4C`` / ``w4Q`` / ``w4mlu`` / ``pool_weight``
        xavier-uniform over flax's fans (in, out) = (dim, 1) or (1, dim),
        LayerNorm ones and zeros."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
            elif isinstance(m, nn.Conv1d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, m.embedding_dim ** -0.5,
                                 generator=generator)
            elif isinstance(m, (CQAttention, CQConcatenate)):
                for p in m.parameters(recurse=False):
                    limit = math.sqrt(6.0 / (p.numel() + 1))
                    p.uniform_(-limit, limit, generator=generator)
        return self

    def forward(self, video: torch.Tensor, v_mask: torch.Tensor,
                query: torch.Tensor, q_mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        v = dropout(video, self.drop_rate, deterministic, generator)
        v = self.video_affine(v)
        q = self.query_affine(query)
        encoder = self.feature_encoder
        q = encoder(q, q_mask, deterministic, generator)
        v = encoder(v, v_mask, deterministic, generator)
        feats = (v if self.cq_attention is None else self.cq_attention(
            v, q, v_mask, q_mask, deterministic, generator))
        feats = self.cq_concat(feats, q, q_mask)

        h_logits = self.highlight(feats)[:, :, 0]
        h_score = torch.sigmoid(mask_logits(h_logits, v_mask))
        feats = feats * h_score[:, :, None]

        pred = self.predictor_encoder
        start_f = pred(feats, v_mask, deterministic, generator)
        end_f = pred(start_f, v_mask, deterministic, generator)
        start_f = self.start_ln(start_f)
        end_f = self.end_ln(end_f)

        def block(fc1, fc2, f):
            h = F.relu(fc1(torch.cat([f, feats], dim=2)))
            return fc2(h)[:, :, 0]

        start_logits = mask_logits(
            block(self.start_fc1, self.start_fc2, start_f), v_mask)
        end_logits = mask_logits(block(self.end_fc1, self.end_fc2, end_f),
                                 v_mask)
        return h_score, start_logits, end_logits


def highlight_loss(scores: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Weighted BCE on saliency (``layers.py:458-466``): positive locations
    weighted 2x.  Select-then-log: the sigmoid saturates to exactly 0 or 1
    in f32, and the where picks one finite log."""
    labels = labels.float()
    weights = torch.where(labels == 0.0, 1.0, 2.0 * labels)
    log_p = torch.log(scores.clamp_min(eps))
    log_1mp = torch.log((1.0 - scores).clamp_min(eps))
    bce = -torch.where(labels > 0.5, labels * log_p, log_1mp)
    mask = mask.float()
    return (bce * weights * mask).sum() / (mask.sum() + eps)


def span_loss(start_logits: torch.Tensor, end_logits: torch.Tensor,
              start_labels: torch.Tensor,
              end_labels: torch.Tensor) -> torch.Tensor:
    return (softmax_cross_entropy(start_logits, start_labels.long())
            + softmax_cross_entropy(end_logits, end_labels.long()))


def vslnet_loss(h_score, start_logits, end_logits, batch: dict,
                highlight_weight: float = 5.0):
    """Total loss (``egonlq/main.py:335-341``): span CE + lambda *
    highlight BCE.  Returns (loss, {"span_loss", "highlight_loss"})."""
    hl = highlight_loss(h_score, batch["h_labels"], batch["v_mask"])
    sl = span_loss(start_logits, end_logits, batch["start_label"],
                   batch["end_label"])
    return sl + highlight_weight * hl, {"span_loss": sl, "highlight_loss": hl}


def extract_top_spans(start_logits: torch.Tensor, end_logits: torch.Tensor,
                      k: int = 5):
    """Top-k (start, end) index pairs [B, k] from the upper-triangular
    joint distribution (``layers.py:555-570``), ties to the lower flat
    index first."""
    sp = torch.softmax(start_logits, dim=-1)
    ep = torch.softmax(end_logits, dim=-1)
    outer = torch.triu(sp[:, :, None] * ep[:, None, :])
    w = outer.shape[-1]
    flat = outer.reshape(outer.shape[0], -1)
    idx = torch.sort(flat, dim=-1, descending=True, stable=True).indices[:, :k]
    return idx // w, idx % w
