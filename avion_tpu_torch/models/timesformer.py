"""TimeSformer (``SpaceTimeTransformer``), the LaViLa narrator's vision
tower (``avion_tpu.models.timesformer``): divided space-time attention in
the "frozen-in-time" style.

Block semantics (``SpaceTimeBlock.forward``)::

    t = timeattn(norm3(x));  t = tanh(alpha_timeattn) * t   [if gated]
    time_residual = x + t
    s = attn(norm1(time_residual))
    space_residual = x + s          # the residual is taken from x
    x = space_residual + mlp(norm2(space_residual))

Both divided attentions keep the CLS token global: the CLS query attends
over every token; the patch queries attend within their frame (space) or
across the frames at their grid position (time), each group joined by the
CLS key and value.  On the CPU, and in an f32 tower (EgoVLP's), the
attention is plain f32 math (the JAX package runs it as XLA math, no
kernel).  A bf16 tower on CUDA runs each mode through the flash kernels
of ``ops.flash_attention`` over regrouped operands: the fused qkv rows
copied into one sequence a group, the CLS row's q, k and v in front
(space: B * T sequences of 1 + n rows; time: B * n of 1 + T; at most the
kernels' batch a call), whose CLS row output is dropped; the CLS query's
attention over all 1 + T * n keys is two small bf16 products
(:func:`_cls_attend`).  Without a gradient to take this is the inference
kernel, with one the forward with lse and its backward.  Under a profiler
each mode's attention (after the qkv projection, up to the output
projection) is the span ``avion.attn.space`` or ``avion.attn.time``.
Patchify is one dense product over channel-first patch vectors, with the
released Conv2d weight [D, C, p, p] flattened in that order.  LayerNorms
are f32 with eps 1e-6.

Parameter names and shapes are the released checkpoint's
(``visual.patch_embed.proj``, ``cls_token`` [1, 1, D], ``pos_embed``
[1, n + 1, D], ``temporal_embed`` [1, T, D], ``blocks.{i}.{norm1, norm2,
norm3, attn.qkv, attn.proj, timeattn.qkv, timeattn.proj, mlp.fc1,
mlp.fc2}``), so such a state dict loads with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from avion_tpu_torch.core.profiling import span
from avion_tpu_torch.models.layers import (LayerNorm, Mlp, dense,
                                           lecun_normal_, quick_gelu)
from avion_tpu_torch.ops.flash_attention import (MAX_BATCH,
                                                 flash_attention_fused_qkv)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Softmax attention over [..., S, D] in f32."""
    logits = q.float() @ k.float().transpose(-1, -2) / math.sqrt(q.shape[-1])
    return torch.softmax(logits, dim=-1) @ v.float()


def _cls_attend(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """The CLS query (row 0) over every key of a fused ``qkv`` [B, S, 3W],
    in ``qkv``'s dtype: [B, 1, W].  Two batched products read k and v in
    place: the scores [B, S, H] against the CLS query laid out block-
    diagonally [B, W, H] (head h's q in rows h * D to (h + 1) * D of column
    h), and every head's weights against all of v, [B, H, W], whose
    diagonal blocks are the heads' outputs."""
    b, s, w3 = qkv.shape
    w = w3 // 3
    d = w // heads
    q = qkv[:, 0, :w] * (1.0 / math.sqrt(d))
    eye = torch.eye(heads, dtype=q.dtype, device=q.device)
    q_blocks = (q.reshape(b, heads, d, 1) * eye[:, None]).reshape(b, w, heads)
    p = torch.softmax(torch.bmm(qkv[..., w:2 * w], q_blocks), dim=1)
    o = torch.bmm(p.transpose(1, 2), qkv[..., 2 * w:])  # [B, H, W]
    o = o.reshape(b, heads, heads, d).diagonal(dim1=1, dim2=2)  # [B, D, H]
    return o.transpose(1, 2).reshape(b, 1, w)


class DividedAttention(nn.Module):
    """One divided attention: CLS-global plus grouped patch attention."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mode: str, f: int,
                n: int) -> torch.Tensor:
        """x: [B, 1 + f*n, W], the patch tokens frame-major."""
        qkv = dense(x.to(self.dtype), self.qkv)
        with span(f"avion.attn.{mode}"):
            out = (self.grouped(qkv, mode, f, n)
                   if qkv.is_cuda and qkv.dtype == torch.bfloat16
                   else self.plain(qkv, mode, f, n))
        return dense(out, self.proj)

    def plain(self, qkv: torch.Tensor, mode: str, f: int,
              n: int) -> torch.Tensor:
        """The attention of a fused ``qkv`` [B, S, 3W] in f32 math."""
        b, s, w3 = qkv.shape
        h = self.heads
        d = w3 // 3 // h
        qkv = qkv.reshape(b, s, 3, h, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [B, H, S, D] each
        cls_out = _attend(q[:, :, :1], k, v)  # the CLS query sees all

        def group(t):
            t = t[:, :, 1:].reshape(b, h, f, n, d)
            return t if mode == "space" else t.transpose(2, 3)

        qg, kg, vg = group(q), group(k), group(v)
        g = qg.shape[2]  # f groups (space) or n (time)
        # the CLS key and value join every group
        kg = torch.cat([k[:, :, None, :1].expand(b, h, g, 1, d), kg], dim=3)
        vg = torch.cat([v[:, :, None, :1].expand(b, h, g, 1, d), vg], dim=3)
        out = _attend(qg, kg, vg)
        if mode == "time":
            out = out.transpose(2, 3)
        out = torch.cat([cls_out, out.reshape(b, h, f * n, d)], dim=2)
        return out.transpose(1, 2).reshape(b, s, h * d).to(self.dtype)

    def grouped(self, qkv: torch.Tensor, mode: str, f: int,
                n: int) -> torch.Tensor:
        """The attention of a fused ``qkv`` [B, S, 3W] through
        ``flash_attention_fused_qkv``, one sequence a group, at most
        ``MAX_BATCH`` sequences a call (the plain version of the kernels on
        a CPU tensor)."""
        b, s, w3 = qkv.shape
        w = w3 // 3
        patches = qkv[:, 1:].reshape(b, f, n, w3)
        if mode == "time":
            patches = patches.transpose(1, 2)
        g, m = patches.shape[1], patches.shape[2]
        seqs = qkv.new_empty(b, g, 1 + m, w3)
        seqs[:, :, :1] = qkv[:, None, :1]
        seqs[:, :, 1:] = patches
        o = [flash_attention_fused_qkv(c, self.heads, 1 + m) for c in
             seqs.view(b * g, 1 + m, w3).split(MAX_BATCH)]
        o = o[0] if len(o) == 1 else torch.cat(o)
        o = o.reshape(b, g, 1 + m, w)[:, :, 1:]  # each group's CLS row out
        if mode == "time":
            o = o.transpose(1, 2)
        out = qkv.new_empty(b, s, w)
        out[:, :1] = _cls_attend(qkv, self.heads)
        out[:, 1:].view(b, f, n, w).copy_(o)
        return out


class SpaceTimeBlock(nn.Module):
    def __init__(self, width: int, heads: int, act=quick_gelu,
                 dtype: torch.dtype = torch.float32,
                 gated_timeattn: bool = False, ln_eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(width, torch.float32, ln_eps)
        self.norm2 = LayerNorm(width, torch.float32, ln_eps)
        self.norm3 = LayerNorm(width, torch.float32, ln_eps)
        self.attn = DividedAttention(width, heads, dtype)
        self.timeattn = DividedAttention(width, heads, dtype)
        self.mlp = Mlp(width, act)  # hidden width 4x, the mlp_ratio used
        self.alpha_timeattn = (nn.Parameter(torch.zeros(()))
                               if gated_timeattn else None)

    def forward(self, x: torch.Tensor, f: int, n: int) -> torch.Tensor:
        t = self.timeattn(self.norm3(x), "time", f, n)
        if self.alpha_timeattn is not None:
            t = torch.tanh(self.alpha_timeattn) * t.float()
        time_residual = x + t
        s = self.attn(self.norm1(time_residual), "space", f, n)
        space_residual = x + s  # frozen-in-time: the residual from x
        return space_residual + self.mlp(
            self.norm2(space_residual).to(self.dtype))


class PatchEmbed(nn.Module):
    """The released ``patch_embed.proj`` Conv2d, applied as one dense
    product over channel-first patch vectors."""

    def __init__(self, width: int, patch_size: int, bias: bool,
                 channels: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(channels, width, patch_size, patch_size,
                              bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, H, W, C] -> [B, T * gh * gw, width]."""
        b, t, hh, ww, c = x.shape
        p = self.proj.kernel_size[0]
        gh, gw = hh // p, ww // p
        x = x.reshape(b, t, gh, p, gw, p, c).permute(0, 1, 2, 4, 6, 3, 5)
        x = x.reshape(b, t * gh * gw, c * p * p)
        w = self.proj.weight.reshape(self.proj.out_channels, -1)
        bias = None if self.proj.bias is None else self.proj.bias.to(x.dtype)
        return F.linear(x, w.to(x.dtype), bias)


class SpaceTimeTransformer(nn.Module):
    """LaViLa / frozen-in-time video ViT (the CLIP-initialized ``ln_pre``
    flavour, whose patch embedding has no bias).  Returns every token
    [B, 1 + f*n, W] (``cls_at_last=False``, the narrator's path) or the
    CLS feature [B, W]."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_frames: int = 4, width: int = 1024, layers: int = 24,
                 heads: int = 16, act=quick_gelu,
                 ln_pre: bool = True, gated_timeattn: bool = False,
                 ln_eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.width = width
        n = (image_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(width, patch_size, bias=not ln_pre)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, width))
        self.temporal_embed = nn.Parameter(torch.zeros(1, num_frames, width))
        self.ln_pre = (LayerNorm(width, torch.float32, ln_eps) if ln_pre
                       else None)
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(width, heads, act, dtype, gated_timeattn, ln_eps)
            for _ in range(layers))
        self.norm = LayerNorm(width, torch.float32, ln_eps)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "SpaceTimeTransformer":
        """The flax initializers: the patch kernel and dense kernels
        lecun-normal (truncated) with zero biases, LayerNorm ones and zeros,
        ``cls_token`` and ``temporal_embed`` zeros, ``pos_embed``
        normal(0.02), the time gates zeros."""
        proj = self.patch_embed.proj
        lecun_normal_(proj.weight, proj.weight[0].numel(), generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        if proj.bias is not None:
            proj.bias.zero_()
        self.cls_token.zero_()
        self.temporal_embed.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for blk in self.blocks:
            if blk.alpha_timeattn is not None:
                blk.alpha_timeattn.zero_()
        return self

    def forward(self, x: torch.Tensor,
                cls_at_last: bool = False) -> torch.Tensor:
        """x: [B, T, H, W, C] float (normalized)."""
        b, t = x.shape[:2]
        dt = self.dtype
        x = self.patch_embed(x.to(dt))
        pos, tpos = self.pos_embed[0], self.temporal_embed[0]
        x = x.reshape(b, t, -1, self.width)
        n = x.shape[2]
        x = x + pos[1:].to(dt)[None, None]
        x = x + tpos[:t].to(dt)[None, :, None]
        x = x.reshape(b, t * n, self.width)
        cls_tok = (self.cls_token[0, 0] + pos[0]).to(dt)
        x = torch.cat([cls_tok.expand(b, 1, -1), x], dim=1)
        if self.ln_pre is not None:
            x = self.ln_pre(x).to(dt)
        for blk in self.blocks:
            x = blk(x, t, n)
        x = self.norm(x)
        return (x[:, 0] if cls_at_last else x).to(dt)
