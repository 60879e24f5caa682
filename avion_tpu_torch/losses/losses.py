"""Training losses (``avion_tpu.losses.losses``): softmax cross-entropy
with label smoothing, cross-entropy against soft targets (mixup / cutmix),
the symmetric InfoNCE ``clip_loss`` (logits in f32), SigLIP's sigmoid loss
and its chunked ring, EK100-MIR's max-margin ranking loss and VideoMAE's
normalized-pixel MSE.

Over a batch group of several ranks (``group``, the mesh's
``batch_group``), ``clip_loss``, ``siglip_loss`` and
``max_margin_ranking_loss`` see the global batch through :func:`gather_batch`, an all-gather whose backward sums the
cotangents of every rank (a reduce-scatter), and
:func:`siglip_loss_chunked` runs the ring of ``_siglip_ring_local``.  Every
rank gets the global loss, and its gradients are those whose average over
the ranks, as DDP and FSDP take it, is the gradient of the global loss:
n times its rows' share for the embeddings of a group of n, the whole
gradient for the logit scale and bias.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _size(group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


class _GatherBatch(torch.autograd.Function):
    """All-gather along dim 0; the backward sums every rank's cotangent
    and keeps this rank's rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        n = _size(ctx.group)
        return g.chunk(n)[dist.get_rank(ctx.group)], None


def gather_batch(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` [b_local, ...] of every rank of ``group``, in rank order, as
    [n * b_local, ...]; differentiable (see :class:`_GatherBatch`).  The
    identity without a group of more than one."""
    if _size(group) == 1:
        return x
    return _GatherBatch.apply(x, group)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over integer labels; logits [N, C] in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll.mean()


def clip_loss(image_embed: torch.Tensor, text_embed: torch.Tensor,
              logit_scale: torch.Tensor, label_smoothing: float = 0.0,
              group=None) -> dict:
    """Symmetric InfoNCE over the global batch of ``group`` (this rank's
    rows without one); embeddings L2-normalized.  Returns ``{"loss",
    "clip_acc"}`` (accuracy in percent, no gradient)."""
    image_embed = gather_batch(image_embed, group)
    text_embed = gather_batch(text_embed, group)
    logits = logit_scale * image_embed.float() @ text_embed.float().T
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = (softmax_cross_entropy(logits, labels, label_smoothing)
            + softmax_cross_entropy(logits.T, labels, label_smoothing)) / 2
    pred = logits.detach().argmax(dim=-1)
    acc = 100.0 * (pred == labels).float().mean()
    return {"loss": loss, "clip_acc": acc}


def siglip_loss(image_embed: torch.Tensor, text_embed: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                group=None) -> dict:
    """Sigmoid contrastive loss (SigLIP, arXiv:2303.15343) in f32 over the
    global batch of ``group``: every (image, text) pair is a binary
    classification, ``-sum(logsigmoid(z * (s i t^T + b))) / B`` with ``z``
    +1 on the diagonal and -1 off it; embeddings L2-normalized.  Returns
    ``{"loss", "clip_acc"}`` (argmax accuracy in percent, no gradient)."""
    img = gather_batch(image_embed, group).float()
    txt = gather_batch(text_embed, group).float()
    b = img.shape[0]
    logits = logit_scale * img @ txt.T + logit_bias
    z = 2.0 * torch.eye(b, device=logits.device) - 1.0
    loss = -F.logsigmoid(z * logits).sum() / b
    pred = logits.detach().argmax(dim=-1)
    acc = 100.0 * (pred == torch.arange(b, device=logits.device)).float(
    ).mean()
    return {"loss": loss, "clip_acc": acc}


class _SiglipRing(torch.autograd.Function):
    """``_siglip_ring_local``: this rank's image rows against every text
    chunk as the chunks rotate around ``group`` (``ops.ring_attention.
    rotate``), one [b_local, D] block a hop; the backward runs the ring
    again with each chunk's f32 gradient riding beside it, and one last
    rotation brings it home."""

    @staticmethod
    def forward(ctx, img, txt, scale, bias, group):
        from avion_tpu_torch.ops.ring_attention import rotate

        n, b = _size(group), img.shape[0]
        i32, t32 = img.float(), txt.float()
        z = 2.0 * torch.eye(b, device=img.device) - 1.0
        logits = scale * i32 @ t32.T + bias
        loss = -F.logsigmoid(z * logits).sum()
        pos, row_max = logits.diagonal(), logits.amax(dim=-1)
        t = t32
        for _ in range(1, n):
            (t,) = rotate([t], group)
            logits = scale * i32 @ t.T + bias
            loss = loss - F.logsigmoid(-logits).sum()
            row_max = torch.maximum(row_max, logits.amax(dim=-1))
        # exact global retrieval accuracy: the positive is the row max
        acc = (pos >= row_max).float().mean()
        stats = torch.stack([loss, acc])
        dist.all_reduce(stats, group=group)
        ctx.save_for_backward(i32, t32, scale, bias)
        ctx.group, ctx.dtypes = group, (img.dtype, txt.dtype)
        return stats[0] / (n * b), 100.0 * stats[1] / n

    @staticmethod
    def backward(ctx, g_loss, _g_acc):
        from avion_tpu_torch.ops.ring_attention import rotate

        i32, t32, scale, bias = ctx.saved_tensors
        group = ctx.group
        n, b = _size(group), i32.shape[0]
        # n times this rank's share of d loss / d logits: the gradient of
        # the global loss once the ranks' gradients are averaged
        c = g_loss / b
        z = 2.0 * torch.eye(b, device=i32.device) - 1.0

        def block(t, own: bool):
            sim = i32 @ t.T
            zz = z if own else -1.0
            dl = -zz * torch.sigmoid(-zz * (scale * sim + bias)) * c
            return (dl @ t * scale, dl.T @ i32 * scale,
                    torch.stack([(dl * sim).sum(), dl.sum()]))

        d_img, d_txt, d_sb = block(t32, True)
        t = t32
        for _ in range(1, n):
            t, d_txt = rotate([t, d_txt], group)
            di, dt, dsb = block(t, False)
            d_img, d_txt, d_sb = d_img + di, d_txt + dt, d_sb + dsb
        (d_txt,) = rotate([d_txt], group)
        # the scale's and bias's whole gradient on every rank
        dist.all_reduce(d_sb, group=group)
        d_sb = d_sb / n
        return (d_img.to(ctx.dtypes[0]), d_txt.to(ctx.dtypes[1]),
                d_sb[0].reshape(scale.shape).to(scale.dtype),
                d_sb[1].reshape(bias.shape).to(bias.dtype), None)


def siglip_loss_chunked(image_embed: torch.Tensor, text_embed: torch.Tensor,
                        logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                        group=None) -> dict:
    """SigLIP blockwise around the ring of the ranks of ``group``
    (``avion_tpu.losses.siglip_loss_chunked``): each rank scores its image
    rows against every text chunk as the chunks rotate, never forming the
    [B, B] matrix.  Without a group of more than one it is
    :func:`siglip_loss`, as the JAX wrapper falls back when no batch axis
    is sharded."""
    if _size(group) == 1:
        return siglip_loss(image_embed, text_embed, logit_scale, logit_bias)
    loss, acc = _SiglipRing.apply(image_embed, text_embed, logit_scale,
                                  logit_bias, group)
    return {"loss": loss, "clip_acc": acc.detach()}


def max_margin_ranking_loss(image_embed: torch.Tensor,
                            text_embed: torch.Tensor, margin: float = 0.2,
                            fix_norm: bool = True, eps: float = 1e-8,
                            group=None) -> dict:
    """Bidirectional hinge ``relu(margin - sim(i, i) + sim(i, j))`` over the
    row and the column negatives of ``sim(text, image)``, on L2-normalized
    f32 embeddings (norms clamped at ``eps``), over the global batch of
    ``group`` (this rank's rows without one).  With ``fix_norm`` the
    diagonal is left out and the sum divided by ``2 n (n - 1)``, else
    ``2 n n``, n the global batch.  Returns ``{"loss",
    "max_margin_loss"}``."""
    a = gather_batch(text_embed, group).float()
    b = gather_batch(image_embed, group).float()
    a = a / a.norm(dim=-1, keepdim=True).clamp_min(eps)
    b = b / b.norm(dim=-1, keepdim=True).clamp_min(eps)
    x = a @ b.T
    n = x.shape[0]
    diag = x.diagonal()[:, None]
    row = torch.relu(margin - diag + x)
    col = torch.relu(margin - diag + x.T)
    if fix_norm:
        off = 1.0 - torch.eye(n, device=x.device)
        loss = ((row * off).sum() + (col * off).sum()) / (2.0 * n * (n - 1))
    else:
        loss = (row.sum() + col.sum()) / (2.0 * n * n)
    return {"loss": loss, "max_margin_loss": loss}


def soft_target_cross_entropy(logits: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
    """Mean CE against a full target distribution (mixup / cutmix)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return (-targets * logp).sum(dim=-1).mean()


def videomae_loss(pred: torch.Tensor, video: torch.Tensor,
                  masked_idx: torch.Tensor, patch_size: int,
                  tubelet_size: int, normalize_target: bool = True) -> dict:
    """MSE between ``pred`` and the masked tubes' pixels, each tube's
    target normalized per channel over its spatial elements (mean, unbiased
    variance, ``sqrt(var) + 1e-6``), in f32.  Returns ``{"loss"}``."""
    from avion_tpu_torch.models.videomae import tube_patchify

    tubes = tube_patchify(video.float(), patch_size, tubelet_size)
    if normalize_target:
        b, n, d = tubes.shape
        spatial = tubelet_size * patch_size * patch_size
        ch = tubes.reshape(b, n, spatial, d // spatial)
        mean = ch.mean(dim=-2, keepdim=True)
        var = ch.var(dim=-2, keepdim=True, correction=1)
        tubes = ((ch - mean) / (var.sqrt() + 1e-6)).reshape(b, n, d)
    target = tubes.gather(1, masked_idx[..., None].expand(-1, -1,
                                                          tubes.shape[-1]))
    return {"loss": ((pred.float() - target) ** 2).mean()}
