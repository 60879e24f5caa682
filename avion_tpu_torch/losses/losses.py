"""Training losses (``avion_tpu.losses.losses``): softmax cross-entropy
with label smoothing, cross-entropy against soft targets (mixup / cutmix),
the symmetric InfoNCE ``clip_loss`` over one device's batch (logits in f32),
SigLIP's sigmoid loss, EK100-MIR's max-margin ranking loss and VideoMAE's
normalized-pixel MSE.  The gathered global batch of several devices and
SigLIP's ring over them wait for the parallel slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
              logit_scale: torch.Tensor, label_smoothing: float = 0.0
              ) -> dict:
    """Symmetric InfoNCE; embeddings L2-normalized.  Returns
    ``{"loss", "clip_acc"}`` (accuracy in percent, no gradient)."""
    logits = logit_scale * image_embed.float() @ text_embed.float().T
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = (softmax_cross_entropy(logits, labels, label_smoothing)
            + softmax_cross_entropy(logits.T, labels, label_smoothing)) / 2
    pred = logits.detach().argmax(dim=-1)
    acc = 100.0 * (pred == labels).float().mean()
    return {"loss": loss, "clip_acc": acc}


def siglip_loss(image_embed: torch.Tensor, text_embed: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: torch.Tensor) -> dict:
    """Sigmoid contrastive loss (SigLIP, arXiv:2303.15343) in f32: every
    (image, text) pair is a binary classification, ``-sum(logsigmoid(z *
    (s i t^T + b))) / B`` with ``z`` +1 on the diagonal and -1 off it;
    embeddings L2-normalized.  Returns ``{"loss", "clip_acc"}`` (argmax
    accuracy in percent, no gradient)."""
    img, txt = image_embed.float(), text_embed.float()
    b = img.shape[0]
    logits = logit_scale * img @ txt.T + logit_bias
    z = 2.0 * torch.eye(b, device=logits.device) - 1.0
    loss = -F.logsigmoid(z * logits).sum() / b
    pred = logits.detach().argmax(dim=-1)
    acc = 100.0 * (pred == torch.arange(b, device=logits.device)).float(
    ).mean()
    return {"loss": loss, "clip_acc": acc}


def siglip_loss_chunked(image_embed: torch.Tensor, text_embed: torch.Tensor,
                        logit_scale: torch.Tensor,
                        logit_bias: torch.Tensor) -> dict:
    """SigLIP blockwise around the ring of processes that share the batch
    (``avion_tpu.losses.siglip_loss_chunked``).  With one process it is
    :func:`siglip_loss`, as the JAX wrapper falls back when no batch axis
    is sharded; the ring comes with the parallel slice, and a process group
    of more than one raises until then."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "SigLIP's ring over several processes comes with the parallel "
            "slice (ROADMAP.md Queue 1, item 7)")
    return siglip_loss(image_embed, text_embed, logit_scale, logit_bias)


def max_margin_ranking_loss(image_embed: torch.Tensor,
                            text_embed: torch.Tensor, margin: float = 0.2,
                            fix_norm: bool = True, eps: float = 1e-8) -> dict:
    """Bidirectional hinge ``relu(margin - sim(i, i) + sim(i, j))`` over the
    row and the column negatives of ``sim(text, image)``, on L2-normalized
    f32 embeddings (norms clamped at ``eps``).  With ``fix_norm`` the
    diagonal is left out and the sum divided by ``2 n (n - 1)``, else
    ``2 n n``.  Returns ``{"loss", "max_margin_loss"}``."""
    a = text_embed.float()
    b = image_embed.float()
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
