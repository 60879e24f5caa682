"""Training losses (``avion_tpu.losses.losses``): softmax cross-entropy
with label smoothing, cross-entropy against soft targets (mixup / cutmix),
the symmetric InfoNCE ``clip_loss`` over one device's batch (logits in f32)
and VideoMAE's normalized-pixel MSE.  SigLIP and the gathered global batch
of several devices wait for later slices."""

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
