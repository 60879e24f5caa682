"""Contrastive losses (``avion_tpu.losses.losses``): softmax cross-entropy
with label smoothing and the symmetric InfoNCE ``clip_loss`` over one
device's batch, logits in f32.  SigLIP and the gathered global batch of
several devices wait for later slices."""

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
