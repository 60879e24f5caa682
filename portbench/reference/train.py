"""The reference's first train steps: a family's loss and gradient
(``reference/<family>.py``), the recipe's clip by global norm, learning
rate and AdamW, over f32 copies of the benchmark's weights.

The recipe (``traffic["recipe"]``) as AVION's and VideoMAE's scripts give
it: a learning rate that warms up linearly from ``lr_start`` to ``lr``
over ``warmup_epochs`` and then follows a cosine to ``lr_end``, at the
update count (``steps_per_epoch`` updates an epoch), scaled by ``batch /
lr_scale_by_batch`` where that is set; gradients scaled by ``min(1, clip /
||g||)`` where ``grad_clip_norm`` is set; AdamW, ``m <- b1 m + (1 - b1)
g``, ``v <- b2 v + (1 - b2) g^2``, ``p <- p - lr ((m / (1 - b1^t)) /
(sqrt(v / (1 - b2^t)) + eps) + wd p)``, weight decay on weights of two or
more dimensions whose name holds none of ``bias``, ``pos``, ``embedding``,
``token`` and ``logit_scale``.  A weight the loss does not reach gets no
gradient and no update.

:func:`follow` returns the readings the comparison takes: each step's
loss, each weight's first gradient as the optimizer gets it (after the
clip; its values and its norm), and each weight's change after the last
step.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List

import torch

from portbench.reference.precision import matmul_for, strict_float32

NO_DECAY = ("bias", "pos", "embedding", "token", "logit_scale")


def learning_rate(recipe: dict, batch: int, count: int) -> float:
    base = recipe["lr"]
    if recipe.get("lr_scale_by_batch"):
        base = base * batch / recipe["lr_scale_by_batch"]
    per_epoch = recipe["steps_per_epoch"]
    warmup = int(recipe["warmup_epochs"] * per_epoch)
    total = int(recipe["epochs"] * per_epoch)
    count = min(count, total)
    if count < warmup:
        start = recipe["lr_start"]
        return start + (base - start) * count / max(warmup, 1)
    progress = (count - warmup) / max(total - warmup, 1)
    end = recipe["lr_end"]
    return end + 0.5 * (base - end) * (1 + math.cos(math.pi * progress))


def decays(name: str, p: torch.Tensor) -> bool:
    return p.dim() >= 2 and not any(t in name.lower() for t in NO_DECAY)


def follow(family: str, config: dict, traffic: dict,
           weights: Dict[str, torch.Tensor], batches: List[dict],
           steps: int, precision: str = "float32") -> dict:
    """``steps`` train steps from ``weights`` over ``batches[:steps]``."""
    strict_float32()
    model = importlib.import_module(f"portbench.reference.{family}")
    mm = matmul_for(precision)
    recipe = traffic["recipe"]
    if recipe["optimizer"] != "adamw":
        raise ValueError(f"the reference has AdamW only, not "
                         f"{recipe['optimizer']!r}")
    b1, b2 = recipe["betas"]
    params = {n: t.detach().clone().float().requires_grad_(True)
              for n, t in weights.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first_grad = [], {}
    for k in range(steps):
        for p in params.values():
            p.grad = None
        losses.append(model.loss_and_grad(config, traffic, params,
                                          batches[k], mm))
        live = {n: p for n, p in params.items() if p.grad is not None}
        with torch.no_grad():
            if recipe.get("grad_clip_norm"):
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(p.grad) for p in live.values()]))
                scale = (recipe["grad_clip_norm"] / norm).clamp(max=1.0)
                for p in live.values():
                    p.grad.mul_(scale)
            if k == 0:
                first_grad = {n: p.grad.detach().cpu()
                              for n, p in live.items()}
            lr = learning_rate(recipe, traffic["batch"], k)
            t = k + 1
            for n, p in live.items():
                g = p.grad
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m[n] / (1 - b1 ** t)) / (
                    (v[n] / (1 - b2 ** t)).sqrt() + recipe["eps"])
                if decays(n, p):
                    u = u + recipe["wd"] * p
                p.sub_(lr * u)
    with torch.no_grad():
        change = {n: (params[n] - weights[n].float()).cpu()
                  for n in first_grad}
    return {"loss": losses, "grad": {n: float(torch.linalg.vector_norm(g))
                                     for n, g in first_grad.items()},
            "grad_values": first_grad, "change": change}
