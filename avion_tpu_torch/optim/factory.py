"""Optimizer (``avion_tpu.optim.factory``): the optax chain
``clip_by_global_norm -> adamw(schedule, mask=wd_mask)`` as one object.

- Weight decay follows ``wd_mask``: parameters with two or more dimensions
  whose name holds none of ``_NO_WD_TOKENS`` decay, the rest do not; they
  become AdamW's two parameter groups.  ``torch.optim.AdamW`` and
  ``optax.adamw`` both decay as ``lr * wd * p``, decoupled from the moments,
  and add eps outside the square root.
- Clipping scales every gradient by ``max / ||g||`` when ``||g|| >= max``,
  as ``optax.clip_by_global_norm`` does (``clip_grad_norm_`` divides by
  ``||g|| + 1e-6``), without a host read.
- The learning rate is the schedule at the optimizer's own update count,
  which starts at 0 on the first update and advances only when an update
  is applied (optax's schedule count); it is part of the state dict.

SGD, Lion, layer decay, ``wd_end``, bf16 state and ``update_freq`` wait
for later slices and raise when asked for.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import torch

from avion_tpu_torch.optim.schedules import cosine_schedule

_NO_WD_TOKENS = (
    "bias", "norm", "ln_", "positional_embedding", "temporal_embedding",
    "class_embedding", "logit_scale", "token_embedding", "mask_token",
    "gamma", "fc_norm",
)


def wd_mask(name: str, param: torch.Tensor) -> bool:
    """True where weight decay applies: ndim >= 2 and no excluded token in
    the (lower-cased) name."""
    name = name.lower()
    return param.dim() >= 2 and not any(t in name for t in _NO_WD_TOKENS)


def build_schedule(cfg, niter_per_ep: int) -> Callable[[int], float]:
    if cfg.fix_lr:
        return lambda step: cfg.lr
    return cosine_schedule(cfg.lr, cfg.lr_end, cfg.epochs, niter_per_ep,
                           cfg.warmup_epochs, cfg.lr_start)


def _unported(cfg) -> List[str]:
    asked = []
    if cfg.optimizer.lower() != "adamw":
        asked.append(f"optimizer={cfg.optimizer!r}")
    if cfg.layer_decay:
        asked.append(f"layer_decay={cfg.layer_decay}")
    if cfg.wd_end is not None and cfg.wd_end != cfg.wd:
        asked.append(f"wd_end={cfg.wd_end}")
    if cfg.state_dtype not in ("", "float32"):
        asked.append(f"state_dtype={cfg.state_dtype!r}")
    if cfg.update_freq > 1:
        asked.append(f"update_freq={cfg.update_freq}")
    return asked


class Optimizer:
    """Clip, schedule and AdamW over named parameters."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], cfg,
                 schedule: Callable[[int], float]):
        asked = _unported(cfg)
        if asked:
            raise NotImplementedError(
                "not in the PyTorch port yet: " + ", ".join(asked))
        decay, no_decay = [], []
        for name, p in named_params:
            if p.requires_grad:
                (decay if wd_mask(name, p) else no_decay).append(p)
        self.params = decay + no_decay
        self.schedule = schedule
        self.grad_clip_norm = cfg.grad_clip_norm
        self.count = 0  # updates applied
        self.adamw = torch.optim.AdamW(
            [{"params": decay, "weight_decay": cfg.wd},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=schedule(0), betas=tuple(cfg.betas), eps=cfg.eps)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    def global_norm(self) -> torch.Tensor:
        """L2 norm of all gradients (``optax.global_norm``), on device."""
        grads = self._grads()
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))

    def update(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """Clip (given the gradients' ``global_norm``), set the scheduled
        learning rate, step AdamW, advance the count."""
        if self.grad_clip_norm:
            if grad_norm is None:
                grad_norm = self.global_norm()
            scale = (self.grad_clip_norm / grad_norm).clamp(max=1.0)
            torch._foreach_mul_(self._grads(), scale)
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def build_optimizer(cfg, model: torch.nn.Module, niter_per_ep: int
                    ) -> Tuple[Optimizer, Callable[[int], float]]:
    """From an ``OptimConfig``; returns (optimizer, lr schedule)."""
    schedule = build_schedule(cfg, niter_per_ep)
    return Optimizer(model.named_parameters(), cfg, schedule), schedule
