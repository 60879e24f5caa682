"""Optimizer (``avion_tpu.optim.factory``): the optax chain
``clip_by_global_norm -> core -> layer-decay scale`` as one object, whose
core is AdamW, SGD with momentum or Lion.

- Weight decay follows ``wd_mask``: parameters with two or more dimensions
  whose name holds none of ``_NO_WD_TOKENS`` decay, the rest do not; they
  become the core's parameter groups.
  - AdamW: ``torch.optim.AdamW`` and ``optax.adamw`` both decay as
    ``lr * wd * p``, decoupled from the moments, and add eps outside the
    square root.
  - SGD: optax adds ``wd * p`` to the gradient before ``sgd``'s momentum
    trace (no dampening, no Nesterov), which is ``torch.optim.SGD``'s
    coupled ``weight_decay``.
  - Lion (``optax.lion``; PyTorch has none): ``u = sign(b1 m + (1 - b1)
    g)``, ``m <- b2 m + (1 - b2) g``, ``p <- p - lr (u + wd p)``.
  - ``wd_end``: the decay follows a cosine from ``wd`` to ``wd_end`` over
    the whole run, no warmup, at the optimizer's update count; it is set on
    each decayed group before every update, for all three cores.
- Clipping scales every gradient by ``max / ||g||`` when ``||g|| >= max``,
  as ``optax.clip_by_global_norm`` does (``clip_grad_norm_`` divides by
  ``||g|| + 1e-6``), without a host read.
- The learning rate is the schedule at the optimizer's own update count,
  which starts at 0 on the first update and advances only when an update
  is applied (optax's schedule count); it is part of the state dict.
- Layer decay (``layer_decay`` with the model's ``num_layers``): the JAX
  chain scales the core's whole update of a parameter by ``decay **
  (layers + 1 - depth)``; here that is one parameter group per (depth,
  weight decay or not) whose learning rate is the schedule times that
  scale.

bf16 state and ``update_freq`` wait for the contrastive-extras slice
(``ROADMAP.md`` Queue 1, item 6) and raise when asked for.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

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


def block_depth(name: str, num_layers: int) -> int:
    """Layer-decay depth: the embeddings 0, ``resblocks.i`` i + 1, the rest
    (norms, heads) ``num_layers + 1``."""
    m = re.search(r"resblocks\.(\d+)", name)
    if m:
        return int(m.group(1)) + 1
    if any(t in name for t in ("patch_embed", "conv1", "class_embedding",
                               "positional_embedding", "temporal_embedding",
                               "token_embedding")):
        return 0
    return num_layers + 1


def layer_decay_scale(name: str, num_layers: int, decay: float) -> float:
    return decay ** (num_layers + 1 - block_depth(name.lower(), num_layers))


def apply_batch_lr_scale(cfg, global_batch: int, default_base: int = 0):
    """Linear scaling for the finetunes: ``lr *= global_batch / base``
    (base ``lr_scale_by_batch``, else ``default_base``); clears the knob so
    a second call cannot compound."""
    base = cfg.lr_scale_by_batch or default_base
    if base:
        cfg.lr = cfg.lr * global_batch / base
        cfg.lr_scale_by_batch = None
    return cfg.lr


def build_schedule(cfg, niter_per_ep: int) -> Callable[[int], float]:
    if cfg.fix_lr:
        return lambda step: cfg.lr
    return cosine_schedule(cfg.lr, cfg.lr_end, cfg.epochs, niter_per_ep,
                           cfg.warmup_epochs, cfg.lr_start)


def build_wd_schedule(cfg, niter_per_ep: int
                      ) -> Optional[Callable[[int], float]]:
    """The cosine ``wd -> wd_end`` over the run (no warmup), or None for a
    constant ``wd``."""
    if cfg.wd_end is None or cfg.wd_end == cfg.wd:
        return None
    return cosine_schedule(cfg.wd, cfg.wd_end, cfg.epochs, niter_per_ep)


class Lion(torch.optim.Optimizer):
    """``optax.lion``'s update, with the decay inside the learning rate's
    scale: ``u = sign(b1 m + (1 - b1) g)`` (0 where that is 0), ``m <- b2 m
    + (1 - b2) g``, ``p <- p - lr (u + weight_decay p)``.  The moment
    ``exp_avg`` starts at 0."""

    def __init__(self, params, lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas),
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                m = state["exp_avg"]
                u = torch.sign((1.0 - b1) * g + b1 * m)
                m.copy_((1.0 - b2) * g + b2 * m)
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.sub_(group["lr"] * u)


def _core(name: str, groups: list, cfg, lr: float) -> torch.optim.Optimizer:
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=tuple(cfg.betas),
                                 eps=cfg.eps)
    if name == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=cfg.momentum)
    if name == "lion":
        return Lion(groups, lr=lr, betas=tuple(cfg.betas))
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def _unported(cfg) -> List[str]:
    asked = []
    if cfg.state_dtype not in ("", "float32"):
        asked.append(f"state_dtype={cfg.state_dtype!r}")
    if cfg.update_freq > 1:
        asked.append(f"update_freq={cfg.update_freq}")
    return asked


class Optimizer:
    """Clip, schedule and the core (``cfg.optimizer``: AdamW, SGD or Lion)
    over named parameters; with ``wd_schedule`` the decay of the decayed
    groups follows it; with ``cfg.layer_decay`` and ``num_layers``,
    layer-wise learning rates."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], cfg,
                 schedule: Callable[[int], float],
                 num_layers: Optional[int] = None,
                 wd_schedule: Optional[Callable[[int], float]] = None):
        asked = _unported(cfg)
        if asked:
            raise NotImplementedError(
                "not in the PyTorch port yet: " + ", ".join(asked)
                + " (the contrastive-extras slice, ROADMAP.md Queue 1, "
                  "item 6)")
        groups: Dict[Tuple[float, bool], List[torch.Tensor]] = {}
        for name, p in named_params:
            if p.requires_grad:
                scale = (layer_decay_scale(name, num_layers, cfg.layer_decay)
                         if cfg.layer_decay and num_layers else 1.0)
                groups.setdefault((scale, wd_mask(name, p)), []).append(p)
        # by depth scale, the decayed group first (the layout of
        # checkpoints written before layer decay)
        groups = dict(sorted(groups.items(), key=lambda kv: (kv[0][0],
                                                             not kv[0][1])))
        if not groups:
            groups[(1.0, True)] = []
        self.params = [p for ps in groups.values() for p in ps]
        self.schedule = schedule
        self.wd_schedule = wd_schedule
        self.grad_clip_norm = cfg.grad_clip_norm
        self.count = 0  # updates applied
        self.name = cfg.optimizer.lower()
        self.inner = _core(
            self.name,
            [{"params": ps, "weight_decay": cfg.wd if decays else 0.0,
              "decays": decays, "lr_scale": scale}
             for (scale, decays), ps in groups.items()],
            cfg, schedule(0))

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    def global_norm(self) -> torch.Tensor:
        """L2 norm of all gradients (``optax.global_norm``), on device."""
        grads = self._grads()
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))

    def update(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """Clip (given the gradients' ``global_norm``), set the scheduled
        learning rate (and weight decay), step the core, advance the
        count."""
        if self.grad_clip_norm:
            if grad_norm is None:
                grad_norm = self.global_norm()
            scale = (self.grad_clip_norm / grad_norm).clamp(max=1.0)
            torch._foreach_mul_(self._grads(), scale)
        lr = self.schedule(self.count)
        wd = (self.wd_schedule(self.count) if self.wd_schedule is not None
              else None)
        for group in self.inner.param_groups:
            group["lr"] = lr * group["lr_scale"]
            if wd is not None and group["decays"]:
                group["weight_decay"] = wd
        self.inner.step()
        self.count += 1

    def state_dict(self) -> dict:
        """``{<optimizer name>: the core's state dict, "count": ...}``."""
        return {self.name: self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state[self.name])
        self.count = int(state["count"])


def build_optimizer(cfg, model: torch.nn.Module, niter_per_ep: int,
                    num_layers: Optional[int] = None
                    ) -> Tuple[Optimizer, Callable[[int], float]]:
    """From an ``OptimConfig``; returns (optimizer, lr schedule).  Layer
    decay applies when ``cfg.layer_decay`` and ``num_layers`` are set, as
    in the JAX factory."""
    schedule = build_schedule(cfg, niter_per_ep)
    return (Optimizer(model.named_parameters(), cfg, schedule, num_layers,
                      build_wd_schedule(cfg, niter_per_ep)),
            schedule)
