"""Optimizer (``avion_tpu.optim.factory``): the optax chain
``clip_by_global_norm -> core -> layer-decay scale`` as one object, whose
core is AdamW, SGD with momentum or Lion.

- Weight decay follows ``wd_mask``: parameters with two or more dimensions
  whose name holds none of ``_NO_WD_TOKENS`` decay, the rest do not; they
  become the core's parameter groups.
  - AdamW (``optax.adamw``): decays as ``lr * wd * p``, decoupled from
    the moments, and adds eps outside the square root.
  - SGD: optax adds ``wd * p`` to the gradient before ``sgd``'s momentum
    trace (no dampening, no Nesterov).
  - Lion (``optax.lion``): ``u = sign(b1 m + (1 - b1) g)``, ``m <- b2 m +
    (1 - b2) g``, ``p <- p - lr (u + wd p)``.
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

- ``state_dtype=bfloat16`` stores the float moments in bf16 between
  updates and computes each update in f32 (``cast_opt_state``); the
  cores are written out (``torch.optim.AdamW`` with bf16 state would
  compute in bf16).
- ``update_freq`` > 1 with ``accum=multistep`` (``optax.MultiSteps``):
  gradients are averaged over ``update_freq`` calls and the clip, the
  schedule and the core act once, on the mean; the running mean and the
  calls since the last update are part of the state dict.
- Under FSDP2 (``parallel.sharding``) parameters, gradients and moments
  are sharded tensors of one layout: the cores run on their local shards,
  and the global norm sums the shards' squared norms over the ``fsdp``
  ranks before the clip; under ``mesh.tensor`` the parts a rank holds
  (``parallel.tensor_parallel``) are summed over the ``tensor`` ranks too.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from avion_tpu_torch.optim.schedules import cosine_schedule
from avion_tpu_torch.parallel.sharding import is_dtensor, local, shard_like
from avion_tpu_torch.parallel.tensor_parallel import tensor_layout

# the JAX package's tokens, and ``cls_token``: the released TimeSformer
# layout stores it [1, 1, D], where the flax parameter is [D] (ndim 1)
_NO_WD_TOKENS = (
    "bias", "norm", "ln_", "positional_embedding", "temporal_embedding",
    "class_embedding", "logit_scale", "token_embedding", "mask_token",
    "gamma", "fc_norm", "cls_token",
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


class _Core(torch.optim.Optimizer):
    """An optax core written out with ``torch._foreach_*`` over each group,
    in f32.  Its float moments (``MOMENTS``) are stored in ``state_dtype``
    between updates, as ``cast_opt_state`` holds them: an update up-casts
    them, takes the parameter update from the new f32 moments, and only
    then stores those rounded back (with f32 state the moments are updated
    in place).  A group's ``lr``, ``weight_decay`` and ``count`` (the core's
    update count, from 1) are set by :class:`Optimizer`."""

    MOMENTS: Tuple[str, ...] = ()

    def __init__(self, groups, state_dtype: torch.dtype, **defaults):
        super().__init__(groups, defaults)
        self.state_dtype = state_dtype

    def _update(self, group, params, grads, *moments) -> None:
        raise NotImplementedError

    def load_state_dict(self, state_dict: dict) -> None:
        # torch casts loaded float state to each parameter's dtype; the
        # moments go back to state_dtype (exact for saved bf16 values)
        super().load_state_dict(state_dict)
        for p, state in self.state.items():
            for name in self.MOMENTS:
                if name in state:
                    state[name] = shard_like(state[name], p).to(
                        self.state_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            stored = []
            for name in self.MOMENTS:
                for p in params:
                    if name not in self.state[p]:
                        self.state[p][name] = torch.zeros_like(
                            p, dtype=self.state_dtype)
                stored.append([self.state[p][name] for p in params])
            work = [[local(m).float() for m in ms] for ms in stored]
            self._update(group, [local(p) for p in params],
                         [local(p.grad) for p in params], *work)
            if self.state_dtype != torch.float32:
                for ms, new in zip(stored, work):
                    torch._foreach_copy_([local(m) for m in ms], new)


class AdamW(_Core):
    """``optax.adamw``: ``m <- b1 m + (1 - b1) g``, ``v <- b2 v + (1 - b2)
    g^2``, ``u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``, ``p <- p
    - lr (u + weight_decay p)``."""

    MOMENTS = ("exp_avg", "exp_avg_sq")

    def _update(self, group, params, grads, m, v):
        b1, b2 = group["betas"]
        t = group["count"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(v, 1.0 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        u = torch._foreach_div(m, 1.0 - b1 ** t)
        torch._foreach_div_(u, denom)
        del denom
        if group["weight_decay"]:
            torch._foreach_add_(u, params, alpha=group["weight_decay"])
        torch._foreach_add_(params, u, alpha=-group["lr"])


class SGD(_Core):
    """optax's ``add_decayed_weights`` then ``sgd`` with momentum:
    ``b <- momentum b + (g + weight_decay p)``, ``p <- p - lr b`` (no
    dampening, no Nesterov)."""

    MOMENTS = ("momentum_buffer",)

    def _update(self, group, params, grads, buf):
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, params,
                                       alpha=group["weight_decay"])
        torch._foreach_mul_(buf, group["momentum"])
        torch._foreach_add_(buf, grads)
        torch._foreach_add_(params, buf, alpha=-group["lr"])


class Lion(_Core):
    """``optax.lion``'s update, with the decay inside the learning rate's
    scale: ``u = sign(b1 m + (1 - b1) g)`` (0 where that is 0), ``m <- b2 m
    + (1 - b2) g``, ``p <- p - lr (u + weight_decay p)``."""

    MOMENTS = ("exp_avg",)

    def _update(self, group, params, grads, m):
        b1, b2 = group["betas"]
        u = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(u, m, alpha=b1)
        torch._foreach_sign_(u)
        torch._foreach_mul_(m, b2)
        torch._foreach_add_(m, grads, alpha=1.0 - b2)
        if group["weight_decay"]:
            torch._foreach_add_(u, params, alpha=group["weight_decay"])
        torch._foreach_add_(params, u, alpha=-group["lr"])


STATE_DTYPES = {"": torch.float32, "float32": torch.float32,
                "bfloat16": torch.bfloat16}
ACCUM_MODES = ("multistep", "cached")


def _core(name: str, groups: list, cfg, lr: float) -> torch.optim.Optimizer:
    if cfg.state_dtype not in STATE_DTYPES:
        raise ValueError(f"state_dtype must be one of "
                         f"{sorted(STATE_DTYPES)}, got {cfg.state_dtype!r}")
    dtype = STATE_DTYPES[cfg.state_dtype]
    if name == "adamw":
        return AdamW(groups, dtype, lr=lr, betas=tuple(cfg.betas),
                     eps=cfg.eps)
    if name == "sgd":
        return SGD(groups, dtype, lr=lr, momentum=cfg.momentum)
    if name == "lion":
        return Lion(groups, dtype, lr=lr, betas=tuple(cfg.betas))
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


class Optimizer:
    """Clip, schedule and the core (``cfg.optimizer``: AdamW, SGD or Lion)
    over named parameters; with ``wd_schedule`` the decay of the decayed
    groups follows it; with ``cfg.layer_decay`` and ``num_layers``,
    layer-wise learning rates; with ``cfg.update_freq`` > 1 and
    ``cfg.accum`` ``multistep``, one update every ``update_freq`` calls
    (``optax.MultiSteps``)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], cfg,
                 schedule: Callable[[int], float],
                 num_layers: Optional[int] = None,
                 wd_schedule: Optional[Callable[[int], float]] = None,
                 tensor_layout=None):
        named_params = list(named_params)
        if cfg.accum not in ACCUM_MODES:
            raise ValueError(f"accum must be one of {ACCUM_MODES}, got "
                             f"{cfg.accum!r}")
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
        names = {id(p): n for n, p in named_params}
        self.names = [names[id(p)] for p in self.params]
        # under mesh.tensor, ep or pp, the parameters each rank holds a
        # part of, by the mesh axis of their part
        self.tensor_layout = tensor_layout
        self.tensor_held = ({id(p): tensor_layout.leaves[n].axis
                             for n, p in zip(self.names, self.params)
                             if n in tensor_layout.leaves}
                            if tensor_layout is not None else {})
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
        # optax.MultiSteps: the running mean of the gradients of the calls
        # since the last update; the cached accumulation of the CLIP step
        # accumulates inside the step instead
        self.every = (cfg.update_freq if cfg.update_freq > 1
                      and cfg.accum == "multistep" else 1)
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.every > 1 else None)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.params if p.grad is not None]

    def global_norm(self) -> torch.Tensor:
        """L2 norm of all gradients (``optax.global_norm``), on device;
        sharded gradients' squared norms are summed over their shards
        (FSDP2's over ``fsdp``, then the parts' over their axis: ``tensor``,
        ``ep``, or ``pp`` for the stage leaves, which one rank holds)."""
        whole = []
        held: Dict[str, List[torch.Tensor]] = {}
        for p in self.params:
            if p.grad is None:
                continue
            if id(p) in self.tensor_held:
                held.setdefault(self.tensor_held[id(p)], []).append(p.grad)
            else:
                whole.append(p.grad)

        def sharded_squares(grads):
            """The squared norm of FSDP2-sharded gradients, summed over
            their shards."""
            sq = torch.stack([torch.linalg.vector_norm(local(g).float()) ** 2
                              for g in grads]).sum()
            mesh = grads[0].device_mesh
            dist.all_reduce(sq, group=mesh.get_group(mesh.ndim - 1))
            return sq

        plain = [g for g in whole if not is_dtensor(g)]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in plain]))
        extra = []
        sharded = [g for g in whole if is_dtensor(g)]
        if sharded:
            extra.append(sharded_squares(sharded))
        # every rank of an axis's group reduces, with or without gradients
        for axis, group in (self.tensor_layout.axes()
                            if self.tensor_layout is not None else []):
            grads = held.get(axis, [])
            parts = [torch.linalg.vector_norm(g.float()) ** 2
                     for g in grads if not is_dtensor(g)]
            sq = torch.stack(parts).sum() if parts else norm.new_zeros(())
            sharded = [g for g in grads if is_dtensor(g)]
            if sharded:
                sq = sq + sharded_squares(sharded)
            dist.all_reduce(sq, group=group)
            extra.append(sq)
        if not extra:
            return norm
        return torch.sqrt(norm ** 2 + sum(extra))

    def _accumulate(self) -> bool:
        """Fold this call's gradients into the running mean (``acc + (g -
        acc) / (n + 1)``, optax's, a missing gradient counting as zero).
        On the ``every``-th call the mean becomes every parameter's
        gradient, and True says to apply it (:meth:`update` then resets
        the mean)."""
        grads = [local(p.grad) if p.grad is not None
                 else torch.zeros_like(local(p)) for p in self.params]
        acc = [local(a) for a in self.acc]
        diff = torch._foreach_sub(grads, acc)
        torch._foreach_div_(diff, float(self.mini_step + 1))
        torch._foreach_add_(acc, diff)
        del diff, grads
        if self.mini_step < self.every - 1:
            self.mini_step += 1
            return False
        for p, a in zip(self.params, self.acc):
            p.grad = a
        return True

    def update(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """Clip (given the gradients' ``global_norm``), set the scheduled
        learning rate (and weight decay) and the core's count, step the
        core, advance the count.  Under ``update_freq`` the gradients are
        accumulated first, and all of that happens only on every
        ``update_freq``-th call, to their mean (the clip acts on the mean,
        so ``grad_norm`` is not used)."""
        if self.every > 1:
            if not self._accumulate():
                return
            grad_norm = None
        if self.grad_clip_norm:
            if grad_norm is None:
                grad_norm = self.global_norm()
            scale = (self.grad_clip_norm / grad_norm).clamp(max=1.0)
            torch._foreach_mul_([local(g) for g in self._grads()], scale)
        lr = self.schedule(self.count)
        wd = (self.wd_schedule(self.count) if self.wd_schedule is not None
              else None)
        for group in self.inner.param_groups:
            group["lr"] = lr * group["lr_scale"]
            group["count"] = self.count + 1
            if wd is not None and group["decays"]:
                group["weight_decay"] = wd
        self.inner.step()
        self.count += 1
        if self.every > 1:
            self.zero_grad()  # the gradients are the mean's storage
            torch._foreach_zero_([local(a) for a in self.acc])
            self.mini_step = 0

    def state_dict(self) -> dict:
        """``{<optimizer name>: the core's state dict, "count": ...}``, and
        under ``update_freq`` the calls since the last update
        (``mini_step``) and their mean gradient (``acc``)."""
        out = {self.name: self.inner.state_dict(), "count": self.count}
        if self.acc is not None:
            out.update(mini_step=self.mini_step, acc=self.acc)
        return out

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state[self.name])
        self.count = int(state["count"])
        if self.acc is not None:
            self.mini_step = int(state["mini_step"])
            for a, saved in zip(self.acc, state["acc"]):
                local(a).copy_(local(shard_like(saved, a)))


def build_optimizer(cfg, model: torch.nn.Module, niter_per_ep: int,
                    num_layers: Optional[int] = None
                    ) -> Tuple[Optimizer, Callable[[int], float]]:
    """From an ``OptimConfig``; returns (optimizer, lr schedule).  Layer
    decay applies when ``cfg.layer_decay`` and ``num_layers`` are set, as
    in the JAX factory."""
    schedule = build_schedule(cfg, niter_per_ep)
    return (Optimizer(model.named_parameters(), cfg, schedule, num_layers,
                      build_wd_schedule(cfg, niter_per_ep),
                      tensor_layout(model)),
            schedule)
