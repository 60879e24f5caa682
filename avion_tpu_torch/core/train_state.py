"""Train state (``avion_tpu.core.train_state.TrainState``): the step count,
the model (its parameters) and the optimizer (its moments and its own
update count), and with ``use_ema`` an exponential moving average of the
parameters (``ema``, by parameter name, f32).  The step advances on every
step, the optimizer's count only on updates applied and the average on
every step with a finite loss (under ``update_freq`` also on the calls
that only accumulate, as the JAX classification step averages after every
call); a skipped step (non-finite loss) advances the first alone, as in
the JAX package.  The optimizer's state dict holds its moments in their
stored dtype (bf16 under ``state_dtype=bfloat16``) and, under
``update_freq``, the accumulated mean gradient and its call count, so a
resume is exact.

Under FSDP2 the parameters, moments and average are sharded tensors: a
checkpoint (``core.checkpoint``) holds them whole, and :meth:`TrainState.
load_state_dict` cuts each back to this rank's shard, so a state saved at
one world size restores at any other.  Under ``mesh.tensor`` the parts a
rank holds (``parallel.tensor_parallel``) are gathered and cut the same
way, as are an expert-parallel MoE layer's experts (``ep``) and a
pipeline's stage leaves (``pp``), so the checkpoint keeps the one-process
layout."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from avion_tpu_torch.optim.factory import Optimizer
from avion_tpu_torch.parallel.sharding import full_tensor, local, shard_like
from avion_tpu_torch.parallel.tensor_parallel import tensor_layout


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None
    # parallel.sharding.Parallel over a mesh: the model the step calls and
    # the batch group its loss gathers over (None: one process)
    parallel: Optional[Any] = None

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: Optimizer,
               use_ema: bool = False, parallel=None) -> "TrainState":
        ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
               if use_ema else None)
        return cls(0, model, optimizer, ema, parallel)

    @torch.no_grad()
    def update_ema(self, decay: float) -> None:
        """``e * decay + (1 - decay) * p`` for every parameter."""
        names = list(self.ema)
        params = dict(self.model.named_parameters())
        ema = [local(self.ema[n]) for n in names]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(
            [local(params[n].detach()) for n in names], 1.0 - decay))

    def state_dict(self) -> dict:
        """Under ``mesh.tensor`` the parts each rank holds are gathered
        whole (a collective: every rank calls it); FSDP2's shards stay
        sharded tensors (``core.checkpoint`` gathers them)."""
        out = {"step": self.step, "model": self.model.state_dict(),
               "optimizer": self.optimizer.state_dict()}
        if self.ema is not None:
            out["ema"] = self.ema
        layout = tensor_layout(self.model)
        if layout is not None:
            out = _over_parts(out, self.optimizer,
                              lambda n, v: layout.gather(n, full_tensor(v)))
        return out

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        layout = tensor_layout(self.model)
        if layout is not None:
            state = _over_parts(state, self.optimizer, layout.cut)
        own = self.model.state_dict()
        self.model.load_state_dict({k: shard_like(v, own[k]) if k in own
                                    else v for k, v in state["model"].items()})
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            for n, v in state["ema"].items():
                local(self.ema[n]).copy_(local(shard_like(v, self.ema[n])))


def _over_parts(state: dict, optimizer: Optimizer, fn) -> dict:
    """``state`` with ``fn(name, value)`` applied to the model's tensors,
    the EMA's and the optimizer's per-parameter tensors (its moments and
    the accumulated mean, named by their parameter)."""
    out = dict(state)
    out["model"] = {k: fn(k, v) if torch.is_tensor(v) else v
                    for k, v in state["model"].items()}
    if state.get("ema") is not None:
        out["ema"] = {k: fn(k, v) for k, v in state["ema"].items()}
    opt = dict(state["optimizer"])
    core = dict(opt[optimizer.name])
    names = optimizer.names
    core["state"] = {i: {k: fn(names[int(i)], v)
                         if torch.is_tensor(v) else v
                         for k, v in moments.items()}
                     for i, moments in core["state"].items()}
    opt[optimizer.name] = core
    if opt.get("acc") is not None:
        opt["acc"] = [fn(n, a) for n, a in zip(names, opt["acc"])]
    out["optimizer"] = opt
    return out
