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
one world size restores at any other."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from avion_tpu_torch.optim.factory import Optimizer
from avion_tpu_torch.parallel.sharding import local, shard_like


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
        out = {"step": self.step, "model": self.model.state_dict(),
               "optimizer": self.optimizer.state_dict()}
        if self.ema is not None:
            out["ema"] = self.ema
        return out

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        own = self.model.state_dict()
        self.model.load_state_dict({k: shard_like(v, own[k]) if k in own
                                    else v for k, v in state["model"].items()})
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            for n, v in state["ema"].items():
                local(self.ema[n]).copy_(local(shard_like(v, self.ema[n])))
