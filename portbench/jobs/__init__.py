"""Jobs: each ``jobs/<name>.py`` builds the port's model, optimizer, train
state and step through an entry's own functions, and loads the
benchmark's weights into the model.  A job exports ``build(config,
traffic, weights, device) -> Program``; the traffic file names its job.

This module holds what every job shares: the :class:`Program` the
harness drives, and the readings taken from the port's optimizer and
parameters for the comparison (``compare.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import torch


@dataclass
class Program:
    """The system under test: ``state, metrics = step(state, batch)``."""

    model: torch.nn.Module
    optimizer: object  # the port's optim.factory.Optimizer
    state: object  # the port's core.train_state.TrainState
    step: Callable
    beta1: float

    def run(self, batch: Dict[str, torch.Tensor]) -> dict:
        self.state, metrics = self.step(self.state, batch)
        return metrics


def recipe_overrides(recipe: dict) -> List[str]:
    """The recipe of a traffic file as the port's ``optim.*`` overrides."""
    out = [f"optim.optimizer={recipe['optimizer']}",
           f"optim.lr={recipe['lr']!r}",
           f"optim.lr_start={recipe['lr_start']!r}",
           f"optim.lr_end={recipe['lr_end']!r}",
           f"optim.warmup_epochs={recipe['warmup_epochs']!r}",
           f"optim.epochs={recipe['epochs']}",
           "optim.betas={!r},{!r}".format(*recipe["betas"]),
           f"optim.eps={recipe['eps']!r}", f"optim.wd={recipe['wd']!r}"]
    if recipe.get("grad_clip_norm"):
        out.append(f"optim.grad_clip_norm={recipe['grad_clip_norm']!r}")
    return out


def first_grad_norms(program: Program) -> Dict[str, float]:
    """Each leaf's norm of the first step's gradient as AdamW got it, from
    its first moment after one update: ``m = (1 - b1) g``."""
    opt = program.optimizer
    state = opt.state_dict()[opt.name]["state"]
    names, norms = [], []
    for i, s in state.items():
        if "exp_avg" in s:
            names.append(opt.names[int(i)])
            norms.append(torch.linalg.vector_norm(s["exp_avg"].float()))
    if not names:
        return {}
    values = torch.stack(norms).tolist()
    return {n: v / (1.0 - program.beta1) for n, v in zip(names, values)}


def changes(program: Program,
            start: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf's change from ``start``, in f32 on the host."""
    with torch.no_grad():
        return {n: (p.float() - start[n]).cpu()
                for n, p in program.model.named_parameters()}
