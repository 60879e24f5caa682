"""Train state (``avion_tpu.core.train_state.TrainState``): the step count,
the model (its parameters) and the optimizer (its moments and its own
update count).  The step advances on every step, the optimizer's count
only on updates it applied; a skipped step (non-finite loss) advances the
first alone, as in the JAX package."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from avion_tpu_torch.optim.factory import Optimizer


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: Optimizer

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: Optimizer
               ) -> "TrainState":
        return cls(0, model, optimizer)

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
