"""Checkpoint save / restore and auto-resume (``avion_tpu.core.checkpoint``,
which uses orbax).

Layout: ``<directory>/<step>/state.pt`` (``torch.save`` of the train
state: step, model, optimizer) and ``<directory>/<step>/extra.json``.  A
checkpoint is written into a temporary directory beside it and renamed
into place, so a crash never leaves a half-written ``<step>``; only the
newest ``max_to_keep`` are kept.  Saves are synchronous (the state is
copied to the host first), so :meth:`Checkpointer.wait` has nothing to
wait for.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, List, Optional

import torch


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, "state.pt")))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, extra: Optional[dict] = None) -> None:
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            return  # one checkpoint per step, as orbax skips a duplicate
        tmp = tempfile.mkdtemp(prefix=f".{step}-", dir=self.directory)
        try:
            torch.save(_to_cpu(state.state_dict()),
                       os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "extra.json"), "w") as f:
                json.dump(extra or {}, f)
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint ``step`` (default the newest) into ``state`` in
        place; returns (state, extra), or (None, None) without one."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.directory, str(step))
        state.load_state_dict(torch.load(os.path.join(path, "state.pt"),
                                         map_location="cpu",
                                         weights_only=True))
        with open(os.path.join(path, "extra.json")) as f:
            extra = json.load(f)
        return state, extra

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX package's interface."""
