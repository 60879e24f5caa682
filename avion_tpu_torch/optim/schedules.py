"""LR schedules (``avion_tpu.optim.schedules``), on Python floats.

``cosine_schedule`` is the reference's per-iteration array
(``avion/optim/schedulers.py:4-15``) as a function of the update count:
linear warmup from ``start_warmup_value`` to ``base_value`` over
``warmup_epochs``, then cosine decay to ``final_value``.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_schedule(base_value: float, final_value: float, epochs: float,
                    niter_per_ep: int, warmup_epochs: float = 0.0,
                    start_warmup_value: float = 0.0
                    ) -> Callable[[int], float]:
    warmup_iters = int(warmup_epochs * niter_per_ep)
    total_iters = int(epochs * niter_per_ep)

    def schedule(step: int) -> float:
        step = min(step, total_iters)
        if step < warmup_iters:
            return start_warmup_value + (base_value - start_warmup_value) * (
                step / max(warmup_iters, 1))
        progress = (step - warmup_iters) / max(total_iters - warmup_iters, 1)
        return final_value + 0.5 * (base_value - final_value) * (
            1 + math.cos(math.pi * progress))

    return schedule
