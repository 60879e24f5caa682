"""Progress meters + input-pipeline duty-cycle tracking (the PyTorch
port's own copy of ``avion_tpu.core.meters``).

Mirrors the reference's instrumentation (``avion/utils/meters.py``,
``main_lavila_pretrain.py:767-770``): batch/data/model wall-clock split.
``duty_cycle`` = model_time / batch_time is the starvation detector the
BASELINE targets (>95%).
"""

from __future__ import annotations

import time
from typing import Dict


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg
        )


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.fmt = "{:" + str(len(str(num_batches))) + "d}"
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + "[" + self.fmt.format(batch) + "/"
                   + str(self.num_batches) + "]"]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries), flush=True)


class StepTimer:
    """Tracks data-wait vs compute time per iteration.

    Usage::

        timer = StepTimer()
        for batch in loader:         # data fetch happens in next()
            timer.mark_data()
            state, m = step(state, batch)
            sync()                    # host fetch of a metric scalar
            timer.mark_step()
    """

    def __init__(self):
        self.data_time = AverageMeter("data", ":6.3f")
        self.step_time = AverageMeter("step", ":6.3f")
        self.batch_time = AverageMeter("batch", ":6.3f")
        self._t0 = time.perf_counter()
        # windowed accounting starts at construction; without this the
        # FIRST mark_window had no start point and dropped its window
        self._window_t0 = self._t0
        self._window_data0 = 0.0
        # per-step stats of the most recently closed window: the
        # steady-state view (cumulative averages keep the first
        # window's compile time in every later reading; the reference
        # prints current-window `val` beside `avg` for the same
        # reason, meters.py:35-38)
        self.last_window: Dict[str, float] = {}

    def mark_data(self):
        now = time.perf_counter()
        self.data_time.update(now - self._t0)
        self._t1 = now

    def mark_step(self):
        now = time.perf_counter()
        self.step_time.update(now - self._t1)
        self.batch_time.update(now - self._t0)
        self._t0 = now

    def mark_window(self, n_steps: int):
        """Close an n-step window with a single host sync at its end:
        data waits were recorded per step by mark_data (host-side, always
        accurate); the remaining window wall-time is attributed to device
        steps.  Keeps duty-cycle stats correct without per-step syncs."""
        now = time.perf_counter()
        window = now - self._window_t0
        if n_steps > 0 and window > 0:
            data = self.data_time.sum - self._window_data0
            per_step = max(window - data, 0.0) / n_steps
            for _ in range(n_steps):
                self.step_time.update(per_step)
                self.batch_time.update(window / n_steps)
            self.last_window = {
                "data_time_win": data / n_steps,
                "step_time_win": per_step,
                "batch_time_win": window / n_steps,
                "duty_cycle_win": max(window - data, 0.0) / window,
            }
        self._window_t0 = now
        self._window_data0 = self.data_time.sum
        self._t0 = now

    @property
    def duty_cycle(self) -> float:
        bt = self.batch_time.avg
        return self.step_time.avg / bt if bt > 0 else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "data_time": self.data_time.avg,
            "step_time": self.step_time.avg,
            "batch_time": self.batch_time.avg,
            "duty_cycle": self.duty_cycle,
            **self.last_window,
        }
