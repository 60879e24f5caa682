"""Profiling helpers (``avion_tpu.core.profiling``) over
``torch.profiler``.

- ``trace(logdir)``: context manager that records the host and, on a
  CUDA machine, the card (CUPTI) and writes a chrome trace
  ``<logdir>/trace_<pid>_<n>.json`` (Perfetto, ``chrome://tracing``,
  ``tools.profile_step.analyze_trace``).  Where CUDA is present and the
  profiler cannot start, it raises: a trace without the card's activity
  would pass for one with it.
- ``annotate(name)``: a named region (``record_function``) that shows in
  the trace; ``CLIP.encode_image`` / ``encode_text`` enter one each.
- ``wallclock(label)``: prints the wall time of a block.
- ``card_line(device)``: the card's name and power limit as
  ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
  them, which the tools print beside every time they measure;
  ``device_ms(fn, device)``: a call's time, by CUDA events on the card.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import subprocess
import time
from typing import Callable, Iterator

import torch

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """Profile the block; yields the path the chrome trace is written to
    when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{next(_TRACES)}.json")
    with profile(activities=activities) as prof:  # raises where it cannot
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def wallclock(label: str, sink=print) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    sink(f"[{label}] {time.perf_counter() - t0:.3f}s")


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of ``device``'s card (its
    first line where the index is not known), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    index = device.index if device.index is not None else 0
    return lines[index] if index < len(lines) else lines[0]


def device_ms(fn: Callable[[], object], device: torch.device,
              iters: int = 10, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after ``warmup``: CUDA
    events around the calls on the card (the card's time, not the host's
    enqueue), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
