"""Profiling helpers (``avion_tpu.core.profiling``) over
``torch.profiler``.

- ``trace(logdir)``: context manager that records the host and, on a
  CUDA machine, the card (CUPTI) and writes a chrome trace
  ``<logdir>/trace_<pid>_<n>.json`` (Perfetto, ``chrome://tracing``,
  ``tools.profile_step.analyze_trace``).  Where CUDA is present and the
  profiler cannot start, it raises: a trace without the card's activity
  would pass for one with it.
- ``span(name)``: a named region of the program (``record_function``, so
  it lands on the profiler's timeline beside the card's kernels).  The
  program's names start with ``avion.``: ``train.steps`` opens
  ``avion.step`` and its phases, ``models.clip`` / ``models.videomae``
  one span a tower.  With no profiler active it reads one flag and
  records nothing.
- ``backward_mark(x, name)``: ``x`` through an identity whose backward
  records a zero-length ``name`` where the gradient reaches ``x``: the
  start of a tower's backward on the autograd engine's thread.  With no
  profiler active it returns ``x`` itself and adds no autograd node.
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
import torch.autograd.profiler as _autograd_profiler

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


def _profiling() -> bool:
    # set by torch.profiler's start and stop, for checks on the hot path
    return _autograd_profiler._is_profiler_enabled


class span:
    """``with span(name):`` records the block as ``name`` when a profiler
    is active, and does nothing else otherwise."""

    __slots__ = ("name", "_record")

    def __init__(self, name: str):
        self.name = name
        self._record = None

    def __enter__(self) -> None:
        if _profiling():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()

    def __exit__(self, *exc) -> None:
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None


class _BackwardMark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, name: str) -> torch.Tensor:
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        with torch.profiler.record_function(ctx.name):
            pass
        return grad, None


def backward_mark(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``; under an active profiler, through an identity whose backward
    records the zero-length ``name`` inside the engine's own
    ``autograd::engine::evaluate_function`` op (so no other op's
    enclosing op changes)."""
    if not (_profiling() and torch.is_grad_enabled() and x.requires_grad):
        return x
    return _BackwardMark.apply(x, name)


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
