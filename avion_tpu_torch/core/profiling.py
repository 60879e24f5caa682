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
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Iterator

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
