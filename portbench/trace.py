"""A profile of whole train steps, reduced in memory to what the per-layer
metrics read.

``torch.profiler`` links each kernel, copy and memset on the card to the
host op that launched it (the launch's correlation id names the innermost
op on the launching thread); each host op also knows the op that encloses
it on its thread.  :func:`from_profile` keeps, for every host op, its name,
interval, enclosing op and the device seconds of what it launched itself,
and for the card its activities' intervals.  The ranges that
``record_function`` mirrors onto the card's timeline
(``gpu_user_annotation``) are left out: each covers kernels already
counted and the gaps between them.

- :func:`busy_s`: the union of the card's intervals, so overlapping copies
  and kernels count once.
- :func:`device_s_under`: device seconds launched by ops that are, or lie
  inside, an op whose name a rule matches (the phase rule of an analysis
  that attributes each kernel through its launch: inside
  ``autograd::engine::evaluate_function`` is the backward).
- :func:`top_device_ops`, :func:`idle_gaps`: the ``breakdown`` of a traced
  run, the kernels that took most time and the longest idle stretches of
  the card by the host op that was running meanwhile.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class HostOp:
    name: str
    start: float  # seconds
    end: float
    parent: int  # index of the enclosing op, -1 for none
    device_s: float  # device seconds of what this op launched itself
    thread: int = 0


@dataclass
class DeviceOp:
    name: str
    start: float
    end: float


@dataclass
class Trace:
    host: List[HostOp]
    device: List[DeviceOp]


def from_profile(prof) -> Trace:
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU
           and not getattr(e, "is_async", False)]
    index = {id(e): i for i, e in enumerate(cpu)}
    host = [HostOp(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6,
                   index.get(id(e.cpu_parent), -1),
                   sum(k.duration for k in e.kernels) / 1e6,
                   int(e.thread))
            for e in cpu]
    device = [DeviceOp(e.name, e.time_range.start / 1e6,
                       e.time_range.end / 1e6)
              for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return Trace(host, device)


def merged(device: Sequence[DeviceOp]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted((d.start, d.end) for d in device):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in merged(trace.device))


def device_s(trace: Trace) -> float:
    return sum(d.end - d.start for d in trace.device)


def device_s_under(trace: Trace, match: Callable[[str], bool]) -> float:
    """Device seconds launched inside any op whose name ``match`` holds."""
    inside: Dict[int, bool] = {}

    def holds(i: int) -> bool:
        chain = []
        while i >= 0 and i not in inside:
            chain.append(i)
            i = trace.host[i].parent
        found = inside.get(i, False) if i >= 0 else False
        for j in reversed(chain):
            found = found or match(trace.host[j].name)
            inside[j] = found
        return inside[chain[0]] if chain else found

    return sum(op.device_s for i, op in enumerate(trace.host)
               if op.device_s and holds(i))


def kernel_kind(name: str) -> str:
    """``void (anonymous namespace)::flash_fwd_kernel<64, false>(Params)``
    -> ``flash_fwd_kernel``; ``Memcpy HtoD (Pageable -> Device)`` ->
    ``Memcpy HtoD``."""
    n = re.sub(r"^void ", "", name.strip()).replace("(anonymous namespace)",
                                                     "")
    n = re.split(r"[<(]", n, maxsplit=1)[0].strip()
    return n.rsplit("::", 1)[-1] or name


def top_device_ops(trace: Trace, top: int = 10) -> List[list]:
    by_kind: Dict[str, float] = defaultdict(float)
    for d in trace.device:
        by_kind[kernel_kind(d.name)] += d.end - d.start
    return [[k, s] for k, s in sorted(by_kind.items(),
                                      key=lambda kv: -kv[1])[:top]]


def _innermost(host: List[HostOp], t: float,
               starts: List[float], order: List[int]) -> Optional[str]:
    """The latest-starting host op that holds ``t`` (ops nest, so it is
    the innermost), or None."""
    i = bisect.bisect_right(starts, t)
    while i > 0:
        i -= 1
        op = host[order[i]]
        if op.end >= t:
            return op.name
        if t - op.start > 10.0:
            break
    return None


def idle_gaps(trace: Trace, top: int = 10) -> List[list]:
    """The card's idle stretches between its first and last activity,
    summed by the innermost host op running at each one's middle."""
    order = sorted(range(len(trace.host)), key=lambda i: trace.host[i].start)
    starts = [trace.host[i].start for i in order]
    by_op: Dict[str, float] = defaultdict(float)
    spans = merged(trace.device)
    for (_, end), (nxt, _) in zip(spans, spans[1:]):
        name = _innermost(trace.host, (end + nxt) / 2, starts, order)
        by_op[name or "(no host op)"] += nxt - end
    return [[k, s] for k, s in sorted(by_op.items(),
                                      key=lambda kv: -kv[1])[:top]]
