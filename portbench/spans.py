"""The program's own spans in a reduced trace (``trace.Trace``).

``avion_tpu_torch`` records them through ``torch.profiler.record_function``
(``core.profiling.span``), so they lie on the same clock as the card's
activities, under names that start with ``avion.``:

- ``avion.step``, one a train step, and inside it its phases
  ``avion.step.{prep,forward,loss,backward,update}``, with ``.read`` (the
  host's read of the loss) inside ``.update``;
- ``avion.tower.<tower>``, a tower's forward, and the zero-length mark
  ``avion.tower.<tower>.bwd`` that its output's gradient records on the
  autograd engine's thread, where the tower's backward starts.  The engine
  runs one tower's backward after another (CLIP's text before its visual
  tower, VideoMAE's decoder before its encoder), so a tower's backward is
  every op on the mark's thread from its mark to the next tower's mark or
  to the end of the step's backward.

Every reader that uses this module returns None on a trace that holds no
``avion.`` span (a program that records none reads as nothing, not zero)
or no activity of the card (a trace taken on the CPU).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

from portbench import trace as tr
from portbench.trace import HostOp, Trace

PREFIX = "avion."
STEP = "avion.step"
BACKWARD = "avion.step.backward"
# each phase's part of the step, for its idle
PHASES = {"avion.step.prep": "fwd", "avion.step.forward": "fwd",
          "avion.step.loss": "fwd", "avion.step.backward": "bwd",
          "avion.step.update": "update", "avion.step.read": "update"}


def found(trace: Trace) -> bool:
    """The card ran something and the program recorded its spans."""
    return bool(trace.device) and any(op.name.startswith(PREFIX)
                                      for op in trace.host)


def named(trace: Trace, name: str) -> List[HostOp]:
    return [op for op in trace.host if op.name == name]


def device_s_in(trace: Trace, name: str) -> float:
    """Device seconds launched inside the spans named ``name``."""
    return tr.device_s_under(trace, lambda n: n == name)


def tower_s(trace: Trace, tower: str) -> float:
    """Device seconds of ``tower``: launched inside its forward span
    ``avion.tower.<tower>``, plus those launched on its mark's thread from
    its mark ``avion.tower.<tower>.bwd`` to the next tower's mark in the
    same step backward, or to that backward's end."""
    mark = f"avion.tower.{tower}.bwd"
    marks = [op for op in trace.host if op.name.startswith("avion.tower.")
             and op.name.endswith(".bwd")]
    by_thread: Dict[int, List[HostOp]] = defaultdict(list)
    for op in trace.host:
        if op.device_s:
            by_thread[op.thread].append(op)
    starts = {}
    for thread, ops in by_thread.items():
        ops.sort(key=lambda op: op.start)
        starts[thread] = [op.start for op in ops]
    total = device_s_in(trace, f"avion.tower.{tower}")
    for backward in named(trace, BACKWARD):
        inside = sorted((m for m in marks
                         if backward.start <= m.start <= backward.end),
                        key=lambda op: op.start)
        for k, m in enumerate(inside):
            if m.name != mark or m.thread not in by_thread:
                continue
            stop = (inside[k + 1].start if k + 1 < len(inside)
                    else backward.end)
            ops, at = by_thread[m.thread], starts[m.thread]
            lo, hi = bisect.bisect_left(at, m.start), bisect.bisect_left(
                at, stop)
            total += sum(op.device_s for op in ops[lo:hi])
    return total


def syncs(trace: Trace, reads: Iterable[str],
          waits: Iterable[str]) -> Optional[float]:
    """Host ops inside ``avion.step`` that wait for the card, a step: each
    op named in ``reads`` (a copy of a device scalar to the host), plus
    each one named in ``waits`` (the runtime's synchronizations) that does
    not lie inside one of ``reads`` on its thread.  Runtime events may
    carry no enclosing op, so both are matched by time."""
    steps = named(trace, STEP)
    if not steps:
        return None
    reads, waits = set(reads), set(waits)
    read_ops = [op for op in trace.host if op.name in reads]
    count = 0
    for op in trace.host:
        if not any(s.start <= op.start and op.end <= s.end for s in steps):
            continue
        if op.name in reads:
            count += 1
        elif op.name in waits and not any(
                r.thread == op.thread and r.start <= op.start
                and op.end <= r.end for r in read_ops):
            count += 1
    return count / len(steps)


def idle_by_phase(trace: Trace) -> Dict[str, float]:
    """The card's idle seconds in the trace, between its first and last
    activity, by the phase of the latest-starting open ``avion.step.*``
    span (on any thread) at each idle stretch's middle: ``fwd`` (prep,
    forward, loss), ``bwd``, ``update`` (with the read), or ``between``
    (no phase open)."""
    phases = sorted((op for op in trace.host if op.name in PHASES),
                    key=lambda op: op.start)
    starts = [op.start for op in phases]
    out = {"fwd": 0.0, "bwd": 0.0, "update": 0.0, "between": 0.0}
    busy = tr.merged(trace.device)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        mid = (end + nxt) / 2
        part = "between"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if phases[i].end >= mid:
                part = PHASES[phases[i].name]
                break
        out[part] += nxt - end
    return out


def window_idle_ms(ctx, part: str) -> Optional[float]:
    """Milliseconds a step of the window's idle in phase ``part``: the
    phase's share of the traced idle (``idle_by_phase``) times the
    window's idle a step, ``window_s / window_steps - busy_s /
    trace_steps``, which ``device.idle`` reads.  The profiler slows the
    host, so the traced steps' own idle would overstate it."""
    if not found(ctx.trace):
        return None
    by = idle_by_phase(ctx.trace)
    traced = sum(by.values())
    idle = (ctx.window_s / ctx.window_steps
            - tr.busy_s(ctx.trace) / ctx.trace_steps)
    return 1e3 * idle * by[part] / traced if traced else 0.0


def span_ms(ctx, name: str) -> Optional[float]:
    """Device milliseconds a step launched inside the spans ``name``."""
    if not found(ctx.trace) or not named(ctx.trace, name):
        return None
    return 1e3 * device_s_in(ctx.trace, name) / ctx.trace_steps


def tower_ms(ctx, tower: str) -> Optional[float]:
    """Device milliseconds a step of ``tower`` (``tower_s``)."""
    if not found(ctx.trace) or not named(ctx.trace, f"avion.tower.{tower}"):
        return None
    return 1e3 * tower_s(ctx.trace, tower) / ctx.trace_steps
