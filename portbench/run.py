"""Run one cell of the port's benchmark once and print its result.

Usage, from the root of a checkout, on a machine with the cell's cards::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

One run:

1. set-up: the cell's files (``cells.py``); the weights made on the card
   from ``--seed`` (``weights.py``) and loaded into the port's model, its
   optimizer and train step built by the cell's job (``jobs/``); the
   batches made on the card from ``--seed`` (``inputs.py``); the first
   ``warmup_steps`` train steps, which compile and warm every shape the
   window uses.  Of these, the first ``compared_steps`` give the
   readings that ``correct`` compares: each step's loss, each leaf's norm
   of the first gradient (from AdamW's first moment after one update) and
   of its change after the last compared step.
2. the window: train steps back to back over the cycled batches until
   ``--seconds`` have passed, ended by ``torch.cuda.synchronize()``;
   ``clips_per_s`` is every clip of every step over the window's time,
   ``peak_mem_gib`` the window's peak of allocated memory.
3. with ``--trace 1``: ``trace_steps`` more steps under ``torch.profiler``
   (``trace.py``), read by the per-layer metrics' readers (``metrics/``).
4. the program is freed, and the plain f32 reference (``reference/``)
   follows the compared steps from the same weights and batches; the
   comparison (``compare.py``) decides ``correct`` against the cell's
   limits (``limits/``).

The last line of standard output is the result as one JSON object; the
last lines of standard error are each compared number beside its limit.
Without a CUDA card (or with fewer than the cell asks for), or once
anything of JAX or the JAX package is loaded, the run prints no result and
exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from portbench import cells, compare, inputs, nojax, trace, weights
from portbench.flops import StepWork

CACHE_DIR = os.path.join(cells.BENCH_DIR, ".cache")


def process_start() -> float:
    """This process's start, in seconds since the epoch (Linux ``/proc``);
    the module's import time elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def fix_caches() -> None:
    """Triton's and Inductor's caches in fixed folders of the checkout, so
    that only a checkout's first run compiles.  The port builds its CUDA
    sources into ``avion_tpu_torch/ops/.build/`` of the checkout and uses
    neither today; a kernel that a later change adds through them finds
    its cache here without an edit to the harness."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


@dataclass
class MetricContext:
    """What a per-layer metric's reader (``metrics/<name>.py``) reads."""

    trace: trace.Trace
    trace_steps: int
    trace_wall_s: float
    window_steps: int
    window_s: float
    work: StepWork
    data: dict
    config: dict
    traffic: dict


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_steps(cell: cells.Cell, seed: int, device,
                wrap_step: Optional[Callable] = None):
    """Set-up through the warm-up steps: (program, batches, readings,
    every warm-up step applied).  ``wrap_step(step) -> step`` plants a
    fault in the program's call (calibration and tests)."""
    from portbench.jobs import changes, first_grad_norms

    marks = {"start": time.time()}
    spec = cell.family.weight_spec(cell.config, cell.traffic)
    program = cell.job.build(cell.config, cell.traffic,
                             weights.make(spec, seed, device), device)
    if wrap_step is not None:
        program.step = wrap_step(program.step)
    batches = inputs.make(cell.config, cell.traffic, seed, device)
    sync(device)
    marks["built"] = time.time()
    compared = cell.traffic["compared_steps"]
    warm = max(compared, cell.traffic["warmup_steps"])
    losses, applied, readings = [], True, {}
    for k in range(warm):
        metrics = program.run(batches[k % len(batches)])
        applied = applied and metrics["step_ok"] == 1.0
        if k < compared:
            losses.append(metrics["loss"].detach().float())
        if k == 0:
            readings["grad"] = first_grad_norms(program)
        if k == compared - 1:
            readings["change"] = changes(program,
                                         weights.make(spec, seed, device))
    readings["loss"] = [float(x) for x in losses]
    sync(device)
    marks["warm"] = time.time()
    readings["marks"] = marks
    return program, batches, readings, applied


def reference_readings(cell: cells.Cell, seed: int, batches: List[dict],
                       device, precision: str = "float32") -> dict:
    from portbench.reference.train import follow

    spec = cell.family.weight_spec(cell.config, cell.traffic)
    return follow(cell.config["family"], cell.config, cell.traffic,
                  weights.make(spec, seed, device), batches,
                  cell.traffic["compared_steps"], precision)


def free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def profile_steps(program, batches: List[dict], first: int, n: int,
                  device):
    """``n`` steps under the profiler: (reduced trace, their wall s)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for k in range(first, first + n):
            program.run(batches[k % len(batches)])
        sync(device)
        wall = time.perf_counter() - t0
    return trace.from_profile(prof), wall


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             device, started: Optional[float] = None,
             wrap_step: Optional[Callable] = None) -> dict:
    """One run of ``cell``: the result's fields (without the import
    check)."""
    import torch

    started = process_start() if started is None else started
    program, batches, readings, applied = first_steps(cell, seed, device,
                                                      wrap_step)
    sync(device)
    setup_s = time.time() - started
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    k = max(cell.traffic["compared_steps"], cell.traffic["warmup_steps"])
    steps = failed = 0
    t0 = time.perf_counter()
    while True:
        metrics = program.run(batches[k % len(batches)])
        k += 1
        steps += 1
        failed += metrics["step_ok"] != 1.0
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    profiled = None
    t1 = time.perf_counter()
    if traced:
        profiled = profile_steps(program, batches, k,
                                 cell.traffic["trace_steps"], device)
    del program, metrics
    free(device)
    t2 = time.perf_counter()
    ref = reference_readings(cell, seed, batches, device)
    found = compare.gaps(readings, ref)
    correct, checked = compare.judge(found, cell.limits)
    batch = cell.traffic["batch"]
    # a step that skipped its update (a loss that is not finite) is a fault
    out = {"correct": bool(correct and applied and not failed),
           "attempted": steps, "failed": int(failed)}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if not traced:
        values = {"clips_per_s": steps * batch / window_s,
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"].split(".")[0]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    else:
        reduced, wall = profiled
        work = cell.family.step_work(cell.config, cell.traffic)
        out["metrics"] = {}
        for m in cell.per_layer:
            reader, data = cells.metric_reader(m["name"])
            value = reader.read(MetricContext(
                reduced, cell.traffic["trace_steps"], wall, steps, window_s,
                work, data, cell.config, cell.traffic))
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        device_info["busy_s"] = trace.busy_s(reduced)
        device_info["window_s"] = wall
        out["breakdown"] = {"device_ops": trace.top_device_ops(reduced),
                            "idle_gaps": trace.idle_gaps(reduced)}
    out["device"] = device_info
    marks = readings["marks"]
    out["seconds"] = {"imports": marks["start"] - started,
                      "build": marks["built"] - marks["start"],
                      "warmup": marks["warm"] - marks["built"],
                      "setup": setup_s, "window": window_s,
                      "trace": t2 - t1, "reference": time.perf_counter() - t2}
    out["readings"] = {
        "loss": readings["loss"],
        "gaps": {n: found[n] for n in compare.NAMES},
        "grad_leaf": found["grad_leaf"], "change_leaf": found["change_leaf"],
        "left_out": found["left_out"], "steps_applied": applied}
    out["checked"] = checked
    return out


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    started = process_start()
    fix_caches()
    cell = cells.load(args.workload)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), started)
    loaded = nojax.forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {loaded}, which it must not",
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    for name, c in out["checked"].items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        sys.stderr.write(f"{name} {c['value']!r} limit {c['limit']!r} "
                         f"{'ok' if ok else 'FAILED'}\n")
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
