"""The readings that the limits of ``correct`` are set from, on the card at a
cell's own size; the benchmark's runs never run this.

Usage, from the root of a checkout::

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] --out <file.jsonl>

For each seed, in one process: the program's compared steps (as a run's
set-up takes them) and the f32 reference's, and their gaps
(``compare.py``); on the control seeds, the control: the reference in
float8 e4m3 products (``reference/precision.py``) in the program's place;
on the fault seeds, the program with half of each batch left out (the
loss then a mean over the rest).  One JSON line a reading goes to
``--out`` as it is made, with its seconds; a last line gives, for each
number, the largest gap of the program's seeds and the smallest of the
control's and of the fault's.

The two faults that need no run read 1 by their measure: a step that
returns its state unchanged (no leaf moves), and a leaf the program
leaves unmoved.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from portbench import cells, compare, run


def half_batch(step):
    def broken(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return broken


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    run.fix_caches()
    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    worst = {"program": {}, "control": {}, "half_batch": {}}
    with open(args.out, "a") as out:
        def emit(kind, seed, found, seconds):
            line = {"workload": args.workload, "kind": kind, "seed": seed,
                    "seconds": seconds,
                    **{n: found[n] for n in compare.NAMES},
                    "grad_leaf": found["grad_leaf"],
                    "change_leaf": found["change_leaf"],
                    "left_out": found["left_out"]}
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)
            pick = max if kind == "program" else min
            for n in compare.NAMES:
                old = worst[kind].get(n)
                worst[kind][n] = found[n] if old is None else pick(old,
                                                                   found[n])

        for seed in args.seeds:
            t0 = time.perf_counter()
            program, batches, readings, applied = run.first_steps(
                cell, seed, device)
            del program
            run.free(device)
            t1 = time.perf_counter()
            ref = run.reference_readings(cell, seed, batches, device)
            t2 = time.perf_counter()
            emit("program", seed, compare.gaps(readings, ref),
                 {"program": t1 - t0, "reference": t2 - t1,
                  "applied": applied})
            if seed in args.control_seeds:
                ctrl = run.reference_readings(cell, seed, batches, device,
                                              "fp8")
                emit("control", seed, compare.gaps(ctrl, ref),
                     {"control": time.perf_counter() - t2})
                del ctrl
            if seed in args.fault_seeds:
                t3 = time.perf_counter()
                program, _, broken, _ = run.first_steps(
                    cell, seed, device, wrap_step=half_batch)
                del program
                run.free(device)
                emit("half_batch", seed, compare.gaps(broken, ref),
                     {"fault": time.perf_counter() - t3})
                del broken
            del ref, readings, batches
            run.free(device)
        summary = {"workload": args.workload, "summary": worst,
                   "peak_bytes": torch.cuda.max_memory_allocated(device),
                   "card": torch.cuda.get_device_name(device)}
        out.write(json.dumps(summary) + "\n")
        print(json.dumps(summary), flush=True)
    return 0 if all(math.isfinite(v) for v in worst["program"].values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
