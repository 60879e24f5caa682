"""Temporal-alignment ablation: systematic timestamp perturbation (the
port's copy of ``avion_tpu.tools.alignment_ablation``).

Counterpart of ``second_party/alignment_ablation/augment_{ego4d,
ek100_mir,ek100_cls}.py``: produce perturbed copies of training
metadata to measure sensitivity to annotation alignment
(``augment_ek100_mir.py:41-50`` semantics: additive seconds or
multiplicative scaling of each clip's [start, end] window, center-
anchored for scaling).

Usage::

    python -m avion_tpu_torch.tools.alignment_ablation \
        --input meta.pkl --output meta_add2.pkl --mode add --amount 2.0
    python -m avion_tpu_torch.tools.alignment_ablation \
        --input meta.pkl --output meta_scale1p5.pkl --mode scale --amount 1.5
"""

from __future__ import annotations

import argparse
import csv
import pickle
from typing import List, Tuple


def perturb_window(start: float, end: float, mode: str, amount: float,
                   max_duration: float = float("inf")) -> Tuple[float, float]:
    if mode == "add":
        # extend symmetrically by `amount` seconds on each side
        new_start = max(0.0, start - amount)
        new_end = min(max_duration, end + amount)
    elif mode == "scale":
        # scale the window around its center by `amount`
        center = (start + end) / 2
        half = (end - start) / 2 * amount
        new_start = max(0.0, center - half)
        new_end = min(max_duration, center + half)
    elif mode == "shift":
        new_start = max(0.0, start + amount)
        new_end = min(max_duration, end + amount)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return new_start, max(new_end, new_start + 1e-3)


def augment_ego4d_pkl(input_path: str, output_path: str, mode: str,
                      amount: float):
    with open(input_path, "rb") as f:
        samples = pickle.load(f)
    out = []
    for row in samples:
        vid, start, end = row[0], float(row[1]), float(row[2])
        new_start, new_end = perturb_window(start, end, mode, amount)
        out.append((vid, new_start, new_end) + tuple(row[3:]))
    with open(output_path, "wb") as f:
        pickle.dump(out, f)
    return len(out)


def augment_ek100_csv(input_path: str, output_path: str, mode: str,
                      amount: float):
    """Rewrites start/stop timestamp columns of an EPIC-100 csv."""

    def sec2ts(sec: float) -> str:
        h = int(sec // 3600)
        m = int((sec % 3600) // 60)
        s = sec % 60
        return f"{h:02d}:{m:02d}:{s:05.2f}"

    from avion_tpu_torch.data.metadata import datetime2sec

    with open(input_path) as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    for row in rows:
        start, end = datetime2sec(row[4]), datetime2sec(row[5])
        ns, ne = perturb_window(start, end, mode, amount)
        row[4], row[5] = sec2ts(ns), sec2ts(ne)
    with open(output_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return len(rows)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--mode", choices=["add", "scale", "shift"], required=True)
    p.add_argument("--amount", type=float, required=True)
    args = p.parse_args(argv)
    if args.input.endswith(".pkl"):
        n = augment_ego4d_pkl(args.input, args.output, args.mode, args.amount)
    else:
        n = augment_ek100_csv(args.input, args.output, args.mode, args.amount)
    print(f"wrote {n} perturbed samples to {args.output}")


if __name__ == "__main__":
    main()
