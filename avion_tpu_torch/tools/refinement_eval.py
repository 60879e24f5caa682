"""Evaluate refined caption temporal boundaries against annotations (the
port's copy of ``avion_tpu.tools.refinement_eval``).

Counterpart of ``second_party/evaluate_refined_dataset/main.py:18-35``
and ``second_party/utils/evaluate_refinement.py``: temporal IoU between
LLM-refined clip windows and manually annotated ground truth, with
summary statistics (mean IoU, IoU histogram, recall at thresholds).

Usage::

    python -m avion_tpu_torch.tools.refinement_eval \
        --refined refined.pkl --annotated annotated.csv --key video_uid
"""

from __future__ import annotations

import argparse
import csv
import json
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np


def interval_iou(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = (a[1] - a[0]) + (b[1] - b[0]) - inter
    return inter / union if union > 0 else 0.0


def load_segments(path: str) -> Dict[str, Tuple[float, float]]:
    """Load {sample_key: (start, end)} from pkl rows or csv."""
    segs = {}
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            rows = pickle.load(f)
        for i, row in enumerate(rows):
            key = f"{row[0]}_{i}"
            segs[key] = (float(row[1]), float(row[2]))
    else:
        with open(path) as f:
            reader = csv.DictReader(f)
            for i, row in enumerate(reader):
                key = row.get("key", f"{row.get('video_uid', i)}_{i}")
                segs[key] = (float(row["start"]), float(row["end"]))
    return segs


def evaluate_refinement(
    refined: Dict[str, Tuple[float, float]],
    annotated: Dict[str, Tuple[float, float]],
    thresholds=(0.3, 0.5, 0.7),
) -> Dict[str, float]:
    keys = sorted(set(refined) & set(annotated))
    ious = np.array([interval_iou(refined[k], annotated[k]) for k in keys])
    out = {
        "n_matched": len(keys),
        "mean_iou": float(ious.mean()) if len(ious) else 0.0,
        "median_iou": float(np.median(ious)) if len(ious) else 0.0,
    }
    for t in thresholds:
        out[f"recall@{t}"] = float((ious >= t).mean()) if len(ious) else 0.0
    return out


def scaling_analysis(
    refined: Dict[str, Tuple[float, float]],
    annotated: Dict[str, Tuple[float, float]],
    min_scale: float = 0.5,
    max_scale: float = 3.0,
    step: float = 0.1,
    thresholds=(0.1, 0.3, 0.5, 0.7, 0.9),
    durations: Optional[Dict[str, float]] = None,
) -> Dict[str, list]:
    """Sweep center-anchored window scaling and measure IoU metrics.

    Counterpart of ``second_party/utils/evaluate_refinement.py``'s
    ``analyze_scaling_effect`` (:262-321): for each scale factor the
    refined windows are rescaled about their centers and evaluated
    against the annotations, yielding mIoU and recall@t curves over the
    sweep — the tool used to pick the training-time window scale.
    ``durations`` (per-key video durations, e.g. built from
    ``dataset_tools.compute_video_lengths``) clamps scaled windows to
    the video like the reference's ``jitter_scale_window``.
    """
    from avion_tpu_torch.tools.alignment_ablation import perturb_window

    scales = [round(s, 10) for s in
              np.arange(min_scale, max_scale + step / 2, step)]
    out = {"scales": scales, "mIoU": [],
           **{f"recall@{t}": [] for t in thresholds}}
    keys = sorted(set(refined) & set(annotated))
    for s in scales:
        scaled = {
            k: perturb_window(
                *refined[k], "scale", s,
                max_duration=(durations or {}).get(k, float("inf")))
            for k in keys}
        ious = np.array([interval_iou(scaled[k], annotated[k])
                         for k in keys]) if keys else np.array([])
        out["mIoU"].append(float(ious.mean()) if len(ious) else 0.0)
        for t in thresholds:
            out[f"recall@{t}"].append(
                float((ious >= t).mean()) if len(ious) else 0.0)
    return out


def peak_summary(scale_results: Dict[str, list]) -> Dict[str, dict]:
    """Optimal scale per metric (``print_scaling_peak_analysis``,
    ``evaluate_refinement.py:321-360``); the reference recommends the
    recall@0.5 peak for training."""
    scales = scale_results.get("scales") or []
    out = {}
    for name, vals in scale_results.items():
        if name == "scales" or not vals:
            continue
        i = int(np.argmax(vals))
        out[name] = {"scale": scales[i], "value": vals[i]}
    if "recall@0.5" in out:
        out["recommended_scale"] = out["recall@0.5"]["scale"]
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--refined", required=True)
    p.add_argument("--annotated", required=True)
    p.add_argument("--scale-sweep", action="store_true",
                   help="also sweep window scale factors and report "
                        "per-metric optima")
    p.add_argument("--min-scale", type=float, default=0.5)
    p.add_argument("--max-scale", type=float, default=3.0)
    p.add_argument("--scale-step", type=float, default=0.1)
    args = p.parse_args(argv)
    refined = load_segments(args.refined)
    annotated = load_segments(args.annotated)
    out = evaluate_refinement(refined, annotated)
    if args.scale_sweep:
        sweep = scaling_analysis(refined, annotated, args.min_scale,
                                 args.max_scale, args.scale_step)
        out["scale_sweep"] = sweep
        out["scale_peaks"] = peak_summary(sweep)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
