"""Ego4D NLQ evaluation: R@k at IoU thresholds + mean IoU (the port's own
copy of ``avion_tpu.egonlq.nlq_eval``, plain numpy).

Semantics of the official NLQ benchmark as used by the reference
(``egonlq/utils/evaluate_ego4d_nlq.py``): a query counts as recalled at
rank k / threshold t if any of its top-k predicted segments has
temporal IoU >= t with the ground truth; mIoU uses the rank-1 segment.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def temporal_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """pred [N, 2], gt [2] -> IoU [N]."""
    inter_l = np.maximum(pred[:, 0], gt[0])
    inter_r = np.minimum(pred[:, 1], gt[1])
    inter = np.clip(inter_r - inter_l, 0, None)
    union = (pred[:, 1] - pred[:, 0]) + (gt[1] - gt[0]) - inter
    return inter / np.maximum(union, 1e-9)


def evaluate_nlq(
    predictions: Sequence[np.ndarray],  # per query: [k, 2] (start, end)
    ground_truth: Sequence[Sequence[float]],  # per query: (start, end)
    thresholds: Sequence[float] = (0.3, 0.5),
    topk: Sequence[int] = (1, 5),
) -> Dict[str, float]:
    results = {(t, k): 0 for t in thresholds for k in topk}
    mious = []
    n = len(predictions)
    for pred, gt in zip(predictions, ground_truth):
        pred = np.asarray(pred, np.float64).reshape(-1, 2)
        gt = np.asarray(gt, np.float64)
        ious = temporal_iou(pred, gt)
        mious.append(float(ious[0]) if len(ious) else 0.0)
        for t in thresholds:
            for k in topk:
                if (ious[:k] >= t).any():
                    results[(t, k)] += 1
    out = {
        f"Rank@{k}_mIoU@{t}": 100.0 * results[(t, k)] / max(n, 1)
        for t in thresholds
        for k in topk
    }
    out["mIoU"] = 100.0 * float(np.mean(mious)) if mious else 0.0
    return out
