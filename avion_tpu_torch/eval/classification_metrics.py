"""Classification / zero-shot metrics: a copy of
``avion_tpu.eval.classification_metrics``, which the port does not import.

Numpy reimplementations of the reference's evaluation helpers:
- top-k accuracy (``evaluation_common.py:12-27``)
- confusion-matrix mean-class accuracy (``evaluation_common.py:29-37``)
- verb/noun marginalization for EK100-CLS (``evaluation_ek100cls.py:12-34``)
- Charades multi-label mAP (``evaluation_charades.py:41-76``)
- EgoMCQ intra/inter accuracy (``evaluation_egomcq.py:12-27``)
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def topk_accuracy(logits: np.ndarray, labels: np.ndarray,
                  topk: Sequence[int] = (1,)) -> List[float]:
    maxk = max(topk)
    preds = np.argsort(-logits, axis=1)[:, :maxk]
    correct = preds == labels[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]


def confusion_matrix(preds: np.ndarray, labels: np.ndarray,
                     n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(cm, (labels, preds), 1)
    return cm


def mean_class_accuracy(cm: np.ndarray) -> Tuple[float, float]:
    """(mean per-class acc, overall acc) from a confusion matrix."""
    row = cm.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        per_class = np.where(row > 0, np.diag(cm) / np.maximum(row, 1), 0.0)
    return 100.0 * float(per_class.mean()), 100.0 * float(
        np.trace(cm) / max(cm.sum(), 1)
    )


def get_marginal_indexes(action_to_parts: Sequence[Tuple[int, int]],
                         mode: str) -> List[np.ndarray]:
    """action index -> verb/noun grouping. ``action_to_parts`` is the
    ordered list of (verb, noun) for each action class."""
    col = 0 if mode == "verb" else 1
    parts = np.asarray([a[col] for a in action_to_parts])
    out = []
    for v in range(parts.max() + 1):
        idx = np.nonzero(parts == v)[0]
        out.append(idx if len(idx) else np.array([0]))
    return out


def marginalize(probs: np.ndarray, indexes: List[np.ndarray]) -> np.ndarray:
    return np.stack([probs[:, ix].sum(1) for ix in indexes], axis=1)


def compute_map(scores: np.ndarray, gt: np.ndarray):
    """Multi-label AP per class; returns (mAP, weighted AP, per-class)."""
    n_classes = scores.shape[1]
    aps = []
    for c in range(n_classes):
        order = np.argsort(-scores[:, c])
        tp = gt[order, c] == 1
        n_pos = tp.sum()
        if n_pos < 0.1:
            aps.append(np.nan)
            continue
        cum_tp = np.cumsum(tp)
        prec = cum_tp / (np.arange(len(tp)) + 1)
        aps.append((prec * tp).sum() / n_pos)
    aps = np.asarray(aps)
    m_ap = float(np.nanmean(aps))
    w_ap = aps * gt.sum(axis=0) / gt.sum()
    return m_ap, w_ap, aps


def charades_map(scores: np.ndarray, gt: np.ndarray):
    """Charades protocol: rows without ground truth are excluded by
    -inf scores (``evaluation_charades.py:68-76``)."""
    fixed = scores.copy()
    fixed[gt.sum(axis=1) == 0, :] = -np.inf
    return compute_map(fixed, gt)


def egomcq_accuracy(preds: np.ndarray, labels: np.ndarray,
                    types: np.ndarray) -> Dict[str, float]:
    """5-way MCQ accuracy split by intra(1)/inter(2)-video types."""
    out = {}
    for type_id, name in zip(np.unique(types), ("Intra-video", "Inter-video")):
        sel = types == type_id
        correct = (np.argmax(preds[sel], axis=1) == labels[sel]).sum()
        out[name] = 100.0 * correct / max(sel.sum(), 1)
    return out


ZERO_SHOT_TEMPLATES = ["#C C {}", "#C {}"]  # evaluation_common.py:8-9
