"""EPIC-Kitchens-100 multi-instance retrieval metrics (mAP, nDCG): a copy
of ``avion_tpu.eval.retrieval_metrics``, which the port does not import.

Semantics follow the official EK100 retrieval benchmark as used by the
reference (``avion/utils/evaluation_ek100mir.py:17-210``): graded
relevancy, per-query DCG truncated to the number of relevant items,
AP counting strictly-relevant (rel == 1) retrievals.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _ap_per_row(sim: np.ndarray, rel: np.ndarray) -> np.ndarray:
    order = np.argsort(-sim, axis=1)
    ranked_rel = np.take_along_axis(rel, order, axis=1)
    hits = ranked_rel == 1
    cum_hits = np.cumsum(hits, axis=1) * hits  # precision numerator at hits
    prec = cum_hits / (np.arange(rel.shape[1]) + 1)[None, :]
    n_rel = hits.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        ap = prec.sum(axis=1) / n_rel
    return ap


def calculate_map(sim: np.ndarray, rel: np.ndarray) -> float:
    return float(np.mean(_ap_per_row(sim, rel)))


def k_count_mask(rel: np.ndarray) -> np.ndarray:
    """[n1, n2] mask, row i has ones in the first k_i sorted positions
    where k_i = number of relevant items for query i."""
    k = (rel > 0).sum(axis=1)
    cols = np.arange(rel.shape[1])[None, :]
    return (cols < k[:, None]).astype(np.float64)


def _dcg(sim: np.ndarray, rel: np.ndarray, kc: np.ndarray) -> np.ndarray:
    # exact reference sort expression (evaluation_ek100mir.py:42) so tie
    # order — and hence DCG/IDCG — is bit-identical, ties included
    order = np.argsort(sim, axis=1)[:, ::-1]
    ranked_rel = np.take_along_axis(rel, order, axis=1) * kc
    divisors = np.log2(np.arange(rel.shape[1]) + 2)[None, :]
    return (ranked_rel / divisors).sum(axis=1)


def calculate_ndcg(sim: np.ndarray, rel: np.ndarray) -> float:
    kc = k_count_mask(rel)
    dcg = _dcg(sim, rel, kc)
    idcg = _dcg(rel, rel, kc)
    with np.errstate(invalid="ignore", divide="ignore"):
        ndcg = np.where(idcg > 0, dcg / idcg, 0.0)
    return float(np.mean(ndcg))


def get_map(sim: np.ndarray, rel: np.ndarray) -> Tuple[float, float, float]:
    v = calculate_map(sim, rel)
    t = calculate_map(sim.T, rel.T)
    return v, t, (v + t) / 2


def get_ndcg(sim: np.ndarray, rel: np.ndarray) -> Tuple[float, float, float]:
    v = calculate_ndcg(sim, rel)
    t = calculate_ndcg(sim.T, rel.T)
    return v, t, (v + t) / 2
