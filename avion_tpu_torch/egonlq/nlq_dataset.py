"""Ego4D NLQ annotation parsing + feature-based training batches (the
port's own copy of ``avion_tpu.egonlq.nlq_dataset``, plain numpy).

Counterpart of ``egonlq/utils/data_gen.py`` + ``Ego4D_NLQ_dataset.py``:
parses the official NLQ annotation json into (video_uid, clip window,
query, gt segment) samples and assembles padded feature batches with
span/highlight labels.

Two gaps of the JAX module are kept as they are (``ROADMAP.md``, "Gaps in
the JAX package itself"): :class:`NLQFeatureDataset` cuts the features to
``max_pos_len`` rows but maps the whole clip's duration onto the rows it
keeps, and the features are those of the whole video while the spans are
relative to the clip.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List

import numpy as np


def parse_nlq_annotations(path: str) -> List[Dict]:
    """Official Ego4D NLQ json -> flat sample list."""
    with open(path) as f:
        data = json.load(f)
    samples = []
    for video in data.get("videos", []):
        vid = video["video_uid"]
        for clip in video.get("clips", []):
            clip_start = clip.get("video_start_sec", 0.0)
            clip_end = clip.get("video_end_sec", 0.0)
            for ann in clip.get("annotations", []):
                for q in ann.get("language_queries", []):
                    if not q.get("query"):
                        continue
                    samples.append({
                        "video_uid": vid,
                        "clip_uid": clip.get("clip_uid", ""),
                        "clip_start": clip_start,
                        "clip_end": clip_end,
                        "query": q["query"],
                        "gt_start": q.get("clip_start_sec", 0.0),
                        "gt_end": q.get("clip_end_sec", 0.0),
                    })
    return samples


def make_labels(
    gt_start: float,
    gt_end: float,
    duration: float,
    n_features: int,
    extend_ratio: float = 0.1,
):
    """(start_idx, end_idx, highlight labels) on the feature grid; the
    highlight span is extended by ``extend_ratio`` on each side
    (reference data_gen extension semantics)."""
    scale = n_features / max(duration, 1e-6)
    s = int(np.clip(round(gt_start * scale), 0, n_features - 1))
    e = int(np.clip(round(gt_end * scale), s, n_features - 1))
    h = np.zeros(n_features, np.float32)
    ext = int(round((e - s + 1) * extend_ratio))
    h[max(0, s - ext) : min(n_features, e + ext + 1)] = 1.0
    return s, e, h


class NLQFeatureDataset:
    """Batches over precomputed per-sample features (feat_<i>.npz)."""

    def __init__(self, samples: List[Dict], feature_dir: str,
                 max_pos_len: int = 128):
        self.samples = samples
        self.feature_dir = feature_dir
        self.max_pos_len = max_pos_len

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        s = self.samples[i]
        data = np.load(osp.join(self.feature_dir, f"feat_{i}.npz"))
        video = data["video"]  # [Lv, D]
        text = data["text"]    # [D] pooled (or [Lq, D])
        if text.ndim == 1:
            text = text[None]
        n = min(len(video), self.max_pos_len)
        duration = s["clip_end"] - s["clip_start"]
        start, end, h = make_labels(
            s["gt_start"], s["gt_end"], duration, n)
        dv = video.shape[-1]
        vpad = np.zeros((self.max_pos_len, dv), np.float32)
        vpad[:n] = video[:n]
        vmask = np.zeros(self.max_pos_len, np.float32)
        vmask[:n] = 1.0
        hpad = np.zeros(self.max_pos_len, np.float32)
        hpad[:n] = h
        qlen = text.shape[0]
        return {
            "video": vpad,
            "v_mask": vmask,
            "query": text.astype(np.float32),
            "q_mask": np.ones(qlen, np.float32),
            "start_label": np.int32(start),
            "end_label": np.int32(end),
            "h_labels": hpad,
            "duration": np.float32(duration),
            "n_features": np.int32(n),
        }
