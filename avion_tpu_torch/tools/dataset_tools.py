"""Dataset factory utilities: subsets, statistics, caption merging (the
port's copy of ``avion_tpu.tools.dataset_tools``).

Counterparts of second_party helpers:
- fast-iteration subset creation (``second_party/utils`` subset scripts,
  consumed by ``--subsample_stride`` in the trainer)
- clip-length / caption statistics (``dataset_statistics/compute.ipynb``)
- hierarchical caption merging of sequential pairs
  (``second_party/hierarchical_ds_factory/main.py:15-35``) with a
  pluggable LLM merge function
- caption dedup/merge preprocessing (``preprocess/dataset_preprocessing_
  phase1.py:32-47`` semantics: merge near-duplicate consecutive
  captions)
- video duration table (``utils/compute_video_lengths.py``), uuid
  stamping of caption variants
  (``utils/create_lavila_rephrased_dataset_with_uuid.py``) and refined
  timestamp transplant onto another caption variant
  (``utils/copy_timestamps_to_lavila_dataset.py``)
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def subset_metadata(input_path: str, output_path: str, *,
                    stride: int = 0, fraction: float = 0.0,
                    seed: int = 0) -> int:
    with open(input_path, "rb") as f:
        rows = pickle.load(f)
    if stride:
        rows = rows[::stride]
    elif fraction:
        rng = np.random.RandomState(seed)
        idx = rng.choice(len(rows), int(len(rows) * fraction), replace=False)
        rows = [rows[i] for i in sorted(idx)]
    with open(output_path, "wb") as f:
        pickle.dump(rows, f)
    return len(rows)


def dataset_statistics(samples: Sequence) -> Dict[str, float]:
    """Clip duration and caption-length statistics."""
    durations = np.array([float(r[2]) - float(r[1]) for r in samples])
    cap_lens = np.array([
        len(str(r[3] if not isinstance(r[3], list) else " ".join(r[3])).split())
        for r in samples
    ])
    vids = {r[0] for r in samples}
    return {
        "n_samples": len(samples),
        "n_videos": len(vids),
        "duration_mean": float(durations.mean()) if len(durations) else 0,
        "duration_p50": float(np.median(durations)) if len(durations) else 0,
        "duration_p95": float(np.percentile(durations, 95)) if len(durations) else 0,
        "caption_len_mean": float(cap_lens.mean()) if len(cap_lens) else 0,
    }


def _token_overlap(a: str, b: str) -> float:
    ta, tb = set(a.lower().split()), set(b.lower().split())
    if not ta or not tb:
        return 0.0
    return len(ta & tb) / len(ta | tb)


def dedup_consecutive_captions(
    samples: Sequence,
    overlap_threshold: float = 0.8,
    max_gap: float = 2.0,
) -> List[Tuple]:
    """Merge consecutive near-duplicate captions on the same video into
    one span (phase-1 preprocessing semantics)."""
    by_vid: Dict[str, List] = {}
    for r in samples:
        by_vid.setdefault(r[0], []).append(list(r))
    out = []
    for vid, rows in by_vid.items():
        rows.sort(key=lambda r: float(r[1]))
        merged = [rows[0]]
        for r in rows[1:]:
            prev = merged[-1]
            cap_prev = str(prev[3] if not isinstance(prev[3], list) else prev[3][0])
            cap_cur = str(r[3] if not isinstance(r[3], list) else r[3][0])
            if (_token_overlap(cap_prev, cap_cur) >= overlap_threshold
                    and float(r[1]) - float(prev[2]) <= max_gap):
                prev[2] = max(float(prev[2]), float(r[2]))
            else:
                merged.append(r)
        out.extend(tuple(r) for r in merged)
    return out


def hierarchical_merge(
    samples: Sequence,
    merge_fn: Callable[[str, str], Optional[str]],
    max_gap: float = 3.0,
) -> List[Tuple]:
    """Merge sequential caption pairs into hierarchical (coarser)
    captions using a pluggable LLM merge function
    (``hierarchical_ds_factory/main.py``): pairs of temporally adjacent
    clips on the same video become one clip whose caption is the LLM's
    summary of both."""
    by_vid: Dict[str, List] = {}
    for r in samples:
        by_vid.setdefault(r[0], []).append(r)
    out = []
    for vid, rows in by_vid.items():
        rows = sorted(rows, key=lambda r: float(r[1]))
        i = 0
        while i < len(rows):
            if i + 1 < len(rows) and float(rows[i + 1][1]) - float(rows[i][2]) <= max_gap:
                a, b = rows[i], rows[i + 1]
                cap = None
                try:
                    cap = merge_fn(str(a[3]), str(b[3]))
                except Exception:
                    cap = None
                if cap:
                    out.append((vid, float(a[1]), float(b[2]), cap))
                    i += 2
                    continue
            out.append(tuple(rows[i]))
            i += 1
    return out


# ---------------------------------------------------------------------------
# phase-2 preprocessing: embedding-based caption grouping
# (second_party/preprocess/dataset_preprocessing_phase2.py)
# ---------------------------------------------------------------------------

PHASE2_TASK = ("Identify the underlying action in this sentence for the "
               "purpose of grouping identical events.")


def make_hf_embedder(model_id: str = "Qwen/Qwen3-Embedding-8B",
                     task: str = PHASE2_TASK, batch_size: int = 32,
                     max_length: int = 512):
    """Default embedding backend (transformers, last-token pool +
    L2 norm — the reference's Qwen3-Embedding recipe).  Returns
    ``embed(texts) -> [N, D] np.ndarray``.  Heavy import is deferred so
    tests can inject a fake embedder instead."""
    import torch
    from transformers import AutoModel, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_id, padding_side="left")
    model = AutoModel.from_pretrained(model_id, torch_dtype=torch.bfloat16)
    model.eval()

    def embed(texts):
        import numpy as np
        import torch.nn.functional as F

        outs = []
        for i in range(0, len(texts), batch_size):
            chunk = [f"Instruct: {task}\nQuery:{t}"
                     for t in texts[i : i + batch_size]]
            batch = tokenizer(chunk, padding=True, truncation=True,
                              max_length=max_length, return_tensors="pt")
            with torch.inference_mode():
                hidden = model(**batch).last_hidden_state
                # last-token pool under left padding
                emb = hidden[:, -1]
                outs.append(F.normalize(emb.float(), p=2, dim=1).numpy())
        return np.concatenate(outs, axis=0)

    return embed


def phase2_group_captions(
    samples: Sequence,
    embed_fn: Callable[[List[str]], "np.ndarray"],
    similarity_threshold: float = 0.9,
) -> List[Tuple[str, str]]:
    """Embedding-based grouping of temporally-overlapping consecutive
    captions (phase-2 semantics, ``dataset_preprocessing_phase2.py``):
    for each video's time-sorted segments, a consecutive pair with
    ``next.start <= cur.end`` and different captions is merged when the
    cosine similarity of the caption embeddings exceeds the threshold.

    ``samples`` rows are ``(uuid, video_id, start, end, caption)``.
    Unlike the reference (which embeds each pair separately — its own
    NOTE says "I need to optimize it"), all unique captions are embedded
    ONCE in batches and pairs are scored from the cached table.

    Returns the uuid pairs to merge.
    """
    import numpy as np

    by_vid: Dict[str, List] = {}
    for r in samples:
        by_vid.setdefault(r[1], []).append(r)

    # collect candidate pairs + the unique captions they need
    pairs = []
    captions: Dict[str, int] = {}
    for vid, rows in by_vid.items():
        rows.sort(key=lambda r: float(r[2]))
        for cur, nxt in zip(rows, rows[1:]):
            if cur[4] == nxt[4]:
                continue  # exact duplicates handled in phase 1
            if float(nxt[2]) <= float(cur[3]):  # temporal overlap
                for c in (cur[4], nxt[4]):
                    captions.setdefault(str(c), len(captions))
                pairs.append((cur, nxt))
    if not pairs:
        return []

    texts = [t for t, _ in sorted(captions.items(), key=lambda kv: kv[1])]
    emb = np.asarray(embed_fn(texts), np.float32)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-8)

    merge = []
    for cur, nxt in pairs:
        sim = float(emb[captions[str(cur[4])]] @ emb[captions[str(nxt[4])]])
        if sim > similarity_threshold:
            merge.append((cur[0], nxt[0]))
    return merge


def compute_video_lengths(video_root: str, out_path: Optional[str] = None,
                          ) -> Dict[str, float]:
    """Duration (seconds) per video under ``video_root``
    (``utils/compute_video_lengths.py``) — the table the scaling
    analysis uses to clamp scaled windows.  Handles both flat ``.mp4``
    files and the chunked layout (``<vid>.mp4/<start>.mp4`` directories
    sum their chunks).  Unreadable files count as 0.0, like the
    reference."""
    import glob
    import os.path as osp

    from avion_tpu_torch.data.video_reader import DecodeError, VideoReader

    def duration(path: str) -> float:
        try:
            vr = VideoReader(path)
            fps = vr.get_avg_fps() or 0.0
            d = len(vr) / fps if fps > 0 else 0.0
            vr.close()
            return d
        except DecodeError:
            return 0.0

    out: Dict[str, float] = {}
    for entry in sorted(os.listdir(video_root)):
        p = osp.join(video_root, entry)
        if osp.isdir(p):  # chunked: sum the chunks
            chunks = sorted(glob.glob(osp.join(p, "*.*")))
            out[entry] = float(sum(duration(c) for c in chunks))
        elif entry.lower().endswith((".mp4", ".mkv", ".avi", ".webm")):
            out[entry] = duration(p)
    if out_path:
        import json

        with open(out_path, "w") as f:
            json.dump(out, f)
    return out


def attach_uuids(original_with_uuid: Sequence, variant: Sequence,
                 *, check: bool = True) -> List[Tuple]:
    """Stamp a caption-variant pkl (4-tuples ``(vid, start, end,
    captions)``) with the uuids of the positionally aligned original
    5-tuples ``(uuid, vid, start, end, caption)``
    (``utils/create_lavila_rephrased_dataset_with_uuid.py``).  With
    ``check`` the windows must agree row-by-row."""
    out = []
    for o, v in zip(original_with_uuid, variant):
        if check:
            if float(o[2]) != float(v[1]) or float(o[3]) != float(v[2]):
                raise ValueError(
                    f"window mismatch for uuid {o[0]}: "
                    f"({o[2]}, {o[3]}) vs ({v[1]}, {v[2]})")
        out.append((o[0], v[0], v[1], v[2], v[3]))
    return out


def transplant_timestamps(source_timestamps: Sequence,
                          caption_variant: Sequence) -> List[Tuple]:
    """Copy refined [start, end) windows onto another uuid-stamped
    caption variant (``utils/copy_timestamps_to_lavila_dataset.py``):
    both inputs are 5-tuples ``(uuid, vid, start, end, captions)``;
    the output keeps the variant's vid+captions with the source's
    window, dropping rows whose uuid has no refined counterpart."""
    refined = {r[0]: r for r in source_timestamps}
    out = []
    for row in caption_variant:
        src = refined.get(row[0])
        if src is not None:
            out.append((row[0], row[1], src[2], src[3], row[4]))
    return out


def strip_uuid(rows: Sequence) -> List[Tuple]:
    """5-tuples -> the 4-tuple trainer format (drop the uuid column)."""
    return [tuple(r[1:]) for r in rows]


def apply_merge_pairs(samples: Sequence,
                      merge_pairs: Sequence[Tuple[str, str]]) -> List[Tuple]:
    """Apply phase-2 merge pairs: union the uuid pairs into groups and
    collapse each group to one span (min start, max end, first caption) —
    the phase-3 assembly step over phase-2 output."""
    parent: Dict[str, str] = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in merge_pairs:
        parent[find(a)] = find(b)

    groups: Dict[str, List] = {}
    order = []
    for r in samples:
        g = find(r[0])
        if g not in groups:
            order.append(g)
        groups.setdefault(g, []).append(r)
    out = []
    for g in order:
        rows = sorted(groups[g], key=lambda r: float(r[2]))
        first = rows[0]
        out.append((first[0], first[1],
                    min(float(r[2]) for r in rows),
                    max(float(r[3]) for r in rows), first[4]))
    return out
