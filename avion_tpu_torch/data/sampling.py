"""Frame-id sampling and chunked-video clip loading
(``avion_tpu.data.sampling``).

The sampling semantics of the reference's ``clip_dataset.py``:
- ``get_frame_ids``: segment centers over [start, end) with optional
  per-segment uniform jitter of one segment width.
- ``load_clip``: single-file or 15-second-chunked layouts; missing chunks
  walk back; decode errors fall back to frame 0; a fully missing video
  yields a zero placeholder clip.
- VideoMAE strided sampling: fixed stride with random (train) or centered
  (eval) shift.
"""

from __future__ import annotations

import os.path as osp
from typing import List, Optional

import numpy as np

from avion_tpu_torch.data.video_reader import CropSpec, DecodeError, VideoReader


def get_frame_ids(
    start_frame: int,
    end_frame: int,
    num_segments: int = 32,
    jitter: bool = True,
    rng: Optional[np.random.RandomState] = None,
) -> List[int]:
    edges = np.linspace(start_frame, end_frame, num_segments + 1)
    centers = (edges[:-1] + edges[1:]) / 2.0
    if jitter:
        rng = rng or np.random
        seg_size = float(end_frame - start_frame - 1) / num_segments
        centers = centers + (rng.rand(num_segments) - 0.5) * seg_size
    return centers.astype(int).tolist()


def strided_frame_ids(
    num_frames_total: int,
    clip_length: int,
    stride: int,
    random_shift: bool = True,
    rng: Optional[np.random.RandomState] = None,
) -> List[int]:
    """VideoMAE-style dense strided sampling with shift."""
    span = clip_length * stride
    rng = rng or np.random
    if num_frames_total > span:
        start = (
            int(rng.randint(0, num_frames_total - span + 1))
            if random_shift
            else (num_frames_total - span) // 2
        )
    else:
        start = 0
    ids = start + np.arange(clip_length) * stride
    return np.minimum(ids, num_frames_total - 1).astype(int).tolist()


def load_clip(
    root: str,
    vid: str,
    ext: str,
    second: float,
    end_second: float,
    *,
    chunk_len: int = 15,
    fps: float = 30,
    clip_length: int = 32,
    threads: int = 1,
    crop: Optional[CropSpec] = None,
    out_size: Optional[tuple] = None,
    jitter: bool = False,
    rng: Optional[np.random.RandomState] = None,
    reader_cache: Optional[dict] = None,
    fast: bool = False,
) -> np.ndarray:
    """Load a [T, H, W, 3] uint8 clip spanning [second, end_second).

    Chunked layout: ``root/vid.ext/<chunk_start>.ext`` files of
    ``chunk_len`` seconds each; ``chunk_len=-1``: one file per video.
    """
    crop = crop or CropSpec()

    def open_reader(path):
        if reader_cache is not None and path in reader_cache:
            return reader_cache[path]
        vr = VideoReader(path, num_threads=threads, fast=fast)
        if reader_cache is not None:
            if len(reader_cache) > 32:
                reader_cache.clear()
            reader_cache[path] = vr
        return vr

    def placeholder():
        size = out_size or (224, 224)
        return np.zeros((clip_length, size[1], size[0], 3), np.uint8)

    if chunk_len == -1:
        # video-list metadata carries the extension in vid already
        fname = vid if vid.lower().endswith(f".{ext}".lower()) \
            else f"{vid}.{ext}"
        path = osp.join(root, fname)
        try:
            vr = open_reader(path)
        except DecodeError:
            return placeholder()
        end_second = min(end_second, len(vr) / fps)
        frame_offset = int(np.round(second * fps))
        total_duration = max(int((end_second - second) * fps), clip_length)
        frame_ids = get_frame_ids(
            frame_offset, min(frame_offset + total_duration, len(vr)),
            num_segments=clip_length, jitter=jitter, rng=rng,
        )
        try:
            return vr.get_batch(frame_ids, crop, out_size)
        except DecodeError:
            return vr.get_batch([0] * len(frame_ids), crop, out_size)

    # chunked layout
    chunk_start = int(second) // chunk_len * chunk_len
    chunk_end = int(end_second) // chunk_len * chunk_len
    while True:
        path = osp.join(root, f"{vid}.{ext}", f"{chunk_end}.{ext}")
        if not osp.exists(path):
            chunk_end -= chunk_len
            if chunk_end < 0:
                return placeholder()
            continue
        try:
            vr_last = open_reader(path)
        except DecodeError:
            chunk_end -= chunk_len
            if chunk_end < 0:
                return placeholder()
            continue
        end_second = min(end_second, (len(vr_last) - 1) / fps + chunk_end)
        break
    chunk_start = min(chunk_start, chunk_end)

    frame_ids = get_frame_ids(
        int(np.round(second * fps)), int(np.round(end_second * fps)),
        num_segments=clip_length, jitter=jitter, rng=rng,
    )
    pieces = []
    got = 0
    for chunk in range(chunk_start, chunk_end + chunk_len, chunk_len):
        lo, hi = int(chunk * fps), int((chunk + chunk_len) * fps)
        rel = [fid - lo for fid in frame_ids if lo <= fid < hi]
        if not rel:
            continue
        path = osp.join(root, f"{vid}.{ext}", f"{chunk}.{ext}")
        vr = None  # a stale reader of the previous chunk is never reused
        try:
            vr = open_reader(path)
            frames = vr.get_batch(rel, crop, out_size)
        except DecodeError as e:
            print(f"[sampling] decode failed for {path}: {e}; "
                  f"substituting {'frame 0' if vr is not None else 'zeros'}")
            try:
                if vr is None:
                    raise DecodeError(path)
                frames = vr.get_batch([0] * len(rel), crop, out_size)
            except Exception:
                size = out_size or (224, 224)
                frames = np.zeros((len(rel), size[1], size[0], 3), np.uint8)
        pieces.append(frames)
        got += frames.shape[0]
        if got == clip_length:
            break
    if not pieces:
        return placeholder()
    res = np.concatenate(pieces, axis=0)
    if res.shape[0] < clip_length:  # pad by repeating the last frame
        pad = np.repeat(res[-1:], clip_length - res.shape[0], axis=0)
        res = np.concatenate([res, pad], axis=0)
    return res[:clip_length]
