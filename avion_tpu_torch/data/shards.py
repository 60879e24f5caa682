"""Tar-sharded training input (``avion_tpu.data.shards``).

Per-sample trimmed clips packed into a few large uncompressed ``.tar``
shards plus a byte-offset index, so the hot path is ``seek + read`` on a
handful of big sequential files (what object-storage page caches are good
at) and no tar scan happens at train time.

Layout::

    out_dir/shard-000000.tar     # members: <key>.json + <key>.mp4
    out_dir/index.json           # per-sample {shard, mp4 offset/len,
                                 #   caption, window meta}

- ``pack_shards`` / the CLI packs an ego4d metadata pkl (or the EK100 MIR
  csv) and its chunked video root into shards (decode the window,
  re-encode one small clip per sample).
- ``ShardedVideoCaptionDataset`` has ``VideoCaptionDataset``'s item
  contract; it decodes straight from the member's bytes through
  ``memfd_create``.

Pack with ``python -m avion_tpu_torch.data.shards --root ... --metadata
... --out-dir ...``; train on it with ``data.shard_dir=<out_dir>``.
"""

from __future__ import annotations

import io
import json
import os
import os.path as osp
import sys
import tarfile
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

from avion_tpu_torch.data import metadata as md
from avion_tpu_torch.data.datasets import (AugmentSpec, _PicklableCache,
                                           caption_item, device_crop,
                                           mir_caption)
from avion_tpu_torch.data.sampling import get_frame_ids, load_clip
from avion_tpu_torch.data.video_reader import CropSpec, DecodeError, VideoReader

INDEX_NAME = "index.json"


# ---------------------------------------------------------------- pack

def _encode_clip_mp4(frames: np.ndarray, fps: float) -> bytes:
    """uint8 [T, H, W, 3] RGB -> mp4 bytes (cv2 mp4v)."""
    import cv2

    t, h, w, _ = frames.shape
    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
        path = f.name
    try:
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             float(fps), (w, h))
        if not vw.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        for i in range(t):
            vw.write(cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR))
        vw.release()
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def _read_window(root: str, vid: str, ext: str, start: float, end: float,
                 chunk_len: int, fps: float, pack_fps: float,
                 short_side: int) -> np.ndarray:
    """All frames of [start, end) at ``pack_fps``, resized so the short
    side is at most ``short_side``."""
    n = max(2, int(round((end - start) * pack_fps)))
    frames = load_clip(root, vid, ext, start, end, chunk_len=chunk_len,
                       fps=fps, clip_length=n, jitter=False)
    if short_side and min(frames.shape[1:3]) > short_side:
        import cv2

        h, w = frames.shape[1:3]
        if h <= w:
            nh, nw = short_side, max(2, round(w * short_side / h) // 2 * 2)
        else:
            nw, nh = short_side, max(2, round(h * short_side / w) // 2 * 2)
        frames = np.stack([
            cv2.resize(f, (nw, nh), interpolation=cv2.INTER_AREA)
            for f in frames])
    return frames


def pack_shards(
    dataset: str,
    root: str,
    metadata_path: str,
    out_dir: str,
    *,
    samples_per_shard: int = 512,
    chunk_len: int = 15,
    fps: float = 30.0,
    pack_fps: float = 30.0,
    short_side: int = 288,
    ext: str = "mp4",
    limit: Optional[int] = None,
) -> Dict[str, Any]:
    """Pack a metadata table + chunked root into tar shards.

    ``dataset='ego4d'`` reads the 4-tuple pkl; ``'ek100_mir'`` reads the
    EPIC retrieval csv (per-video fps probed from chunk 0, ext ``MP4``).
    Shard rows keep metadata order, so MIR extras (sentences / relevancy)
    stay row-aligned with the index.  Returns the index dict (also written
    to ``out_dir/index.json``).
    """
    if dataset == "ego4d":
        samples = md.load_ego4d(metadata_path)
    elif dataset == "ek100_mir":
        samples = md.load_ek100(root, metadata_path)
        ext = "MP4"
    else:
        raise ValueError(f"unsupported dataset {dataset!r}")
    if limit:
        samples = samples[:limit]
    os.makedirs(out_dir, exist_ok=True)

    index: List[Dict[str, Any]] = []
    shard_id, tf, members = -1, None, 0

    def open_shard():
        nonlocal shard_id, tf, members
        if tf is not None:
            tf.close()
            _index_shard(out_dir, _shard_name(shard_id), index)
        shard_id += 1
        members = 0
        tf = tarfile.open(osp.join(out_dir, _shard_name(shard_id)), "w",
                          format=tarfile.USTAR_FORMAT)

    open_shard()
    for i, s in enumerate(samples):
        src_fps = s.fps if dataset == "ek100_mir" else fps
        frames = _read_window(root, s.vid, ext, s.start, s.end,
                              chunk_len, src_fps, pack_fps, short_side)
        clip = _encode_clip_mp4(frames, pack_fps)
        key = f"{i:09d}"
        meta = {"vid": s.vid, "start": s.start, "end": s.end,
                "caption": s.caption, "fps": pack_fps}
        for name, payload in ((f"{key}.json",
                               json.dumps(meta).encode()),
                              (f"{key}.mp4", clip)):
            ti = tarfile.TarInfo(name)
            ti.size = len(payload)
            tf.addfile(ti, io.BytesIO(payload))
        index.append({"key": key, "shard": _shard_name(shard_id),
                      "caption": s.caption,
                      "start": s.start, "end": s.end, "vid": s.vid})
        members += 1
        if members >= samples_per_shard:
            open_shard()
    tf.close()
    if members == 0:  # the rollover landed exactly on the last sample
        os.unlink(osp.join(out_dir, _shard_name(shard_id)))
    else:
        _index_shard(out_dir, _shard_name(shard_id), index)

    out = {"samples": index,
           "meta": {"dataset": dataset, "pack_fps": pack_fps,
                    "short_side": short_side, "count": len(index)}}
    # atomic publish: a crash mid-write never leaves a truncated index
    tmp = osp.join(out_dir, INDEX_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, osp.join(out_dir, INDEX_NAME))
    return out


def _shard_name(i: int) -> str:
    return f"shard-{i:06d}.tar"


def _index_shard(out_dir: str, shard_name: str,
                 index: List[Dict[str, Any]]) -> None:
    """Fill the mp4 / json byte offsets of ``shard_name``'s rows from the
    finished tar (the tar reader's offsets, no header-size arithmetic)."""
    path = osp.join(out_dir, shard_name)
    if not osp.exists(path):
        return
    offsets = {}
    with tarfile.open(path, "r") as tf:
        for m in tf.getmembers():
            offsets[m.name] = (m.offset_data, m.size)
    for row in index:
        if row["shard"] == shard_name and "mp4_off" not in row:
            off, size = offsets[f"{row['key']}.mp4"]
            row["mp4_off"], row["mp4_len"] = off, size
            joff, jsize = offsets[f"{row['key']}.json"]
            row["json_off"], row["json_len"] = joff, jsize


# ---------------------------------------------------------------- read

class _InMemoryClip:
    """Bytes exposed as a decodable path: memfd on Linux (in memory, no
    disk IO), a temporary file elsewhere.  ``close()`` releases it."""

    def __init__(self, name: str, payload: bytes):
        if hasattr(os, "memfd_create"):
            self._fd = os.memfd_create(name)
            os.write(self._fd, payload)
            self.path = f"/proc/self/fd/{self._fd}"
            self._tmp = None
        else:
            self._fd = None
            f = tempfile.NamedTemporaryFile(suffix=".mp4", delete=False)
            f.write(payload)
            f.close()
            self._tmp = self.path = f.name

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
        elif self._tmp is not None:
            os.unlink(self._tmp)


class ShardedVideoCaptionDataset(_PicklableCache):
    """Map-style CLIP dataset over packed tar shards, with
    ``VideoCaptionDataset``'s item contract: ``{"video": uint8 [T, S, S,
    3], "text": int32 [77], "relevancy": f32}`` (+ ``crop``/``hflip``
    under device_rrc).  A read is one ``seek + read`` on a cached shard
    file handle, then a decode from memory."""

    def __init__(
        self,
        shard_dir: str,
        *,
        is_training: bool = True,
        clip_length: int = 4,
        threads: int = 1,
        augment: Optional[AugmentSpec] = None,
        context_length: int = 77,
        narration_selection: str = "random",
        subsample_stride: Optional[int] = None,
        decode_fast: bool = False,
        mir_metadata: Optional[str] = None,
    ):
        self.shard_dir = shard_dir
        with open(osp.join(shard_dir, INDEX_NAME)) as f:
            idx = json.load(f)
        self.samples = idx["samples"]
        # ek100_mir training: the relevancy-weighted caption swap of
        # VideoCaptionDataset (shard rows keep the csv order)
        self.sentences = self.relevancy_mat = None
        self.relevancy = 0.1
        if mir_metadata and is_training:
            (self.sentences, self.relevancy_mat,
             self.relevancy) = md.load_ek100_mir_extras(mir_metadata)
        if subsample_stride:
            self.samples = self.samples[::subsample_stride]
            if self.relevancy_mat is not None:
                self.relevancy_mat = self.relevancy_mat[::subsample_stride]
        self.meta = idx.get("meta", {})
        self.is_training = is_training
        self.clip_length = clip_length
        self.threads = threads
        self.augment = augment or AugmentSpec(
            mode="rrc" if is_training else "center")
        self.context_length = context_length
        self.narration_selection = narration_selection
        self.decode_fast = decode_fast
        self._cache: dict = {}  # shard path -> open file handle

    def __len__(self):
        return len(self.samples)

    def _shard_file(self, shard: str):
        f = self._cache.get(shard)
        if f is None or f.closed:
            f = open(osp.join(self.shard_dir, shard), "rb")
            self._cache[shard] = f
        return f

    def _read_member(self, row: Dict[str, Any]) -> bytes:
        f = self._shard_file(row["shard"])
        f.seek(row["mp4_off"])
        return f.read(row["mp4_len"])

    def _placeholder(self):
        """Zero clip for corrupt members (``load_clip``'s placeholder
        contract)."""
        size = (self.augment.decode_size
                if self.augment.mode == "device_rrc"
                else self.augment.crop_size)
        z = np.zeros((self.clip_length, size, size, 3), np.uint8)
        if self.augment.mode == "device_rrc":
            return z, np.asarray([0, 0, 1, 1], np.float32), np.bool_(False)
        return z, None, None

    def _decode(self, payload: bytes, key: str, rng):
        clip = _InMemoryClip(key, payload)
        vr = None
        try:
            try:
                vr = VideoReader(clip.path, num_threads=self.threads,
                                 fast=self.decode_fast)
            except DecodeError:
                return self._placeholder()
            n = len(vr)
            if n <= 0:
                return self._placeholder()
            ids = get_frame_ids(0, n, self.clip_length,
                                jitter=self.is_training, rng=rng)
            ids = [min(i, n - 1) for i in ids]
            if self.augment.mode == "device_rrc":
                size = (self.augment.decode_size, self.augment.decode_size)
                frames = vr.get_batch(ids, CropSpec(), size)
                return (frames,
                        *device_crop(self.augment, rng, self.is_training))
            crop = self.augment.sample(rng, vr.width, vr.height)
            size = (self.augment.crop_size, self.augment.crop_size)
            return vr.get_batch(ids, crop, size), None, None
        finally:
            if vr is not None:
                vr.close()
            clip.close()

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = (np.random.RandomState() if self.is_training
               else np.random.RandomState(i))
        row = self.samples[i]
        frames, crop_arr, hflip = self._decode(
            self._read_member(row), row["key"], rng)
        caption, relevancy = row.get("caption"), 1.0
        if self.relevancy_mat is not None:
            caption, relevancy = mir_caption(
                self.sentences, self.relevancy_mat, self.relevancy, i, rng,
                caption)
        return caption_item(frames, caption, rng, self.context_length,
                            self.narration_selection, crop_arr, hflip,
                            relevancy)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Pack chunked videos + metadata pkl into tar shards")
    p.add_argument("--dataset", default="ego4d")
    p.add_argument("--root", required=True)
    p.add_argument("--metadata", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--samples-per-shard", type=int, default=512)
    p.add_argument("--chunk-length", type=int, default=15)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--pack-fps", type=float, default=30.0)
    p.add_argument("--short-side", type=int, default=288)
    p.add_argument("--ext", default="mp4")
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    out = pack_shards(args.dataset, args.root, args.metadata, args.out_dir,
                      samples_per_shard=args.samples_per_shard,
                      chunk_len=args.chunk_length, fps=args.fps,
                      pack_fps=args.pack_fps, short_side=args.short_side,
                      ext=args.ext, limit=args.limit)
    n_shards = len({r["shard"] for r in out["samples"]})
    print(f"packed {out['meta']['count']} samples into {n_shards} shards "
          f"under {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
