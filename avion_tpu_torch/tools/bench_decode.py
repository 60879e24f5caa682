"""Input-pipeline benchmark: fused-decode throughput (frames/sec) (the
port's copy of ``avion_tpu.tools.bench_decode``).

The BASELINE's secondary metric ("input-pipeline frames/sec vs
decord"): measures the native fused decoder on H.264 chunks at the
training configuration (random-resized-crop to 224px, 4-frame clips
with reference jitter sampling), single process and with the worker
pool.

Usage::

    python -m avion_tpu_torch.tools.bench_decode [--video PATH] [--seconds 15]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def make_test_video(path: str, seconds: int = 15, fps: int = 30,
                    w: int = 456, h: int = 256):
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    rs = np.random.RandomState(0)
    base = rs.randint(0, 255, (h, w, 3), np.uint8)
    for i in range(seconds * fps):
        frame = np.roll(base, i * 3, axis=1)
        vw.write(frame)
    vw.release()
    return path


def bench_reader(path: str, *, backend: str, clips: int = 50,
                 clip_length: int = 4, crop_size: int = 224,
                 threads: int = 4, fast: bool = False):
    from avion_tpu_torch.data.sampling import get_frame_ids
    from avion_tpu_torch.data.transforms import sample_rrc
    from avion_tpu_torch.data.video_reader import VideoReader

    vr = VideoReader(path, num_threads=threads, backend=backend,
                     fast=fast)
    n = len(vr)
    rng = np.random.RandomState(0)
    # warmup
    vr.get_batch([0], None, (crop_size, crop_size))
    t0 = time.perf_counter()
    frames = 0
    for _ in range(clips):
        start = rng.randint(0, max(1, n - 60))
        ids = get_frame_ids(start, min(start + 60, n), clip_length,
                            jitter=True, rng=rng)
        crop = sample_rrc(rng, (0.5, 1.0))
        out = vr.get_batch(ids, crop, (crop_size, crop_size))
        frames += out.shape[0]
    dt = time.perf_counter() - t0
    return frames / dt


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", default="")
    p.add_argument("--seconds", type=int, default=15)
    p.add_argument("--clips", type=int, default=50)
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)

    path = args.video
    tmp = None
    if not path:
        tmp = tempfile.NamedTemporaryFile(suffix=".mp4", delete=False)
        path = make_test_video(tmp.name, args.seconds)

    out = {}
    from avion_tpu_torch.data.video_reader import native_available

    if native_available():
        out["native_fps"] = round(bench_reader(
            path, backend="native", clips=args.clips,
            threads=args.threads), 1)
        out["native_fast_fps"] = round(bench_reader(
            path, backend="native", clips=args.clips,
            threads=args.threads, fast=True), 1)
    out["cv2_fps"] = round(bench_reader(
        path, backend="cv2", clips=args.clips, threads=args.threads), 1)
    if "native_fps" in out and out["cv2_fps"]:
        out["native_speedup"] = round(out["native_fps"] / out["cv2_fps"], 2)

    # B-frame / sparse-keyframe chunk (x264-default-like GOP structure —
    # the realistic production re-encode): exercises the NONREF
    # fast-forward path, which is a no-op on the P-only fixture above.
    if native_available() and not args.video:
        from avion_tpu_torch.data.video_reader import write_test_video

        bf = tempfile.NamedTemporaryFile(suffix=".mp4", delete=False)
        write_test_video(bf.name, args.seconds * 30, w=456, h=256, fps=30,
                         gop=250, bframes=2)
        out["native_bframe_fps"] = round(bench_reader(
            bf.name, backend="native", clips=args.clips,
            threads=args.threads), 1)
        out["native_bframe_fast_fps"] = round(bench_reader(
            bf.name, backend="native", clips=args.clips,
            threads=args.threads, fast=True), 1)
        os.unlink(bf.name)
    print(json.dumps(out))
    if tmp:
        os.unlink(tmp.name)
    return out


if __name__ == "__main__":
    main()
