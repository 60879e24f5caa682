"""Pre-process raw videos into the chunked training layout (the port's copy
of ``avion_tpu.tools.chunk_videos``).

The reference documents this step but ships no tool for it
(``datasets/README.md:19-21``: "cut each video into 15-second-long
chunks (without overlap) and resize the smaller size to 288 pixels for
faster IO"; the NLQ tree has a 600-second variant,
``egonlq/utils/video_chunk.py``).  This CLI produces the exact layout
``avion_tpu_torch.data.sampling.video_loader`` consumes::

    out_dir/<video_name>.<ext>/<chunk_start_sec>.<ext>   # 0.mp4, 15.mp4, ...

Backends:

- ``ffmpeg`` (preferred when the CLI is on PATH): one invocation per
  video — scale filter on the short side + ``-f segment``, then the
  sequentially numbered segments are renamed to start-second names.
- ``cv2`` fallback (always available in this image): decode, resize,
  re-encode chunk files with ``mp4v``.

A process pool fans out over videos (the reference NLQ chunker uses
``multiprocessing.Pool`` the same way).

Usage::

    python -m avion_tpu_torch.tools.chunk_videos \
        --input-dir /data/raw --output-dir /data/video_288px_15sec \
        --chunk-length 15 --short-side 288 --workers 8
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import shutil
import subprocess
import sys
from multiprocessing import Pool
from typing import List, Optional, Tuple


def scaled_size(w: int, h: int, short_side: int) -> Tuple[int, int]:
    """Target (w, h) with the smaller side scaled to ``short_side``
    (no-op if already smaller), rounded to even for encoder safety."""
    if short_side <= 0 or min(w, h) <= short_side:
        nw, nh = w, h
    elif w <= h:
        nw, nh = short_side, round(h * short_side / w)
    else:
        nw, nh = round(w * short_side / h), short_side
    return max(2, nw // 2 * 2), max(2, nh // 2 * 2)


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _chunk_ffmpeg(in_path: str, video_out_dir: str, chunk_len: int,
                  short_side: int, ext: str) -> List[str]:
    tmp_pattern = osp.join(video_out_dir, f"_seg_%d.{ext}")
    vf = (f"scale='if(lte(iw,ih),min(iw,{short_side}),-2)'"
          f":'if(lte(iw,ih),-2,min(ih,{short_side}))'") if short_side > 0 \
        else "null"
    cmd = ["ffmpeg", "-hide_banner", "-loglevel", "error", "-y",
           "-i", in_path, "-vf", vf, "-an",
           "-f", "segment", "-segment_time", str(chunk_len),
           "-reset_timestamps", "1",
           "-force_key_frames", f"expr:gte(t,n_forced*{chunk_len})",
           tmp_pattern]
    subprocess.run(cmd, check=True)
    outs = []
    for seg in sorted(glob.glob(osp.join(video_out_dir, f"_seg_*.{ext}")),
                      key=lambda p: int(osp.basename(p)[5:].split(".")[0])):
        i = int(osp.basename(seg)[5:].split(".")[0])
        dst = osp.join(video_out_dir, f"{i * chunk_len}.{ext}")
        os.replace(seg, dst)
        outs.append(dst)
    return outs


def _chunk_cv2(in_path: str, video_out_dir: str, chunk_len: int,
               short_side: int, ext: str) -> List[str]:
    import cv2

    cap = cv2.VideoCapture(in_path)
    if not cap.isOpened():
        raise RuntimeError(f"cv2 cannot open {in_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    nw, nh = scaled_size(w, h, short_side)
    frames_per_chunk = max(1, round(chunk_len * fps))
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    outs, writer, n = [], None, 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if (nw, nh) != (w, h):
                frame = cv2.resize(frame, (nw, nh),
                                   interpolation=cv2.INTER_AREA)
            if n % frames_per_chunk == 0:
                if writer is not None:
                    writer.release()
                start = (n // frames_per_chunk) * chunk_len
                path = osp.join(video_out_dir, f"{start}.{ext}")
                writer = cv2.VideoWriter(path, fourcc, fps, (nw, nh))
                outs.append(path)
            writer.write(frame)
            n += 1
    finally:
        if writer is not None:
            writer.release()
        cap.release()
    return outs


def chunk_video(in_path: str, out_dir: str, chunk_len: int = 15,
                short_side: int = 288, ext: str = "mp4",
                backend: Optional[str] = None) -> List[str]:
    """Chunk one video; returns the chunk paths written.  The output
    directory is ``out_dir/<basename(in_path)>/`` so the source's
    ``.mp4`` suffix stays in the directory name (the layout the loader
    and the reference's Ego4D tree both use)."""
    video_out_dir = osp.join(out_dir, osp.basename(in_path))
    os.makedirs(video_out_dir, exist_ok=True)
    if backend is None:
        backend = "ffmpeg" if have_ffmpeg() else "cv2"
    if backend == "ffmpeg":
        return _chunk_ffmpeg(in_path, video_out_dir, chunk_len, short_side,
                             ext)
    if backend == "cv2":
        return _chunk_cv2(in_path, video_out_dir, chunk_len, short_side, ext)
    raise ValueError(f"unknown backend {backend!r}")


def _one(job):
    in_path, out_dir, chunk_len, short_side, ext, backend = job
    try:
        outs = chunk_video(in_path, out_dir, chunk_len, short_side, ext,
                           backend)
        return (in_path, len(outs), None)
    except Exception as e:  # keep the pool alive past one bad file
        return (in_path, 0, str(e))


def chunk_dataset(input_dir: str, output_dir: str, chunk_len: int = 15,
                  short_side: int = 288, ext: str = "mp4",
                  workers: int = 1, backend: Optional[str] = None,
                  patterns=("*.mp4", "*.MP4", "*.mkv", "*.avi",
                            "*.webm")) -> List[Tuple[str, int, Optional[str]]]:
    videos = sorted(p for pat in patterns
                    for p in glob.glob(osp.join(input_dir, "**", pat),
                                       recursive=True))
    jobs = [(v, output_dir, chunk_len, short_side, ext, backend)
            for v in videos]
    if workers <= 1:
        return [_one(j) for j in jobs]
    with Pool(workers) as pool:
        return pool.map(_one, jobs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--chunk-length", type=int, default=15)
    p.add_argument("--short-side", type=int, default=288,
                   help="scale the smaller side to this many pixels "
                        "(0 = keep resolution)")
    p.add_argument("--ext", default="mp4")
    p.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    p.add_argument("--backend", choices=["ffmpeg", "cv2"], default=None)
    args = p.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    results = chunk_dataset(args.input_dir, args.output_dir,
                            args.chunk_length, args.short_side, args.ext,
                            args.workers, args.backend)
    failed = [(v, err) for v, _, err in results if err]
    ok = len(results) - len(failed)
    total_chunks = sum(n for _, n, _ in results)
    print(f"chunked {ok}/{len(results)} videos into {total_chunks} chunks "
          f"under {args.output_dir}")
    for v, err in failed:
        print(f"FAILED {v}: {err}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
