"""End-to-end input pipeline plus train step (``avion_tpu.tools.
bench_pipeline``): the duty cycle.

Measures the whole training path together: decode (fused crop) in worker
processes, ``data.loader.DataLoader``, ``device_prefetch`` to the card,
the CLIP train step (``train.steps.make_clip_train_step``) and reports
the card's duty cycle (model time over batch time), the starvation
detector the reference reads off its data_time / batch_time meters
(``scripts/main_lavila_pretrain.py:767-797``).

:func:`live_segment` is the measurement core (it prints to stderr only);
the CLI adds the projection to other host core counts (``--host-cores``)
from the per-core decode probe.  Decoding takes the native decoder where
it is built and loads, else cv2 (the card's machine has no FFmpeg
libraries); the JSON line names the reader that ran
(``decode_backend``).  A step window ends in a host read of the loss,
which waits for the card; the card's name and power limit go to stderr.

Usage::

    python -m avion_tpu_torch.tools.bench_pipeline [--model CLIP_VITB16]
        [--batch 64] [--steps 10] [--videos 8] [--workers N]
        [--host-cores 112] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle
import sys
import tempfile
import time

import numpy as np


def _log(*a):
    print(*a, file=sys.stderr)


def make_chunked_dataset(root: str, n_videos: int = 8, chunk_len: int = 15,
                         fps: int = 30, w: int = 456, h: int = 256,
                         n_chunks: int = 2):
    """Synthetic ego4d-style chunked videos + metadata pkl.

    Chunks are x264-default H.264 (textured content, forced B-frame
    cadence) when the native library and libx264 are available, else cv2
    mp4v."""
    from avion_tpu_torch.data.video_reader import (native_available,
                                                   write_test_video)

    rs = np.random.RandomState(0)
    samples = []
    for v in range(n_videos):
        vid = f"vid{v}"
        d = osp.join(root, f"{vid}.mp4")
        os.makedirs(d, exist_ok=True)
        for c in range(n_chunks):
            path = osp.join(d, f"{c * chunk_len}.mp4")
            if osp.exists(path):
                continue
            try:
                if not native_available():
                    raise RuntimeError("no native encoder")
                write_test_video(path, chunk_len * fps, w=w, h=h, fps=fps,
                                 gop=250, bframes=3, codec="libx264",
                                 noise=True)
            except Exception:
                import cv2

                base = cv2.GaussianBlur(
                    rs.randint(0, 255, (h, w, 3), np.uint8), (21, 21), 0)
                vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps, (w, h))
                for i in range(chunk_len * fps):
                    vw.write(np.roll(base, (c * 450 + i) * 2, axis=1))
                vw.release()
        # several samples per video, different windows
        for st in np.linspace(0.5, n_chunks * chunk_len - 3.0, 8):
            samples.append((vid, float(st), float(st + 2.0),
                            f"moves object {v}"))
    meta = osp.join(root, "meta.pkl")
    with open(meta, "wb") as f:
        pickle.dump(samples, f)
    return meta


def make_default_dataset(root=None, videos: int = 8, clip_length: int = 4,
                         crop_size: int = 224):
    """Chunked synthetic dataset + fused-decode VideoCaptionDataset."""
    from avion_tpu_torch.data.datasets import AugmentSpec, VideoCaptionDataset

    root = root or osp.join(tempfile.gettempdir(), "avion_torch_bench_pipe")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    meta = make_chunked_dataset(root, n_videos=videos)
    _log(f"[setup] dataset ready in {time.perf_counter() - t0:.1f}s")
    return VideoCaptionDataset(
        "ego4d", root, meta, is_training=True,
        clip_length=clip_length, chunk_len=15, fps=30, threads=1,
        augment=AugmentSpec(crop_size=crop_size, mode="rrc"),
    )


def projected_duty_cycle(batch: int, step_time_s: float,
                         decode_clips_per_sec_per_core: float,
                         host_cores: int) -> float:
    """With ``host_cores`` cores decoding, the host supplies ``cores x
    per-core rate`` clips/s against the step's demand of ``batch /
    step_time_s``: the duty cycle is at most their ratio."""
    demand = batch / max(step_time_s or 1e-9, 1e-9)
    supply = host_cores * decode_clips_per_sec_per_core
    return min(1.0, supply / max(demand, 1e-9))


def live_segment(model_name: str = "CLIP_VITB16", batch: int = 64,
                 steps: int = 10, workers: int | None = None,
                 clip_length: int = 4, crop_size: int = 224,
                 ds=None, root=None, videos: int = 8,
                 replay: bool = False, probe_decode: bool = True,
                 echo: int = 1, echo_also: int = 0,
                 device="cuda") -> dict:
    """One live decode-while-stepping run: worker processes decode
    concurrently with the train step on ``device``; the duty cycle is
    measured, not projected.  Returns a dict of measured fields; prints
    only to stderr.  ``replay`` also steps from a pool of pre-decoded
    batches (everything but decode), ``echo`` / ``echo_also`` step each
    decoded batch that many times (``data.echo_factor``)."""
    import itertools

    import torch

    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.core.meters import StepTimer
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.data.loader import (DataLoader, device_prefetch,
                                             echo_batches)
    from avion_tpu_torch.data.video_reader import default_backend
    from avion_tpu_torch.train.pretrain_clip import build_model_and_state
    from avion_tpu_torch.train.steps import make_clip_train_step

    device = torch.device(device)
    if workers is None:
        workers = max(1, (os.cpu_count() or 1) - 1)
    if ds is None:
        ds = make_default_dataset(root, videos, clip_length, crop_size)

    decode_cps_core = None
    if probe_decode:
        # the single-core decode rate (the host's bound), after a warm-up
        # that opens the chunks and seeks their keyframes
        for i in range(4):
            ds[i % len(ds)]
        t0 = time.perf_counter()
        n_probe = 16
        for i in range(n_probe):
            ds[i % len(ds)]
        decode_cps_core = n_probe / (time.perf_counter() - t0)
        _log(f"[probe] fused decode: {decode_cps_core:.1f} clips/s/core "
             f"({decode_cps_core * clip_length:.0f} frames/s/core)")

    cfg = TrainConfig().apply_overrides([
        f"model.name={model_name}", f"data.clip_length={clip_length}",
        f"data.crop_size={crop_size}", f"data.batch_size={batch}",
        "model.use_grad_checkpointing=true", "model.use_flash_attn=true",
        "optim.optimizer=adamw", "optim.lr=4e-5", "optim.warmup_epochs=0",
        "optim.epochs=1", "optim.grad_clip_norm=1.0"])
    model, optimizer, _ = build_model_and_state(cfg, 100, device=device)
    state = TrainState.create(model, optimizer)
    step = make_clip_train_step(model, crop_size=crop_size)

    def timed_loop(it, n_steps, state, mark_every=5):
        """The fetch -> step -> window loop shared by the live, replay and
        echoed segments: per-step data waits, one host read of the loss a
        window (which waits for the card), wall clock.  Returns (state,
        stats, wall_s, last_loss)."""
        timer = StepTimer()
        n = marked = 0
        loss = float("nan")
        t0 = time.perf_counter()
        while n < n_steps:
            t_fetch = time.perf_counter()
            batch_data = next(it)
            timer.data_time.update(time.perf_counter() - t_fetch)
            state, m = step(state, batch_data)
            n += 1
            if n % mark_every == 0 or n == n_steps:
                loss = float(m["loss"])
                timer.mark_window(n - marked)
                marked = n
        return state, timer.stats(), time.perf_counter() - t0, loss

    def loader(depth: int) -> DataLoader:
        return DataLoader(ds, batch, shuffle=True, drop_last=True,
                          num_workers=workers, prefetch_depth=depth,
                          infinite=True)

    live = loader(4)
    # close on every exit path: live_segment may be embedded in another
    # program, which must not inherit the decode workers
    try:
        it = device_prefetch(iter(live), device, depth=2)
        if echo > 1:
            # repeats reuse the batch on the card: a decode-bound host
            # steps echo x per decoded batch
            it = echo_batches(it, echo)
        for _ in range(2):  # warm up: the kernels' build, the queues
            state, m = step(state, next(it))
        float(m["loss"])
        state, stats, wall, loss = timed_loop(it, steps, state)
    finally:
        live.close()

    result = {
        "e2e_clips_per_sec": batch * steps / wall,
        "duty_cycle": stats.get("duty_cycle", 0.0),
        "data_stall_ms": stats.get("data_time", 0.0) * 1e3,
        "step_time_s": stats.get("step_time", 0.0),
        "live_batch": batch,
        "live_steps": steps,
        "host_cores": os.cpu_count(),
        "loss": loss,
        "decode_backend": default_backend(),
    }
    if echo > 1:
        result["echo_factor"] = echo
    if decode_cps_core is not None:
        result["decode_clips_per_sec_per_core"] = decode_cps_core
    _log(f"[live] {result['e2e_clips_per_sec']:.2f} clips/s e2e at duty "
         f"{result['duty_cycle']:.4f} (stall "
         f"{result['data_stall_ms']:.1f} ms/step, {workers} decode workers "
         f"on {result['host_cores']} cores, {result['decode_backend']})")

    if replay:
        # a pool of batches decoded once: the duty cycle of everything
        # but decode (host assembly, the copy, the launches), the one a
        # host with enough decode cores would reach
        pool_loader = loader(2)
        try:
            pool_it = iter(pool_loader)
            pool = [next(pool_it) for _ in range(4)]
        finally:
            pool_loader.close()
        rit = device_prefetch(itertools.cycle(pool), device, depth=2)
        state, m = step(state, next(rit))
        float(m["loss"])
        state, rstats, rwall, _ = timed_loop(rit, steps, state)
        result["replay_pre_decoded"] = {
            "clips_per_sec": batch * steps / rwall,
            "duty_cycle": rstats.get("duty_cycle", 0.0),
            "data_time_s": rstats.get("data_time", 0.0),
            "step_time_s": rstats.get("step_time", 0.0),
        }
        _log(f"[replay] pre-decoded feed: "
             f"{result['replay_pre_decoded']['clips_per_sec']:.2f} clips/s "
             f"at duty cycle {result['replay_pre_decoded']['duty_cycle']:.4f}")

    if echo_also > 1:
        # data echoing measured live: fresh decode workers, each decoded
        # batch stepped echo_also times on the card
        e_steps = steps * echo_also
        e_loader = loader(4)
        try:
            eit = echo_batches(device_prefetch(iter(e_loader), device,
                                               depth=2), echo_also)
            state, m = step(state, next(eit))
            float(m["loss"])
            state, estats, ewall, _ = timed_loop(
                eit, e_steps, state, mark_every=5 * echo_also)
        finally:
            e_loader.close()
        result["echoed"] = {
            "echo_factor": echo_also,
            "clips_per_sec": batch * e_steps / ewall,
            "duty_cycle": estats.get("duty_cycle", 0.0),
            "data_time_s": estats.get("data_time", 0.0),
            "step_time_s": estats.get("step_time", 0.0),
        }
        _log(f"[echo x{echo_also}] {result['echoed']['clips_per_sec']:.2f} "
             f"clips/s at duty cycle {result['echoed']['duty_cycle']:.4f}")
    return result


def main(argv=None) -> dict:
    from avion_tpu_torch.core.profiling import card_line
    from avion_tpu_torch.parallel.launch import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="CLIP_VITB16")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--videos", type=int, default=8)
    p.add_argument("--workers", type=int,
                   default=max(1, (os.cpu_count() or 1) - 1))
    p.add_argument("--clip-length", type=int, default=4)
    p.add_argument("--crop-size", type=int, default=224)
    p.add_argument("--host-cores", type=int, default=112,
                   help="core count for the projected duty cycle")
    p.add_argument("--root", default=None,
                   help="reuse an existing synthetic dataset dir")
    p.add_argument("--sharded", action="store_true",
                   help="bench the tar-sharded input path "
                        "(data/shards.py): the synthetic dataset is "
                        "packed once into shards under <root>/_shards "
                        "and read back through "
                        "ShardedVideoCaptionDataset")
    p.add_argument("--echo", type=int, default=1,
                   help="data echoing factor: step on each decoded "
                        "batch N times (on-device reuse; "
                        "data.echo_factor in training)")
    p.add_argument("--echo-also", type=int, default=0,
                   help="after the live run, re-run the step loop with "
                        "data echoing at this factor and report an "
                        "'echoed' sub-record")
    p.add_argument("--replay", action="store_true",
                   help="after the live run, re-run the step loop fed "
                        "from a pool of pre-decoded batches: the duty "
                        "cycle of everything except decode")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    _log(card_line(device))

    ds = None
    if args.sharded:
        from avion_tpu_torch.data.datasets import AugmentSpec
        from avion_tpu_torch.data.shards import (
            INDEX_NAME, ShardedVideoCaptionDataset, pack_shards)

        root = args.root or osp.join(tempfile.gettempdir(),
                                     "avion_torch_bench_pipe")
        os.makedirs(root, exist_ok=True)
        meta = make_chunked_dataset(root, n_videos=args.videos)
        shard_dir = osp.join(root, "_shards")
        if not osp.exists(osp.join(shard_dir, INDEX_NAME)):
            t0 = time.perf_counter()
            pack_shards("ego4d", root, meta, shard_dir, chunk_len=15,
                        fps=30, pack_fps=30, short_side=288)
            _log(f"[setup] shards packed in {time.perf_counter() - t0:.1f}s")
        ds = ShardedVideoCaptionDataset(
            shard_dir, is_training=True, clip_length=args.clip_length,
            augment=AugmentSpec(crop_size=args.crop_size, mode="rrc"),
        )

    seg = live_segment(
        model_name=args.model, batch=args.batch, steps=args.steps,
        workers=args.workers, clip_length=args.clip_length,
        crop_size=args.crop_size, ds=ds, root=args.root,
        videos=args.videos, replay=args.replay, echo=args.echo,
        echo_also=args.echo_also, device=device)

    projected = projected_duty_cycle(
        args.batch, seg.get("step_time_s"),
        seg.get("decode_clips_per_sec_per_core", 0.0), args.host_cores)
    result = {
        "metric": "pipeline_clips_per_sec_e2e",
        "input_path": "sharded" if args.sharded else "chunked",
        "value": seg["e2e_clips_per_sec"],
        "unit": "clips/s/chip",
        "duty_cycle": seg["duty_cycle"],
        "data_time_s": seg["data_stall_ms"] / 1e3,
        "step_time_s": seg["step_time_s"],
        "decode_clips_per_sec_per_core":
            seg.get("decode_clips_per_sec_per_core"),
        "host_cores": seg["host_cores"],
        "live_batch": seg.get("live_batch", args.batch),
        "projected_duty_cycle_at_cores": {str(args.host_cores): projected},
        "loss": seg["loss"],
        "decode_backend": seg["decode_backend"],
    }
    for key in ("echo_factor", "echoed", "replay_pre_decoded"):
        if key in seg:
            result[key] = seg[key]
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
