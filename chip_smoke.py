"""Smoke test of the PyTorch port on one CUDA card: build the kernels, hold
each against its plain version, and serve full-width CLIP ViT-B/16 over
HTTP through the port's normal entry point.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: ``avion_tpu_torch/ops/csrc/flash_fwd.cu`` with ``nvcc``;
3. kernel: the flash-attention kernel (bf16) against its plain f32
   version at the serving shapes (max abs error 3e-2, the JAX bf16
   forward tolerance, and RMS error at most 0.5% of the RMS output), with
   its time, the plain time, the time of one
   ``scaled_dot_product_attention`` call (a yardstick only; the port never
   calls it) and the least time the card could take (``bound_ms``);
4. serve: a seeded random ``CLIP_VITB16`` checkpoint in the reference
   layout, served by ``avion_tpu_torch.serve.server.main`` at 4 frames on
   an ephemeral port; every endpoint is called, the answers checked, the
   kernel's launches counted (one per attention layer of every tower
   forward), and two clips and two texts re-run on the CPU through the
   plain path (cosine >= 0.99).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import base64
import json
import math
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from avion_tpu_torch.ops import _build
from avion_tpu_torch.ops import flash_attention as fa

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12
TOL = 3e-2  # max abs error, the JAX bf16 forward tolerance
# RMS error over RMS output.  With randn q/k/v an output row averages ~S
# rows of v, so a typical output is ~sqrt(e/S): 0.03 at S=3137, as large as
# TOL.  The relative bound is what holds the visual shapes: a kernel that
# let the zero-filled keys of the ragged last tile into the softmax would
# be off by ~1.2% (S=3137) to ~3.5% (S=785) of every output.
REL_TOL = 5e-3
# (batch, seq, heads, head_dim, causal): the visual tower at 4 frames and
# at the default 16, the text tower, and the head_dim-128 geometry
KERNEL_SHAPES = [(32, 785, 12, 64, False), (32, 77, 8, 64, True),
                 (4, 3137, 12, 64, False), (32, 785, 6, 128, False)]
MODEL, FRAMES, BATCH, SIZE = "CLIP_VITB16", 4, 32, 224
LAYERS = 12  # attention layers per tower of CLIP_VITB16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(b, s, h, d, causal):
    """Least time (ms) for the function: q/k/v read once, out written once,
    against the score and PV products on bf16 tensor cores."""
    flops = 4 * b * h * s * s * d / (2 if causal else 1)
    nbytes = 4 * b * s * h * d * 2
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def phase_environment() -> str:
    log("== environment")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = card_line()
    log(card)
    log(f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    log("== build")
    t0 = time.perf_counter()
    _build.library(fa.SOURCE)
    log(f"built {fa.SOURCE} in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get(fa.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {fa.SOURCE}: {line.strip()}")


def phase_kernel() -> list:
    log(f"== kernel: flash_fwd (bf16) vs plain f32, max abs err <= {TOL}, "
        f"rms err / rms out <= {REL_TOL}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, bad = [], []
    for b, s, h, d, causal in KERNEL_SHAPES:
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        fa.reset_launches()
        out = fa.flash_attention_fused_qkv(qkv, h, s, causal=causal)
        torch.cuda.synchronize()
        if fa.launches != 1:
            raise RuntimeError(f"kernel launches {fa.launches}, expected 1")
        ref = fa.flash_attention_fused_qkv_plain(qkv.float(), h, s,
                                                 causal=causal)
        diff = out.float() - ref
        err = diff.abs().max().item()
        rel = (diff.norm() / ref.norm()).item()
        if not (err <= TOL and rel <= REL_TOL):  # NaN fails too
            bad.append(f"{(b, s, h, d, causal)}: max abs err {err}, "
                       f"rms err / rms out {rel}")
        q, k, v = qkv.view(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
        row = {
            "shape": [b, s, h, d], "causal": causal, "launches": fa.launches,
            "max_abs_err": err, "rel_rms_err": rel,
            "out_rms": ref.pow(2).mean().sqrt().item(),
            "kernel_ms": cuda_ms(lambda: fa.flash_attention_fused_qkv(
                qkv, h, s, causal=causal)),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_fused_qkv_plain(
                qkv, h, s, causal=causal), iters=5),
            "library_ms": cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)),
        }
        row["bound_ms"], row["bound_by"] = bound(b, s, h, d, causal)
        rows.append(row)
        log(json.dumps(row))
    if bad:
        raise RuntimeError("kernel disagrees with its plain version at "
                           + "; ".join(bad))
    return rows


def random_checkpoint(path: str, seed: int = 0) -> None:
    """A seeded random ``CLIP_VITB16`` state dict in the reference layout
    (what ``export_clip_to_pt`` writes), saved as ``{"state_dict": ...}``."""
    from avion_tpu_torch.models.registry import create_model

    with torch.device("meta"):
        shapes = {k: v.shape for k, v in create_model(
            MODEL, num_frames=FRAMES).state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in shapes.items():
        noise = torch.randn(shape, generator=gen)
        if k == "logit_scale":
            sd[k] = torch.tensor(math.log(1 / 0.07))
        elif ".ln_" in k:
            sd[k] = noise * 0.02 + (1.0 if k.endswith("weight") else 0.0)
        elif "embedding" in k or len(shape) == 1:
            sd[k] = noise * 0.02
        else:  # dense weights, conv1, projections: fan-in scaling
            fan_in = shape[0] if k.endswith("projection") else \
                math.prod(shape[1:])
            sd[k] = noise * fan_in ** -0.5
    torch.save({"state_dict": sd}, path)


def _post(url: str, path: str, obj: dict):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
    return body, time.perf_counter() - t0


def _get(url: str, path: str) -> dict:
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


def _frames(clips: np.ndarray) -> dict:
    return {"frames_b64": base64.b64encode(clips.tobytes()).decode(),
            "shape": list(clips.shape)}


def _unit_rows(name: str, arr, n: int, dim: int = 512) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if arr.shape != (n, dim) or not np.isfinite(arr).all():
        raise RuntimeError(f"{name}: bad embeddings {arr.shape}")
    norms = np.linalg.norm(arr, axis=-1)
    if np.abs(norms - 1).max() > 1e-3:
        raise RuntimeError(f"{name}: norms {norms}")
    return arr


def profile_request(url: str, clips: np.ndarray) -> None:
    """Device time of one /v1/embed/video request by kernel, and the share
    of the request's wall time the card was idle (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _post(url, "/v1/embed/video", _frames(clips))[1]
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if not busy:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile of one {len(clips)}-clip request: wall {wall * 1e3:.2f} ms,"
        f" device busy {busy:.3f} ms, idle share {1 - busy / (wall * 1e3):.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {ms:9.3f} ms  {ms / busy:6.1%}  {name[:100]}")


def phase_serve(tmp: str) -> int:
    """Returns the kernel launches of the served main path."""
    from avion_tpu_torch.models.pt_import import load_clip_checkpoint
    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.serve.server import main

    log(f"== serve {MODEL} at {FRAMES} frames, batch {BATCH}")
    ckpt = os.path.join(tmp, "clip_vitb16_random.pt")
    t0 = time.perf_counter()
    random_checkpoint(ckpt)
    log(f"random checkpoint written in {time.perf_counter() - t0:.1f} s")

    ready: queue.Queue = queue.Queue()
    errors: list = []

    def run():
        try:
            main([f"model.name={MODEL}", f"data.clip_length={FRAMES}",
                  f"data.val_batch_size={BATCH}", f"pretrain_model={ckpt}",
                  "--port", "0"], on_ready=ready.put)
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller
            errors.append(e)
            ready.put(None)

    th = threading.Thread(target=run, name="serve-main")
    th.start()
    server = ready.get(timeout=600)
    if server is None:
        raise RuntimeError("server failed to start") from errors[0]
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = _get(url, "/health")
        log(f"health {health}")
        if health["platform"] != "gpu":
            raise RuntimeError(f"not serving on the GPU: {health}")
        rs = np.random.RandomState(0)
        clips = rs.randint(0, 256, (16, FRAMES, SIZE, SIZE, 3), np.uint8)
        texts = ["#C C cuts an onion", "#C C opens the fridge",
                 "a person washes the dishes"]
        labels = ["cut onion", "open fridge", "wash dishes"]
        _post(url, "/v1/embed/video", _frames(clips[:2]))  # warm up
        _post(url, "/v1/embed/text", {"texts": texts[:1]})

        # the main path, with the launch count set to 0 just before
        before = _get(url, "/metrics")["encoder"]
        fa.reset_launches()
        text_emb = _post(url, "/v1/embed/text", {"texts": texts})[0]
        video_emb, lat = [], []
        for _ in range(6):
            body, dt = _post(url, "/v1/embed/video", _frames(clips))
            video_emb.append(body["embeddings"])
            lat.append(dt)
        sim = _post(url, "/v1/similarity",
                    dict(_frames(clips[:4]), texts=texts))[0]
        cls = _post(url, "/v1/classify",
                    dict(_frames(clips[:2]), labels=labels))[0]
        launches = fa.launches
        after = _get(url, "/metrics")["encoder"]
        profile_request(url, clips)
    finally:
        server.shutdown()
        th.join(timeout=120)
    if th.is_alive():
        raise RuntimeError("server thread did not stop")
    if errors:
        raise errors[0]

    calls = {k: after[k] - before[k] for k in after}
    log(f"tower forwards {calls}, kernel launches {launches}")
    if min(calls.values()) < 1 or launches != LAYERS * sum(calls.values()):
        raise RuntimeError(f"{launches} launches for {calls} tower forwards; "
                           f"expected {LAYERS} per forward")
    t_emb = _unit_rows("text", text_emb["embeddings"], len(texts))
    v_emb = [_unit_rows("video", e, len(clips)) for e in video_emb]
    if max(np.abs(e - v_emb[0]).max() for e in v_emb) > 1e-2:
        raise RuntimeError("repeated video requests disagree")
    logits = np.asarray(sim["logits"])
    if logits.shape != (4, len(texts)) or not np.isfinite(logits).all():
        raise RuntimeError(f"similarity: bad logits {logits.shape}")
    probs = np.asarray(cls["probs"])
    if probs.shape != (2, len(labels)) or np.abs(probs.sum(-1) - 1).max() > 1e-4:
        raise RuntimeError(f"classify: bad probabilities {probs}")
    lat_ms = sorted(x * 1e3 for x in lat)
    log(f"video requests of {len(clips)} clips: p50 {lat_ms[len(lat) // 2]:.1f}"
        f" ms, {len(clips) * len(lat) / sum(lat):.1f} clips/s end to end")

    log("== reference: the same weights on the CPU, plain path, f32")
    model = create_model(MODEL, num_frames=FRAMES, dtype=torch.float32)
    load_clip_checkpoint(model, ckpt)
    from avion_tpu_torch.data.tokenizer import tokenize
    from avion_tpu_torch.data.transforms import normalize_video

    with torch.inference_mode():
        ref_v = model.encode_image(normalize_video(
            torch.from_numpy(clips[:2]), dtype=torch.float32)).numpy()
        ref_t = model.encode_text(
            torch.from_numpy(tokenize(texts[:2])).long()).numpy()
    cos_v = (ref_v * v_emb[0][:2]).sum(-1)
    cos_t = (ref_t * t_emb[:2]).sum(-1)
    log(f"cosine to the CPU reference: video {cos_v}, text {cos_t}")
    if min(cos_v.min(), cos_t.min()) < 0.99:
        raise RuntimeError("served embeddings disagree with the CPU reference")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    phase_environment()
    phase_build()
    rows = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_serve(tmp)
    head = rows[0]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "avion_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "avion_tpu/ops/flash_attention.py:134",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": head["shape"],
        "shapes": rows,
    }]
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
