"""Smoke test of the PyTorch port on one CUDA card: build the kernels, hold
each against its plain version, serve full-width CLIP ViT-B/16 over HTTP
through the port's normal entry point, train it for a few steps on seeded
batches, then through the training entry on decoded video, and evaluate it
zero-shot on the five suites.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: ``avion_tpu_torch/ops/csrc/flash_{fwd,bwd}.cu``, one ``nvcc``
   each, started together; every instance of the forward's kernel (8) and
   of the backward's two kernels (12) must report 0 spill bytes and no
   serialized wgmma (ptxas) and hold ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   loads) in its SASS (``cuobjdump -sass``), the combined instance
   ``UBLKRED`` (dq by bulk reduce-add) and no per-element f32 atomic;
3. kernel: every flash-attention kernel (bf16) against its plain f32
   version: the forward (inference and with lse) at KERNEL_SHAPES (max abs
   error 3e-2, the JAX bf16 forward tolerance, RMS error at most 0.5% of
   the RMS output, lse within LSE_TOL), the backward's dq, dk and dv at
   BWD_SHAPES (3e-2 and 1.5%), each with its time through the wrapper
   (``kernel_ms``), the plain time, the time of
   ``scaled_dot_product_attention`` (its backward for the backward; a
   yardstick only, the port never calls it), the least time the card could
   take (``bound_ms``), its TFLOP/s and its device time kernel by kernel
   (torch.profiler; the forward's sum is ``device_ms``, the backward's
   ``delta_kernel`` alone ``delta_ms``);
4. serve: a seeded random ``CLIP_VITB16`` checkpoint in the reference
   layout, served by ``avion_tpu_torch.serve.server.main`` at 4 frames on
   an ephemeral port; every endpoint is called, the answers checked, the
   kernel's launches counted (one per attention layer of every tower
   forward), five requests profiled one by one (device time by kind), and
   two clips and two texts re-run on the CPU through the plain path
   (cosine >= 0.99);
5. train: the recipe of ``scripts/examples/pretrain_vitb_ego4d.sh`` at
   batch 256 and 4 frames, built through ``TrainConfig``,
   ``build_model_and_state``, ``make_clip_train_step`` and ``setup_run``;
   ``train_one_epoch`` over 8 seeded batches (3 distinct) with finite
   losses and 24 forward-with-lse and 24 combined-backward launches per
   step; step time, clips/s, peak memory, a profiled step, the share of
   989 TFLOP/s; the forward counts of the ``full`` and ``save_attn_k10``
   policies; one batch-4 step against the CPU in f32 (loss within 2%,
   gradient cosine >= 0.99); save and an exact resume;
6. train at the config's default 16 frames (3137 tokens): 2 steps at
   batch 8, whose visual backward takes the split dq / dkv kernels;
7. data: cv2's video I/O, then a seeded synthetic Ego4D layout (15 s mp4v
   chunks at 512x288, 30 fps, 2048 narration rows) that
   ``avion_tpu_torch.train.pretrain_clip.main`` decodes in its
   ``DataLoader`` workers and trains on at batch 256: 8 steps with host
   crop (run A; per-step time and data wait from ``log.jsonl``, the idle
   share of the last two steps with their batch waits, the gap to phase
   5), 4
   steps with device crop (run B), 24 + 24 launches a step and finite
   losses in both; ``crop_resize_flip_normalize`` on the card against the
   CPU in f32 on one decoded batch (max abs error 1e-3); and a second
   ``main`` on run A's output that restores and trains no step;
8. eval: seeded synthetic layouts of the five zero-shot suites (EK100
   MIR with 512 clips, EK100 CLS, EGTEA, Charades-Ego, EgoMCQ; mp4v at
   512x288, 30 fps); (a) ``pretrain_clip.main`` with ``eval_freq=1`` and
   the MIR suite, two one-step epochs on the data phase's layout: metrics
   before training and after each epoch, ``is_best`` on the MIR mAP, the
   training model bit-equal across each eval pass; (b)
   ``avion_tpu_torch.eval.validate.main``, strict, at val batch 128 on the
   serve phase's checkpoint: every suite's wall time, clips/s, data-wait
   share and metrics; (c) its ``flash_fwd`` launches equal to 12 per tower
   forward; (d) ``tools.embed_videos`` on 8 clips and 8 sentences against
   the CPU plain path in f32 (cosine >= 0.99); (e) the idle share of one
   profiled MIR sweep and its device time by kind; then the inference
   forward against its plain f32 version at every shape (a) and (b) gave
   it (batch 128 and the ragged last chunks; phase 3's tolerances).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import base64
import csv
import json
import math
import os
import pickle
import queue
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

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
# the backward at the same shapes (route by the dispatch rule: combined up
# to S = 1024, split at 3137), and the main shape once more with the split
# kernels forced
BWD_SHAPES = [(32, 785, 12, 64, False, None), (32, 77, 8, 64, True, None),
              (4, 3137, 12, 64, False, None), (32, 785, 6, 128, False, None),
              (32, 785, 12, 64, False, False)]
# lse (log2 units) against the plain f32 forward: the kernel rounds the
# scaled q to bf16, a score error of ~1.6e-3 RMS; a causal row with one key
# carries one score's whole error, up to ~1e-2 (PERF.md)
LSE_TOL = 3e-2
# dq, dk, dv: RMS error over RMS reference.  A backward without the delta
# term is off by ~5% in dq and dk (PERF.md)
BWD_REL_TOL = 1.5e-2
MODEL, FRAMES, BATCH, SIZE = "CLIP_VITB16", 4, 32, 224
# the recipe of scripts/examples/pretrain_vitb_ego4d.sh at one card's share
# of its global batch 2048 over the reference's 8 cards; with 8 steps per
# epoch its one warmup epoch spans the whole run
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SEEDS = 256, 8, (0, 1, 2)
TRAIN_RECIPE = [f"model.name={MODEL}", f"data.clip_length={FRAMES}",
                f"data.batch_size={TRAIN_BATCH}", f"data.crop_size={SIZE}",
                "model.use_grad_checkpointing=true", "optim.optimizer=adamw",
                "optim.lr=4e-5", "optim.wd=0.05", "optim.betas=0.9,0.999",
                "optim.warmup_epochs=1", "optim.epochs=5",
                "optim.grad_clip_norm=1.0", "print_freq=1"]
POLICY_BATCH, REF_BATCH = 8, 4
# the config's default clip length (3137 tokens), where the backward splits
LONG_FRAMES, LONG_BATCH, LONG_STEPS = 16, 8, 2
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


def attn_flops(b, s, h, d, causal, products):
    """``products`` S x S x D products, 2 flops a multiply-add, halved when
    causal."""
    return 2 * products * b * h * s * s * d / (2 if causal else 1)


def bound(b, s, h, d, causal, products=2, tensors=4, rows=0):
    """Least time (ms): ``products`` S x S x D bf16 products (2 flops per
    multiply-add, halved when causal) against ``tensors`` [B, S, H*D] bf16
    tensors and ``rows`` [B, H, S] f32 rows, each read or written once."""
    flops = attn_flops(b, s, h, d, causal, products)
    nbytes = tensors * b * s * h * d * 2 + rows * b * h * s * 4
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
    """Both kernel sources, one nvcc each, started together; then the
    backward's resources (ptxas) and instructions (SASS)."""
    log("== build")
    t0 = time.perf_counter()
    sources = (fa.SOURCE, fa.BWD_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.library, sources))
    log(f"built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s")
    bad = [f for source, instances in ((fa.SOURCE, 8), (fa.BWD_SOURCE, 12))
           for f in check_build(source, instances)]
    if bad:
        raise RuntimeError(f"build check failed: {bad}")


# flash_fwd_kernel<D, causal, lse>, bwd_kv_kernel<D, causal, dq> and
# bwd_dq_kernel<D, causal>, mangled
INSTANCE = re.compile(r"(flash_fwd_kernel|bwd_kv_kernel|bwd_dq_kernel)"
                      r"ILi(\d+)ELb([01])E(?:Lb([01])E)?")
# a per-element f32 atomic on global memory (the bulk reduce is UBLKRED)
F32_ATOMIC = re.compile(r"\b(?:RED|ATOMG?)\.\S*F32")


def _instance(mangled: str):
    """(label, whether it is a combined-backward instance) or None."""
    m = INSTANCE.search(mangled)
    if m is None:
        return None
    kind, d, causal, flag = m.groups()
    if kind == "bwd_dq_kernel":
        return f"bwd_dq_kernel<{d}, causal={causal}>", False
    if kind == "flash_fwd_kernel":
        return f"flash_fwd_kernel<{d}, causal={causal}, lse={flag}>", False
    return f"bwd_kv_kernel<{d}, causal={causal}, dq={flag}>", flag == "1"


# ptxas: "(C7520) Potential Performance Loss: wgmma.mma_async instructions
# are serialized due to ... in the function '<mangled>'"
SERIALIZED = re.compile(
    r"wgmma\.mma_async instructions are serialized.*?function '([^']+)'")


def serialized_instances(ptxas: str) -> set:
    """Labels of the instances whose wgmma ptxas serialized."""
    return {_instance(m)[0] for m in SERIALIZED.findall(ptxas)
            if _instance(m)}


def check_build(source: str, instances: int) -> list:
    """Every kernel instance of ``source``'s library: registers and spills
    from ptxas (0 spill bytes, no wgmma serialized), and in its SASS wgmma
    (HGMMA) and TMA loads (UTMALDG); a combined-backward instance adds dq
    by bulk reduce (UBLKRED) with no per-element f32 atomics.  Returns the
    failing instances."""
    if source not in _build.build_logs:  # loaded from an earlier build
        _build._compile(source, _build._lib_path(source))
    ptxas = _build.build_logs[source]
    stats = {}
    for block in ptxas.split("Compiling entry function '")[1:]:
        name = _instance(block.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        if name and regs and spill:
            stats[name[0]] = (int(regs.group(1)), int(spill.group(1))
                              + int(spill.group(2)))
    serialized = serialized_instances(ptxas)
    lib = _build._lib_path(source)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    bad, seen = [], 0
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = _instance(func.split("\n", 1)[0])
        if name is None:
            continue
        seen += 1
        label, combined = name
        counts = {op: len(re.findall(rf"\b{op}\b", func))
                  for op in ("HGMMA", "UTMALDG", "UBLKRED")}
        counts["f32 RED/ATOM"] = len(F32_ATOMIC.findall(func))
        regs, spills = stats.get(label, (None, None))
        log(f"  {label}: {regs} registers at launch (setmaxnreg: producer "
            f"24, consumers 232), {spills} spill bytes, wgmma serialized "
            f"{label in serialized}; SASS {counts}")
        if (not (counts["HGMMA"] and counts["UTMALDG"]) or spills != 0
                or label in serialized):
            bad.append(label)
        if combined and (not counts["UBLKRED"] or counts["f32 RED/ATOM"]):
            bad.append(label + " (dq)")
    if seen != instances:
        bad.append(f"{source}: {seen} of {instances} instances seen")
    return bad


def _errors(got: torch.Tensor, ref: torch.Tensor):
    diff = got.float() - ref
    return diff.abs().max().item(), (diff.norm() / ref.norm()).item()


def _sdpa_inputs(qkv, b, s, h, d):
    q, k, v = qkv.view(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
    return q, k, v


def phase_kernel() -> dict:
    """Every kernel against its plain f32 version; returns rows by kernel."""
    log(f"== kernel: each kernel (bf16) against its plain f32 version; "
        f"out: max abs err <= {TOL}, rms err / rms out <= {REL_TOL}; lse: "
        f"max abs err <= {LSE_TOL} (log2 units); dq, dk, dv: max abs err <= "
        f"{TOL}, rms err / rms ref <= {BWD_REL_TOL}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {name: [] for name in fa.KERNELS}
    bad = []

    def check(name, shape, **errs):
        for key, (err, limit) in errs.items():
            if not err <= limit:  # NaN fails too
                bad.append(f"{name} {shape}: {key} {err} > {limit}")

    for b, s, h, d, causal in KERNEL_SHAPES:
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        scale = d ** -0.5
        shape = [b, s, h, d]
        flops = attn_flops(b, s, h, d, causal, 2)
        q, k, v = _sdpa_inputs(qkv, b, s, h, d)
        sdpa_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
        ref, lse_ref = fa.flash_fwd_lse_plain(qkv.float(), h, s, causal,
                                              scale)
        # inference forward
        fa.reset_launches()
        out = fa.flash_attention_fused_qkv(qkv, h, s, causal=causal)
        torch.cuda.synchronize()
        if dict(fa.launches) != {"flash_fwd": 1}:
            raise RuntimeError(f"flash_fwd launches {dict(fa.launches)}")
        err, rel = _errors(out, ref)
        check("flash_fwd", shape, max_abs_err=(err, TOL),
              rel_rms_err=(rel, REL_TOL))
        row = {"shape": shape, "causal": causal, "max_abs_err": err,
               "rel_rms_err": rel, "out_rms": ref.pow(2).mean().sqrt().item(),
               **_forward_times(lambda: fa.flash_attention_fused_qkv(
                   qkv, h, s, causal=causal), flops),
               "plain_ms": cuda_ms(lambda: fa.flash_attention_fused_qkv_plain(
                   qkv, h, s, causal=causal), iters=5),
               "library_ms": sdpa_ms}
        row["bound_ms"], row["bound_by"] = bound(b, s, h, d, causal)
        rows["flash_fwd"].append(row)
        log("flash_fwd " + json.dumps(row))
        # training forward, with lse
        fa.reset_launches()
        out, lse = fa.flash_fwd_lse(qkv, h, s, causal, scale)
        torch.cuda.synchronize()
        if dict(fa.launches) != {"flash_fwd_lse": 1}:
            raise RuntimeError(f"flash_fwd_lse launches {dict(fa.launches)}")
        err, rel = _errors(out, ref)
        lse_err = (lse - lse_ref).abs().max().item()
        check("flash_fwd_lse", shape, max_abs_err=(err, TOL),
              rel_rms_err=(rel, REL_TOL), lse_max_abs_err=(lse_err, LSE_TOL))
        row = {"shape": shape, "causal": causal, "max_abs_err": err,
               "rel_rms_err": rel, "lse_max_abs_err": lse_err,
               **_forward_times(lambda: fa.flash_fwd_lse(
                   qkv, h, s, causal, scale), flops),
               "plain_ms": cuda_ms(lambda: fa.flash_fwd_lse_plain(
                   qkv, h, s, causal, scale), iters=5),
               "library_ms": sdpa_ms}
        row["bound_ms"], row["bound_by"] = bound(b, s, h, d, causal, rows=1)
        rows["flash_fwd_lse"].append(row)
        log("flash_fwd_lse " + json.dumps(row))

    for b, s, h, d, causal, combined in BWD_SHAPES:
        fa._COMBINED_BWD = combined
        try:
            _check_backward(gen, rows, check, b, s, h, d, causal)
        finally:
            fa._COMBINED_BWD = None
    if bad:
        raise RuntimeError("kernels disagree with their plain versions: "
                           + "; ".join(bad))
    return rows


def _forward_times(fn, flops: float) -> dict:
    """A forward's time through the wrapper (CUDA events), its device time
    (torch.profiler: the host's checks, allocations, tensor map and launch
    are not in it) and the TFLOP/s of each."""
    kernel_ms = cuda_ms(fn)
    device_ms = sum(_device_ms_by_kernel(fn).values())
    return {"kernel_ms": kernel_ms, "device_ms": device_ms,
            "tflops": flops / kernel_ms / 1e9,
            "device_tflops": flops / device_ms / 1e9 if device_ms else None}


def _check_backward(gen, rows, check, b, s, h, d, causal):
    """The backward's route at this shape against the plain f32 backward
    of the plain f32 forward, with a seeded randn output gradient."""
    w, scale = h * d, d ** -0.5
    shape = [b, s, h, d]
    qkv = torch.randn(b, s, 3 * w, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    do = torch.randn(b, s, w, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    out, lse = fa.flash_fwd_lse(qkv, h, s, causal, scale)
    route = "combined" if fa.use_combined_bwd(s) else "split"
    names = (["flash_bwd_combined"] if route == "combined"
             else ["flash_bwd_dq", "flash_bwd_dkv"])
    fa.reset_launches()
    got = fa.flash_bwd(do, qkv, out, lse, h, s, causal, scale)
    torch.cuda.synchronize()
    if dict(fa.launches) != {n: 1 for n in names}:
        raise RuntimeError(f"{route} backward launches {dict(fa.launches)}")
    out_p, lse_p = fa.flash_fwd_lse_plain(qkv.float(), h, s, causal, scale)
    ref = fa.flash_bwd_plain(do.float(), qkv.float(), out_p, lse_p, h, s,
                             causal, scale)
    errs = {}
    for i, sec in enumerate(("dq", "dk", "dv")):
        err, rel = _errors(got[..., i * w:(i + 1) * w],
                           ref[..., i * w:(i + 1) * w])
        errs[sec] = {"max_abs_err": err, "rel_rms_err": rel}
        check(f"{route} backward", shape, **{
            f"{sec}_max_abs_err": (err, TOL),
            f"{sec}_rel_rms_err": (rel, BWD_REL_TOL)})
    del ref, out_p, lse_p
    # run to run: the combined route sums dq's shares by bulk reduce-add,
    # in an order that varies
    spread = (fa.flash_bwd(do, qkv, out, lse, h, s, causal, scale).float()
              - got.float()).abs()
    q, k, v = (t.detach().requires_grad_() for t in
               _sdpa_inputs(qkv, b, s, h, d))
    do_h = do.view(b, s, h, d).transpose(1, 2)

    def sdpa_fwd_bwd():
        o = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal)
        torch.autograd.grad(o, (q, k, v), do_h)

    with torch.no_grad():
        sdpa_fwd = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
    row = {"shape": shape, "causal": causal, "route": route, **errs,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "dq_run_to_run_max_abs": spread[..., :w].max().item(),
           "dq_run_to_run_share_differing":
               (spread[..., :w] > 0).float().mean().item(),
           "dkv_run_to_run_max_abs": spread[..., w:].max().item(),
           "kernel_ms": cuda_ms(lambda: fa.flash_bwd(
               do, qkv, out, lse, h, s, causal, scale)),
           "plain_ms": cuda_ms(lambda: fa.flash_bwd_plain(
               do, qkv, out, lse, h, s, causal, scale), iters=3),
           # SDPA's backward alone: its forward + backward less its forward
           "library_ms": cuda_ms(sdpa_fwd_bwd) - sdpa_fwd,
           "device_ms_by_kernel": _device_ms_by_kernel(
               lambda: fa.flash_bwd(do, qkv, out, lse, h, s, causal, scale))}
    # rowsum(dO * O) for the combined and dkv kernels (the dq kernel makes
    # its own rows' inside)
    row["delta_ms"] = sum(ms for name, ms in row["device_ms_by_kernel"].items()
                          if "delta_kernel" in name)
    if route == "combined":
        row["bound_ms"], row["bound_by"] = bound(
            b, s, h, d, causal, products=5, tensors=8, rows=2)
        row["tflops"] = attn_flops(b, s, h, d, causal, 5) / row["kernel_ms"] / 1e9
        rows["flash_bwd_combined"].append(row)
        log("flash_bwd_combined " + json.dumps(row))
        return
    # the split route: 7 products; each split kernel alone: q, k, v, do
    # (and out) read, its sections written, lse (and delta) read
    row["split_route_tflops"] = (attn_flops(b, s, h, d, causal, 7)
                                 / row["kernel_ms"] / 1e9)
    for name, part, products, tensors, nrows in (
            ("flash_bwd_dq", "dq", 3, 6, 1), ("flash_bwd_dkv", "dkv", 4, 6, 2)):
        r = dict(row, split_route_ms=row["kernel_ms"],
                 kernel_ms=cuda_ms(lambda: fa._bwd_cuda(
                     do, qkv, out, lse, h, s, causal, scale, route=part)))
        r["bound_ms"], r["bound_by"] = bound(b, s, h, d, causal, products,
                                             tensors, nrows)
        r["tflops"] = (attn_flops(b, s, h, d, causal, products)
                       / r["kernel_ms"] / 1e9)
        rows[name].append(r)
        log(f"{name} " + json.dumps(r))


def _device_ms_by_kernel(fn, calls: int = 3) -> dict:
    """Device time of one call of ``fn`` by kernel name (torch.profiler),
    after a warm-up call: each name's time summed over its launches within
    a call, then the median over ``calls`` calls, each profiled alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + \
                    e.time_range.elapsed_us() / 1e3
        per_call.append(by_name)
    names = {name for by_name in per_call for name in by_name}
    return {name: float(np.median([c.get(name, 0.0) for c in per_call]))
            for name in names}


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


def profile_request(url: str, clips: np.ndarray, requests: int = 5) -> None:
    """Wall time, device time and the card's idle share of ``requests``
    /v1/embed/video requests, each profiled alone (torch.profiler), and
    the median request's device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for _ in range(requests):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = _post(url, "/v1/embed/video", _frames(clips))[1] * 1e3
            torch.cuda.synchronize()
        by_name = _device_ms_by_name(prof)
        runs.append((sum(by_name.values()), wall, by_name))
    if not runs[0][0]:
        log("profile: the profiler saw no device time (not measured)")
        return
    for busy, wall, _ in runs:
        log(f"profile of one {len(clips)}-clip request: wall {wall:.2f} ms, "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.4f}")
    busy, wall, by_name = sorted(runs, key=lambda r: r[0])[requests // 2]
    log(f"median device busy {busy:.3f} ms of {requests} requests; by kernel:")
    log_device_time(by_name, top=8)


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
        launches = fa.launches["flash_fwd"]
        if set(fa.launches) != {"flash_fwd"}:
            raise RuntimeError(f"serving launched {dict(fa.launches)}")
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


def _train_config(out_dir: str, *overrides: str):
    from avion_tpu_torch.core.config import TrainConfig

    return TrainConfig().apply_overrides(
        [*TRAIN_RECIPE, f"output_dir={out_dir}", *overrides])


def _train_batches(n: int, batch: int, frames: int) -> list:
    """Seeded batches in the VideoCaptionDataset collate contract: crop-size
    uint8 clips and token ids with an end-of-text token."""
    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        text = rng.integers(1, 49405, (batch, 77), dtype=np.int32)
        text[:, 0] = 49406
        text[np.arange(batch), rng.integers(5, 77, batch)] = 49407
        out.append({"video": rng.integers(0, 256, (batch, frames, SIZE, SIZE,
                                                   3), dtype=np.uint8),
                    "text": text})
    return out


def _to_device(batch: dict) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _model_flops(model, batch: int) -> float:
    """6 x parameters x tokens for each tower (the token-embedding table is
    a lookup and counts no flops) plus 12 B H S^2 D per attention layer
    (its forward's two products and the backward's four)."""
    v, t = model.visual, model.textual
    s_v = v.positional_embedding.shape[0] - 1
    s_v = s_v * FRAMES + 1
    s_t = t.positional_embedding.shape[0]
    p_v = sum(p.numel() for p in v.parameters()) + model.image_projection.numel()
    p_t = (sum(p.numel() for n, p in t.named_parameters()
               if not n.startswith("token_embedding"))
           + model.text_projection.numel())
    flops = 6 * (p_v * batch * s_v + p_t * batch * s_t)
    for tower, s in ((v, s_v), (t, s_t)):
        for blk in tower.transformer.resblocks:
            width = blk.attn.Wqkv.in_features
            flops += 12 * batch * s * s * width
    return flops


# device kernels by kind, first match wins
KERNEL_GROUPS = (
    ("flash attention (this repo)", ("flash_fwd_kernel", "bwd_kv_kernel",
                                     "bwd_dq_kernel", "dq_convert_kernel",
                                     "delta_kernel")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("LayerNorm", ("layer_norm",)),
    ("optimizer (foreach / multi-tensor)", ("multi_tensor", "foreach")),
    ("host-device copies", ("Memcpy HtoD", "Memcpy DtoH")),
    ("copies and casts", ("copy", "Memcpy", "Memset")),
)


def _device_ms_by_name(prof) -> dict:
    """A profile's device time (ms) by kernel or copy name."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    return by_name


def log_device_time(by_name: dict, top: int = 15) -> None:
    """Logs device time by KERNEL_GROUPS, then the ``top`` names."""
    total = sum(by_name.values())
    groups: dict = {}
    for name, ms in by_name.items():
        group = next((g for g, keys in KERNEL_GROUPS if any(
            k in name for k in keys)), "other elementwise and reductions")
        groups[group] = groups.get(group, 0.0) + ms
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:9.3f} ms  {ms / total:6.1%}  [{group}]")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {ms:9.3f} ms  {ms / total:6.1%}  {name[:100]}")


def profile_step(run, batch: dict) -> None:
    """Device busy time and idle share of one train step, by kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.state, _ = run.step(run.state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = _device_ms_by_name(prof)
    busy = sum(by_name.values())
    if not busy:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile of one train step: wall {wall:.2f} ms, device busy "
        f"{busy:.3f} ms, idle share {1 - busy / wall:.4f}")
    log_device_time(by_name)


def _policy_forwards(tmp: str, policy: str, batch: dict) -> int:
    """Forward-with-lse launches of one train step under ``policy``."""
    from avion_tpu_torch.train.loop import setup_run
    from avion_tpu_torch.train.pretrain_clip import build_model_and_state
    from avion_tpu_torch.train.steps import make_clip_train_step

    cfg = _train_config(os.path.join(tmp, policy),
                        f"model.remat_policy={policy}",
                        f"data.batch_size={POLICY_BATCH}")
    model, opt, _ = build_model_and_state(cfg, TRAIN_STEPS)
    run = setup_run(cfg, model, opt, make_clip_train_step(model))
    fa.reset_launches()
    run.state, metrics = run.step(run.state, batch)
    torch.cuda.synchronize()
    if metrics["step_ok"] != 1.0:
        raise RuntimeError(f"{policy}: step not applied")
    return fa.launches["flash_fwd_lse"]


def _reference_grads(model_gpu, cfg, batch: dict) -> None:
    """Loss and gradient of one batch on the card (bf16 compute, kernels)
    and on the CPU through the plain path in f32, from the same weights."""
    from avion_tpu_torch.losses.losses import clip_loss
    from avion_tpu_torch.train.pretrain_clip import build_model
    from avion_tpu_torch.train.steps import prep_video

    cpu = build_model(cfg, torch.float32).to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         model_gpu.state_dict().items()})
    results = []
    card = next(model_gpu.parameters()).device
    for model, device in ((model_gpu, card), (cpu, "cpu")):
        model.zero_grad(set_to_none=True)
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        out = model(prep_video(b["video"], dtype=model.dtype),
                    b["text"].long(), deterministic=False)
        loss = clip_loss(out["image_embed"], out["text_embed"],
                         out["logit_scale"])["loss"]
        loss.backward()
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters() if p.grad is not None}
        results.append((loss.item(), grads))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = results
    def dots(a, b):  # f64: f32 sums over 1.5e8 terms drift past 1e-2
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        return torch.stack([a @ b, a @ a, b @ b])

    names = sorted(g_cpu)
    per_dots = {n: dots(g_gpu[n], g_cpu[n]) for n in names}
    ab, aa, bb = sum(per_dots.values()).tolist()
    cos = ab / math.sqrt(aa * bb)
    per = {n: (d[0] / (d[1] * d[2]).sqrt()).item()
           for n, d in per_dots.items()}
    worst = min(per, key=per.get)
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    log(f"reference step at batch {REF_BATCH}: loss card {l_gpu:.6f}, CPU f32 "
        f"{l_cpu:.6f}, relative difference {rel:.3e} (bound 2e-2); gradient "
        f"cosine {cos:.6f} (bound 0.99); smallest per-tensor cosine "
        f"{per[worst]:.6f} ({worst})")
    if not (rel <= 2e-2 and cos >= 0.99):
        raise RuntimeError("the card's train step disagrees with the CPU "
                           "reference")


def phase_train(tmp: str) -> dict:
    """The training slice's main path at full width, fed seeded batches;
    returns the kernel launches of its 8-step epoch and its p50 step ms."""
    from avion_tpu_torch.models.layers import saved_attn_layers
    from avion_tpu_torch.train.loop import (save_epoch, setup_run,
                                            train_one_epoch)
    from avion_tpu_torch.train.pretrain_clip import build_model_and_state
    from avion_tpu_torch.train.steps import make_clip_train_step

    log(f"== train {MODEL} at {FRAMES} frames, batch {TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps over {len(TRAIN_SEEDS)} distinct batches")
    out_dir = os.path.join(tmp, "train")
    cfg = _train_config(out_dir)
    t0 = time.perf_counter()
    model, opt, schedule = build_model_and_state(cfg, TRAIN_STEPS)
    run = setup_run(cfg, model, opt, make_clip_train_step(model))
    batches = _train_batches(len(TRAIN_SEEDS), TRAIN_BATCH, FRAMES)
    log(f"model, optimizer and batches ready in "
        f"{time.perf_counter() - t0:.1f} s; lr at the last step "
        f"{schedule(TRAIN_STEPS - 1):.3e} (warmup to {cfg.optim.lr:.1e} "
        f"over {TRAIN_STEPS} steps)")

    ends, losses, oks = [], [], []
    inner = run.step

    def timed(state, batch):
        state, metrics = inner(state, batch)
        losses.append(float(metrics["loss"]))
        oks.append(metrics["step_ok"])
        ends.append(time.perf_counter())
        return state, metrics

    run.step = timed
    loader = [batches[i % len(batches)] for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # the main path, counted from here
    start = time.perf_counter()
    metrics = train_one_epoch(run, loader, 0)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    run.step = inner
    per_step = np.diff([start] + ends) * 1e3
    log(f"losses {losses}; step_ok {oks}")
    log(f"step ms {[round(float(x), 3) for x in per_step]}")
    if (len(losses) != TRAIN_STEPS or not np.isfinite(losses).all()
            or oks != [1.0] * TRAIN_STEPS):
        raise RuntimeError("a train step failed")
    want = {"flash_fwd_lse": 2 * LAYERS * TRAIN_STEPS,
            "flash_bwd_combined": 2 * LAYERS * TRAIN_STEPS}
    log(f"kernel launches in {TRAIN_STEPS} steps: {launches} "
        f"(per step: 24 forward-with-lse, 24 combined backward, 0 others)")
    if launches != want:
        raise RuntimeError(f"launches {launches}, expected {want}")
    steady = per_step[2:]
    p50 = float(np.median(steady))
    flops = _model_flops(model, TRAIN_BATCH)
    log(f"steps 3-{TRAIN_STEPS}: p50 {p50:.3f} ms, "
        f"{TRAIN_BATCH * len(steady) / steady.sum() * 1e3:.2f} clips/s; "
        f"peak memory allocated {peak / 2**30:.3f} GiB")
    log(f"model flops per step {flops:.4e} = 6 x parameters x tokens per "
        f"tower (token-embedding table excluded) + 12 B H S^2 D per "
        f"attention layer, remat's extra forward not counted; at the p50 "
        f"step {flops / (p50 * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{flops / (p50 * 1e-3) / H100_BF16_FLOPS:.4f} of 989 TFLOP/s")
    profile_step(run, _to_device(batches[0]))

    small = _to_device({k: v[:POLICY_BATCH] for k, v in batches[0].items()})
    counts = {}
    for policy in ("full", "save_attn_k10"):
        # per tower: one forward per layer, one more for each unsaved layer
        want_fwd = 2 * (2 * LAYERS - min(saved_attn_layers(policy, LAYERS),
                                         LAYERS))
        counts[policy] = _policy_forwards(tmp, policy, small)
        if counts[policy] != want_fwd:
            raise RuntimeError(f"{policy}: {counts[policy]} forward-with-lse "
                               f"launches, expected {want_fwd}")
    log(f"forward-with-lse launches of one batch-{POLICY_BATCH} step: "
        f"save_attn {2 * LAYERS} (above), {counts}")

    _reference_grads(model, cfg, {k: v[:REF_BATCH]
                                  for k, v in batches[1].items()})

    save_epoch(run, 0, metrics)
    saved = {k: v.detach().clone() for k, v in
             run.state.model.state_dict().items()}
    saved_opt = run.state.optimizer.state_dict()
    step = run.state.step
    del run, model, opt
    torch.cuda.empty_cache()
    model2, opt2, _ = build_model_and_state(_train_config(out_dir, "seed=1"),
                                            TRAIN_STEPS)
    run2 = setup_run(cfg, model2, opt2, make_clip_train_step(model2))
    got_opt = run2.state.optimizer.state_dict()
    same = (run2.state.step == step
            and all(torch.equal(v, saved[k]) for k, v in
                    run2.state.model.state_dict().items())
            and got_opt["count"] == saved_opt["count"]
            and all(torch.equal(v, saved_opt["adamw"]["state"][i][k])
                    for i, s in got_opt["adamw"]["state"].items()
                    for k, v in s.items()))
    log(f"checkpoint at step {step} restored into a model built from another "
        f"seed: step, parameters and AdamW moments bit for bit: {same}")
    if not same:
        raise RuntimeError("resume did not restore the train state exactly")
    return launches, p50


def phase_train_long(tmp: str) -> dict:
    """The config's default clip length, 16 frames (3137 visual tokens,
    past the combined backward's 1024): a few steps through the same entry
    points; the visual tower takes the split dq / dkv kernels, the text
    tower the combined one.  Returns the run's launches."""
    from avion_tpu_torch.train.loop import setup_run, train_one_epoch
    from avion_tpu_torch.train.pretrain_clip import build_model_and_state
    from avion_tpu_torch.train.steps import make_clip_train_step

    log(f"== train {MODEL} at {LONG_FRAMES} frames, batch {LONG_BATCH}, "
        f"{LONG_STEPS} steps")
    cfg = _train_config(os.path.join(tmp, "long"),
                        f"data.clip_length={LONG_FRAMES}",
                        f"data.batch_size={LONG_BATCH}")
    model, opt, _ = build_model_and_state(cfg, LONG_STEPS)
    run = setup_run(cfg, model, opt, make_clip_train_step(model))
    loader = _train_batches(LONG_STEPS, LONG_BATCH, LONG_FRAMES)
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    metrics = train_one_epoch(run, loader, 0)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    log(f"{LONG_STEPS} steps in {(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"mean loss {metrics['loss']:.6f}, step_ok {metrics['step_ok']}; "
        f"launches {launches}")
    want = {"flash_fwd_lse": 2 * LAYERS * LONG_STEPS,
            "flash_bwd_combined": LAYERS * LONG_STEPS,
            "flash_bwd_dq": LAYERS * LONG_STEPS,
            "flash_bwd_dkv": LAYERS * LONG_STEPS}
    if not (np.isfinite(metrics["loss"]) and metrics["step_ok"] == 1.0):
        raise RuntimeError("a 16-frame train step failed")
    if launches != want:
        raise RuntimeError(f"launches {launches}, expected {want}")
    return launches


# the data slice: a synthetic Ego4D layout in AVION's cut (15 s chunks at a
# 288 px short side, 30 fps), 8 videos of 2 chunks, and 2048 narration rows
# of 1-4 s windows; run A trains on it with host crop for one 8-step epoch,
# run B with device crop for 4 steps over every second row
DATA_VIDEOS, DATA_CHUNKS, DATA_ROWS = 8, 2, 2048
DATA_W, DATA_H, DATA_FPS, DATA_CHUNK_S = 512, 288, 30, 15
DATA_STEPS, DEVICE_CROP_STEPS = 8, 4
CROP_TOL = 1e-3  # card against CPU, f32, normalized values
VERBS = ("opens", "closes", "picks up", "puts down", "cuts", "washes",
         "stirs", "pours", "holds", "moves")
NOUNS = ("the drawer", "a knife", "the onion", "the cup", "the pan",
         "a plate", "the tap", "the lid", "a bowl", "the towel")


def video_io_check(tmp: str) -> None:
    """cv2's "Video I/O" build section, and an mp4v write read back."""
    import cv2

    info = cv2.getBuildInformation()
    section = info[info.find("Video I/O"):].split("\n\n")[0]
    log(f"cv2 {cv2.__version__} {section.strip()}")
    path = os.path.join(tmp, "probe.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), DATA_FPS,
                         (64, 48))
    if not vw.isOpened():
        raise RuntimeError("cv2 cannot write mp4v on this machine")
    for i in range(10):
        vw.write(np.full((48, 64, 3), 20 * i, np.uint8))
    vw.release()
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    ok, frame = cap.read()
    cap.release()
    if not (ok and n == 10 and frame.shape == (48, 64, 3)):
        raise RuntimeError(f"cv2 cannot read mp4v back: {n} frames, {ok}")


def _write_chunk(path: str, canvas: np.ndarray, first: int,
                 frames: int = DATA_CHUNK_S * DATA_FPS,
                 fps: int = DATA_FPS) -> None:
    """One chunk (15 s by default): a window of the canvas's height and a
    third of its width, sliding one pixel a frame (seeded, smooth, so the
    codec sees motion as in real video)."""
    import cv2

    h, w = canvas.shape[0], canvas.shape[1] // 3
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for t in range(first, first + frames):
        x = t % (canvas.shape[1] - w)
        vw.write(np.ascontiguousarray(canvas[:, x:x + w]))
    vw.release()


def _canvas(rs, w: int, h: int) -> np.ndarray:
    """A seeded smooth texture three frames wide."""
    import cv2

    small = rs.randint(0, 256, (9, 48, 3)).astype(np.uint8)
    return cv2.resize(small, (w * 3, h), interpolation=cv2.INTER_CUBIC)


def write_ego4d_fixture(root: str, seed: int = 0) -> str:
    """``root/vid<k>.mp4/<chunk_start>.mp4`` and an ego4d metadata pickle
    of DATA_ROWS (vid, start, end, narration) rows; returns its path."""
    rs = np.random.RandomState(seed)
    jobs = []
    for v in range(DATA_VIDEOS):
        canvas = _canvas(rs, DATA_W, DATA_H)
        os.makedirs(os.path.join(root, f"vid{v}.mp4"))
        for c in range(DATA_CHUNKS):
            start = c * DATA_CHUNK_S
            jobs.append((os.path.join(root, f"vid{v}.mp4", f"{start}.mp4"),
                         canvas, start * DATA_FPS))
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(lambda job: _write_chunk(*job), jobs))
    span = DATA_CHUNKS * DATA_CHUNK_S
    rows = []
    for _ in range(DATA_ROWS):
        dur = rs.uniform(1.0, 4.0)
        start = rs.uniform(0.0, span - dur)
        rows.append((f"vid{rs.randint(DATA_VIDEOS)}", start, start + dur,
                     f"#C C {VERBS[rs.randint(len(VERBS))]} "
                     f"{NOUNS[rs.randint(len(NOUNS))]}"))
    meta = os.path.join(root, "train.pkl")
    with open(meta, "wb") as f:
        pickle.dump(rows, f)
    return meta


def _device_busy_ms(prof) -> float:
    """Union of the device's activity intervals (kernels, copies) in a
    profile: the copy stream's transfers overlap the step's kernels."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


class _ProfileLastSteps:
    """Wraps the entry's ``make_clip_train_step`` so that the profiler
    covers the last ``window`` steps of the run together with the waits
    for their batches: it starts when the step before them returns and
    stops when the last returns.  Two steps: with ``prefetch_depth=2`` the batches land in
    pairs, a long wait and then a short one."""

    def __init__(self, make_step, steps: int, window: int = 2):
        self.make_step, self.steps, self.window = make_step, steps, window
        self.prof, self.t0, self.wall_ms, self.busy_ms = None, 0.0, 0.0, 0.0

    def __call__(self, model, **kwargs):
        from torch.profiler import ProfilerActivity, profile

        inner = self.make_step(model, **kwargs)
        calls = [0]

        def step(state, batch):
            out = inner(state, batch)
            calls[0] += 1
            torch.cuda.synchronize()
            if calls[0] == self.steps - self.window:
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            elif calls[0] == self.steps:
                self.wall_ms = (time.perf_counter() - self.t0) * 1e3
                self.prof.__exit__(None, None, None)
                self.busy_ms = _device_busy_ms(self.prof)
            return out

        return step


def _data_args(out_dir: str, root: str, meta: str, fused: bool,
               *overrides: str) -> list:
    return [*TRAIN_RECIPE, f"output_dir={out_dir}", f"data.root={root}",
            f"data.train_metadata={meta}", "data.dataset=ego4d",
            f"data.fused_decode_crop={str(fused).lower()}",
            f"data.num_workers={min(8, os.cpu_count() or 1)}",
            "optim.epochs=1", *overrides]


def _train_log(out_dir: str) -> list:
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _check_data_run(name: str, res: dict, launches: dict, steps: int,
                    out_dir: str):
    """Finite losses, every step applied, 24 + 24 launches a step; returns
    the per-step (batch ms, data ms) of the run's log."""
    recs = [r for r in _train_log(out_dir) if "train/loss" in r]
    losses = [r["train/loss"] for r in recs]
    oks = [r["train/step_ok"] for r in recs]
    log(f"{name}: {res['steps']} steps, losses {losses}, step_ok {oks}, "
        f"launches {launches}, decode backend {res['decode_backend']}, "
        f"transfers {res['transfers']}")
    want = {"flash_fwd_lse": 2 * LAYERS * steps,
            "flash_bwd_combined": 2 * LAYERS * steps}
    if (res["steps"] != steps or len(losses) != steps
            or not np.isfinite(losses).all() or oks != [1.0] * steps):
        raise RuntimeError(f"{name}: a data-fed train step failed")
    if launches != want:
        raise RuntimeError(f"{name}: launches {launches}, expected {want}")
    return ([r["perf/batch_time_win"] * 1e3 for r in recs],
            [r["perf/data_time_win"] * 1e3 for r in recs])


def _check_device_crop(cfg_args: list) -> dict:
    """``crop_resize_flip_normalize`` on the card against the CPU, f32, on
    one decoded device-crop batch with its own flips and with every second
    clip flipped; and its time on the card (bf16 out, as the step runs
    it)."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.ops.fused_input import crop_resize_flip_normalize
    from avion_tpu_torch.train.pretrain_clip import build_loaders

    cfg = TrainConfig().apply_overrides(cfg_args)
    _, loader = build_loaders(cfg)
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    args = [torch.from_numpy(np.ascontiguousarray(batch[k]))
            for k in ("video", "crop", "hflip")]
    size = (cfg.data.crop_size, cfg.data.crop_size)
    # the batch's own flips (none under the recipe), then every second
    # clip flipped
    err = 0.0
    for flips in (args[2], torch.arange(len(args[2])) % 2 == 1):
        ref = crop_resize_flip_normalize(*args[:2], flips, out_size=size,
                                         dtype=torch.float32)
        got = crop_resize_flip_normalize(
            args[0].cuda(), args[1].cuda(), flips.cuda(), out_size=size,
            dtype=torch.float32).cpu()
        err = max(err, (got - ref).abs().max().item())
        del ref, got
    dev = [a.cuda() for a in args]
    ms = cuda_ms(lambda: crop_resize_flip_normalize(*dev, out_size=size),
                 iters=5)
    row = {"batch": list(batch["video"].shape), "max_abs_err": err,
           "ms_bf16_out": ms, "flipped": int(batch["hflip"].sum())}
    log(f"device crop on the card against the CPU (f32): {row} "
        f"(bound {CROP_TOL})")
    if not err <= CROP_TOL:
        raise RuntimeError(f"device crop disagrees with the CPU: {err}")
    return row


def _decode_ms_per_clip(cfg_args: list, clips: int = 16) -> float:
    """Wall ms of one dataset item (decode, crop, tokenize) in this
    process: what one loader worker spends a clip."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.train.pretrain_clip import build_loaders

    ds, _ = build_loaders(TrainConfig().apply_overrides(cfg_args))
    ds[0]  # open the first reader
    t0 = time.perf_counter()
    for i in range(1, clips + 1):
        ds[i]
    return (time.perf_counter() - t0) / clips * 1e3


def phase_data(tmp: str, echo_p50: float) -> dict:
    """The data slice's main path: ``pretrain_clip.main`` on decoded video
    at full width, host crop (run A) then device crop (run B), then a
    resume; returns run A's launches."""
    from avion_tpu_torch.data.loader import shm_free_bytes
    from avion_tpu_torch.data.video_reader import default_backend
    from avion_tpu_torch.train import pretrain_clip

    log(f"== data: {MODEL} trained by pretrain_clip.main on decoded video")
    t_phase = time.perf_counter()
    video_io_check(tmp)
    root = os.path.join(tmp, "ego4d")
    t0 = time.perf_counter()
    meta = write_ego4d_fixture(root)
    log(f"fixture: {DATA_VIDEOS} videos x {DATA_CHUNKS} chunks of "
        f"{DATA_CHUNK_S} s, {DATA_W}x{DATA_H} at {DATA_FPS} fps (mp4v), "
        f"{DATA_ROWS} rows, written in {time.perf_counter() - t0:.2f} s")
    log(f"decode backend {default_backend()}, os.cpu_count() "
        f"{os.cpu_count()}, /dev/shm free {shm_free_bytes() / 2**20:.1f} MiB")

    out_a = os.path.join(tmp, "data_host_crop")
    args_a = _data_args(out_a, root, meta, True)
    out_b = os.path.join(tmp, "data_device_crop")
    args_b = _data_args(out_b, root, meta, False, "data.subsample_stride=2")
    per_clip = {"host crop": _decode_ms_per_clip(args_a),
                "device crop": _decode_ms_per_clip(args_b)}
    log("one item (decode, crop, tokenize) in one process, ms a clip: "
        + ", ".join(f"{k} {v:.3f} ({TRAIN_BATCH * v / 1e3:.2f} s a batch)"
                    for k, v in per_clip.items()))
    profiler = _ProfileLastSteps(pretrain_clip.make_clip_train_step,
                                 DATA_STEPS)
    pretrain_clip.make_clip_train_step = profiler
    try:
        torch.cuda.synchronize()
        fa.reset_launches()  # run A's main path, counted from here
        t0 = time.perf_counter()
        res_a = pretrain_clip.main(args_a)
        torch.cuda.synchronize()
        launches_a = dict(fa.launches)
        wall_a = time.perf_counter() - t0
    finally:
        pretrain_clip.make_clip_train_step = profiler.make_step
    batch_ms, data_ms = _check_data_run("run A (host crop)", res_a,
                                        launches_a, DATA_STEPS, out_a)
    steady = np.array(batch_ms[2:])
    p50 = float(np.median(steady))
    log(f"run A per-step ms {[round(x, 3) for x in batch_ms]}, data wait ms "
        f"{[round(x, 3) for x in data_ms]}; main() wall {wall_a:.2f} s")
    log(f"run A steps 3-{DATA_STEPS}: p50 step {p50:.3f} ms, p50 data_time "
        f"{float(np.median(data_ms[2:])):.3f} ms, "
        f"{TRAIN_BATCH * len(steady) / steady.sum() * 1e3:.2f} clips/s; "
        f"echo-fed train p50 {echo_p50:.3f} ms, gap {p50 - echo_p50:.3f} ms "
        f"({p50 / echo_p50:.3f}x)")
    if profiler.busy_ms:
        log(f"profile of data-fed steps {DATA_STEPS - profiler.window + 1}-"
            f"{DATA_STEPS} with their batch waits: wall "
            f"{profiler.wall_ms:.2f} ms, device busy {profiler.busy_ms:.3f} "
            f"ms, idle share {1 - profiler.busy_ms / profiler.wall_ms:.4f}")
    else:
        log("profile: the profiler saw no device time (not measured)")

    torch.cuda.synchronize()
    fa.reset_launches()  # run B's main path
    t0 = time.perf_counter()
    res_b = pretrain_clip.main(args_b)
    torch.cuda.synchronize()
    launches_b = dict(fa.launches)
    wall_b = time.perf_counter() - t0
    batch_ms_b, data_ms_b = _check_data_run(
        "run B (device crop)", res_b, launches_b, DEVICE_CROP_STEPS, out_b)
    log(f"run B per-step ms {[round(x, 3) for x in batch_ms_b]}, data wait "
        f"ms {[round(x, 3) for x in data_ms_b]}; main() wall {wall_b:.2f} s; "
        f"steps 3-{DEVICE_CROP_STEPS}: p50 step "
        f"{float(np.median(batch_ms_b[2:])):.3f} ms")
    crop = _check_device_crop(args_b)

    fa.reset_launches()
    again = pretrain_clip.main(args_a)
    if again["steps"] != 0 or again["step"] != res_a["step"] or fa.launches:
        raise RuntimeError(f"resume of run A trained again: {again}, "
                           f"launches {dict(fa.launches)}")
    log(f"resume of run A: restored step {again['step']}, 0 steps, "
        f"0 launches")
    log(f"data phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"host_crop": launches_a, "device_crop": launches_b,
            "crop": crop, "fixture": (root, meta)}


# the eval slice: seeded synthetic layouts of the five zero-shot suites in
# their datasets' formats, at the data phase's 512x288 and 30 fps
EVAL_SIZES = dict(mir_clips=512, egtea_clips=64,
                  charades_videos=32, charades_classes=24, mcq_items=64)
EVAL_CLIP_S = 3  # seconds of each EGTEA clip and Charades-Ego video


def _ts(sec: float) -> str:
    """Seconds as EPIC-Kitchens' HH:MM:SS.ss."""
    return f"{int(sec // 3600):02d}:{int(sec % 3600 // 60):02d}:" \
        f"{sec % 60:05.2f}"


def write_eval_fixtures(root: str, seed: int = 0, *, w: int = DATA_W,
                        h: int = DATA_H, fps: int = DATA_FPS,
                        chunk_s: int = DATA_CHUNK_S, clip_s: int = EVAL_CLIP_S,
                        mir_clips: int = EVAL_SIZES["mir_clips"],
                        egtea_clips: int = EVAL_SIZES["egtea_clips"],
                        charades_videos: int = EVAL_SIZES["charades_videos"],
                        charades_classes: int = EVAL_SIZES["charades_classes"],
                        mcq_items: int = EVAL_SIZES["mcq_items"]) -> dict:
    """Write the five suites' layouts under ``root`` with cv2 (mp4v):

    - EK100 MIR: ``ek100/PXX/PXX_YY.MP4/<chunk_start>.MP4`` (4 videos of 2
      chunks), ``EPIC_100_retrieval_test.csv`` of ``mir_clips`` narrated
      windows (verb x noun captions, each of the 100 once before any
      repeats), its ``_sentence.csv`` (each distinct caption once, under
      the id of its first clip, in a seeded order) and the graded
      relevancy pkl (1 for the same verb and noun, 0.5 for one of them,
      else 0), so that every clip and sentence has a relevant match;
    - EK100 CLS: the same csv and videos, and an ``actions.csv`` of the
      100 verb-noun actions;
    - EGTEA: ``egtea/data/<video>/<clip>.mp4``, ``action_idx.txt`` and
      ``test_split1.txt`` over 20 actions;
    - Charades-Ego: ``charades/data/<id>.mp4``, the classes txt and the
      test csv, 1-3 labelled actions a video;
    - EgoMCQ: ``mcq/<uid>.mp4/0.mp4`` (4 videos of one chunk) and
      ``egomcq.json``: a query, 5 candidate windows, the answer, intra- or
      inter-video.

    Returns ``{"data": DataConfig overrides, "env": the suites' variables,
    "mir_videos": the MIR chunk files}``."""
    rs = np.random.RandomState(seed)
    jobs = []

    def video(path, frames):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jobs.append((path, _canvas(rs, w, h), 0, frames, fps))

    def caption(combo):
        v, n = divmod(int(combo), len(NOUNS))
        return v, n, f"{VERBS[v]} {NOUNS[n]}"

    def write_csv(path, header, rows):
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(header)
            writer.writerows(rows)

    combos = len(VERBS) * len(NOUNS)
    # EK100 MIR and CLS
    ek = os.path.join(root, "ek100")
    vids = [("P01", "P01_01"), ("P01", "P01_02"), ("P02", "P02_01"),
            ("P02", "P02_02")]
    mir_videos = []
    for pid, vid in vids:
        for c in range(2):
            path = os.path.join(ek, pid, f"{vid}.MP4", f"{c * chunk_s}.MP4")
            video(path, chunk_s * fps)
            mir_videos.append(path)
    order = rs.permutation(combos)
    rows, parts = [], []
    for k in range(mir_clips):
        pid, vid = vids[rs.randint(len(vids))]
        dur = rs.uniform(1.0, min(4.0, chunk_s))
        start = rs.uniform(0.0, 2 * chunk_s - dur)
        v, n, text = caption(order[k % combos])
        parts.append((v, n))
        rows.append([f"{vid}_{k}", pid, vid, _ts(start), _ts(start),
                     _ts(start + dur), int(start * fps),
                     int((start + dur) * fps), text, VERBS[v], v, NOUNS[n], n,
                     f"['{NOUNS[n]}']", f"[{n}]"])
    header = ["narration_id", "participant_id", "video_id",
              "narration_timestamp", "start_timestamp", "stop_timestamp",
              "start_frame", "stop_frame", "narration", "verb", "verb_class",
              "noun", "noun_class", "all_nouns", "all_noun_classes"]
    val = os.path.join(ek, "EPIC_100_retrieval_test.csv")
    write_csv(val, header, rows)
    sent = rs.permutation(np.unique([r[8] for r in rows],
                                    return_index=True)[1])
    write_csv(os.path.join(ek, "EPIC_100_retrieval_test_sentence.csv"),
              ["narration_id", "narration"],
              [[rows[i][0], rows[i][8]] for i in sent])
    p = np.asarray(parts)
    rel = ((p[:, None, 0] == p[None, sent, 0]).astype(np.float64)
           + (p[:, None, 1] == p[None, sent, 1])) / 2
    os.makedirs(os.path.join(ek, "relevancy"))
    rel_path = os.path.join(
        ek, "relevancy", "caption_relevancy_EPIC_100_retrieval_test.pkl")
    with open(rel_path, "wb") as f:
        pickle.dump(rel, f)
    actions = os.path.join(ek, "actions.csv")
    write_csv(actions, ["id", "verb", "noun", "action"],
              [[i, *caption(i)[:2], caption(i)[2].replace(" ", "_")]
               for i in range(combos)])

    # EGTEA: 20 actions, clips of clip_s seconds
    eg = os.path.join(root, "egtea")
    os.makedirs(os.path.join(eg, "meta"))
    with open(os.path.join(eg, "meta", "action_idx.txt"), "w") as f:
        f.writelines(f"{caption(order[i])[2].replace(' ', '_')} {i + 1}\n"
                     for i in range(20))
    with open(os.path.join(eg, "meta", "test_split1.txt"), "w") as f:
        for k in range(egtea_clips):
            video_id = f"P{k % 4 + 1:02d}-R01-Kitchen"
            clip_id = f"{video_id}-{k:04d}"
            video(os.path.join(eg, "data", video_id, f"{clip_id}.mp4"),
                  clip_s * fps)
            f.write(f"{clip_id} {rs.randint(20) + 1} 0\n")

    # Charades-Ego: untrimmed test videos with 1-3 actions each
    ch = os.path.join(root, "charades")
    os.makedirs(os.path.join(ch, "meta"))
    with open(os.path.join(ch, "meta", "Charades_v1_classes.txt"), "w") as f:
        f.writelines(f"c{i:03d} {caption(order[-1 - i])[2]}\n"
                     for i in range(charades_classes))
    rows = []
    for k in range(charades_videos):
        vid = f"V{k:04d}EGO"
        video(os.path.join(ch, "data", f"{vid}.mp4"), clip_s * fps)
        acts = rs.choice(charades_classes,
                         rs.randint(1, min(3, charades_classes) + 1),
                         replace=False)
        rows.append([vid] + [""] * 8 + [";".join(
            f"c{a:03d} {rs.uniform(0, clip_s / 2):.2f} "
            f"{rs.uniform(clip_s / 2, clip_s):.2f}" for a in acts),
            f"{clip_s:.2f}"])
    write_csv(os.path.join(ch, "meta", "CharadesEgo_v1_test_only1st.csv"),
              ["id", "subject", "scene", "quality", "relevance", "verified",
               "script", "objects", "descriptions", "actions", "length"],
              rows)

    # EgoMCQ: 4 one-chunk videos; a query and 5 candidate windows
    mq = os.path.join(root, "mcq")
    uids = [f"uid{u}" for u in range(4)]
    for uid in uids:
        video(os.path.join(mq, f"{uid}.mp4", "0.mp4"), chunk_s * fps)
    items = {}
    for k in range(mcq_items):
        intra = k % 2 == 0
        choices = {}
        for c in range(5):
            dur = rs.uniform(1.0, min(3.0, chunk_s))
            start = rs.uniform(0.0, chunk_s - dur)
            choices[str(c)] = {
                "video_uid": uids[k % 4] if intra else uids[rs.randint(4)],
                "clip_start": start, "clip_end": start + dur,
                "clip_text": caption(order[(k * 5 + c) % combos])[2]}
        query = f"#C C {caption(order[-1 - k % combos])[2]} {k}"
        items[str(k)] = {"query": {"clip_text": query}, "choices": choices,
                         "answer": int(rs.randint(5)),
                         "types": 1 if intra else 2}
    with open(os.path.join(mq, "egomcq.json"), "w") as f:
        json.dump(items, f)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(lambda job: _write_chunk(*job), jobs))
    return {"data": {"val_metadata": val, "relevancy_path": rel_path,
                     "root_val": ek, "chunk_len": chunk_s},
            "env": {"EK100_ACTIONS_CSV": actions, "EK100_VAL": val,
                    "EK100_VIDEO_DIR": ek,
                    "EGTEA_DATA_DIR": os.path.join(eg, "data"),
                    "EGTEA_META_DIR": os.path.join(eg, "meta"),
                    "CHARADES_DATA_DIR": os.path.join(ch, "data"),
                    "CHARADES_META_DIR": os.path.join(ch, "meta"),
                    "EGO4D_MCQ_DATA_DIR": mq, "EGO4D_MCQ_META_DIR": mq},
            "mir_videos": mir_videos}


EVAL_BATCH = 128  # data.val_batch_size's default
EVAL_EPOCHS = 2  # of the in-training drive, one step each
EMBED_CLIPS = 8


class _Captured:
    """Replaces ``module.CLIPEncoders`` by a subclass that keeps every
    instance made, until ``restore``."""

    def __init__(self, module):
        self.module, self.orig, self.made = module, module.CLIPEncoders, []
        made = self.made

        class Capturing(self.orig):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        module.CLIPEncoders = Capturing

    def forwards(self) -> int:
        return sum(e.image_calls + e.text_calls for e in self.made)

    def restore(self) -> None:
        self.module.CLIPEncoders = self.orig


def _eval_args(fx: dict, ckpt: str) -> list:
    return [f"model.name={MODEL}", f"data.clip_length={FRAMES}",
            f"data.crop_size={SIZE}", f"data.val_batch_size={EVAL_BATCH}",
            f"data.num_workers={min(8, os.cpu_count() or 1)}",
            *(f"data.{k}={v}" for k, v in fx["data"].items()),
            f"pretrain_model={ckpt}"]


def _eval_in_training(tmp: str, fx: dict, fixture: tuple) -> dict:
    """(a) ``pretrain_clip.main`` with ``eval_freq=1`` and the MIR suite,
    EVAL_EPOCHS one-step epochs on the data phase's Ego4D layout (every
    eighth row): the epoch -1 and per-epoch metrics, ``is_best`` on
    ``test_ek100_mir_avg_map``, the training model bit-equal (weights,
    dtypes, modes) across every eval pass, and the launches."""
    from avion_tpu_torch.eval import validate
    from avion_tpu_torch.train import pretrain_clip

    out = os.path.join(tmp, "data_with_eval")
    d = fx["data"]
    args = _data_args(out, *fixture, True, f"optim.epochs={EVAL_EPOCHS}",
                      "data.subsample_stride=8", "eval_freq=1",
                      f"data.val_batch_size={EVAL_BATCH}",
                      f"data.val_metadata={d['val_metadata']}",
                      f"data.relevancy_path={d['relevancy_path']}",
                      f"data.root_val={d['root_val']}")
    inner, passes = pretrain_clip.run_validation, []

    def checked(model, data_cfg, env=None, strict=False):
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        modes = [m.training for m in model.modules()]
        res = inner(model, data_cfg, env, strict)
        after = model.state_dict()
        passes.append(modes == [m.training for m in model.modules()] and all(
            after[k].dtype == v.dtype and torch.equal(after[k], v)
            for k, v in before.items()))
        return res

    pretrain_clip.run_validation = checked
    captured = _Captured(validate)
    try:
        torch.cuda.synchronize()
        fa.reset_launches()  # the path, counted from here
        t0 = time.perf_counter()
        res = pretrain_clip.main(args)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
    finally:
        pretrain_clip.run_validation = inner
        captured.restore()
    wall = time.perf_counter() - t0
    steps = res["steps"]
    log(f"(a) main with eval_freq=1: {steps} steps in {EVAL_EPOCHS} epochs, "
        f"{len(passes)} eval passes, main() wall {wall:.2f} s; the training "
        f"model bit-equal and in its modes after each pass: {passes}")
    for epoch, metrics in sorted(res["eval"].items()):
        log(f"  epoch {epoch}: {metrics}")
    want = {"flash_fwd": LAYERS * captured.forwards(),
            "flash_fwd_lse": 2 * LAYERS * steps,
            "flash_bwd_combined": 2 * LAYERS * steps}
    log(f"  launches {launches} for {captured.forwards()} eval tower "
        f"forwards and {steps} steps (expected {want})")
    if len(passes) != EVAL_EPOCHS + 1 or not all(passes):
        raise RuntimeError("an eval pass changed the training model")
    if sorted(res["eval"]) != list(range(-1, EVAL_EPOCHS)) or not all(
            len(m) == 6 and all(k.startswith("test_ek100_mir_")
                                and np.isfinite(v) for k, v in m.items())
            for m in res["eval"].values()):
        raise RuntimeError(f"bad in-training eval metrics {res['eval']}")
    if steps != EVAL_EPOCHS or launches != want:
        raise RuntimeError(f"(a): {steps} steps, launches {launches}")
    logged = [r["step"] for r in _train_log(out)
              if "test_ek100_mir_avg_map" in r]
    maps = [res["eval"][e]["test_ek100_mir_avg_map"]
            for e in range(EVAL_EPOCHS)]
    best, bests = -1.0, []
    for m in maps:
        bests.append(m > best)
        best = max(best, m)
    got = []
    for step in range(1, EVAL_EPOCHS + 1):
        with open(os.path.join(out, "ckpt", str(step), "extra.json")) as f:
            extra = json.load(f)
        got.append((extra["is_best"],
                    extra["metrics"]["test_ek100_mir_avg_map"]))
    log(f"  eval logged at steps {logged}; checkpoints (is_best, avg_map) "
        f"{got}")
    if logged != list(range(EVAL_EPOCHS + 1)) or got != list(zip(bests,
                                                                  maps)):
        raise RuntimeError("eval logging or is_best does not follow "
                           "test_ek100_mir_avg_map")
    return launches


def _embed_check(tmp: str, fx: dict, ckpt: str) -> None:
    """(d) ``tools.embed_videos`` on the card (bf16 weights) for
    EMBED_CLIPS MIR chunk files and as many sentences, against the same
    clips and sentences through the plain path on the CPU in f32."""
    from avion_tpu_torch.data.sampling import get_frame_ids
    from avion_tpu_torch.data.tokenizer import tokenize
    from avion_tpu_torch.data.transforms import (center_crop_spec,
                                                 normalize_video)
    from avion_tpu_torch.data.video_reader import VideoReader
    from avion_tpu_torch.models.pt_import import load_clip_checkpoint
    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.tools import embed_videos

    paths = fx["mir_videos"][:EMBED_CLIPS]
    with open(os.path.join(tmp, "embed_videos.txt"), "w") as f:
        f.write("\n".join(paths))
    with open(fx["data"]["val_metadata"].replace("test", "test_sentence"),
              newline="") as f:
        texts = [row[1] for row in list(csv.reader(f))[1:EMBED_CLIPS + 1]]
    with open(os.path.join(tmp, "embed_texts.txt"), "w") as f:
        f.write("\n".join(texts))
    t0 = time.perf_counter()
    out = embed_videos.main(["--ckpt", ckpt, "--model", MODEL,
                             "--videos", os.path.join(tmp, "embed_videos.txt"),
                             "--texts", os.path.join(tmp, "embed_texts.txt"),
                             "--out", os.path.join(tmp, "embeds.npz"),
                             "--clip-length", str(FRAMES),
                             "--crop-size", str(SIZE)])
    wall = time.perf_counter() - t0
    v_emb = _unit_rows("embed video", out["video_embeds"], len(paths))
    t_emb = _unit_rows("embed text", out["text_embeds"], len(texts))

    model = create_model(MODEL, num_frames=FRAMES, dtype=torch.float32)
    load_clip_checkpoint(model, ckpt)
    clips = []
    for path in paths:
        vr = VideoReader(path)
        clips.append(vr.get_batch(
            get_frame_ids(0, len(vr), FRAMES, jitter=False),
            center_crop_spec(vr.width, vr.height), (SIZE, SIZE)))
    with torch.inference_mode():
        ref_v = model.encode_image(normalize_video(
            torch.from_numpy(np.stack(clips)), dtype=torch.float32)).numpy()
        ref_t = model.encode_text(torch.from_numpy(tokenize(texts)).long()
                                  ).numpy()
    cos_v, cos_t = (ref_v * v_emb).sum(-1), (ref_t * t_emb).sum(-1)
    log(f"(d) embed_videos on the card ({wall:.2f} s, {len(paths)} clips, "
        f"{len(texts)} texts) against the CPU plain path in f32: cosine "
        f"video min {cos_v.min():.6f}, text min {cos_t.min():.6f} (bound "
        f"0.99)")
    if min(cos_v.min(), cos_t.min()) < 0.99:
        raise RuntimeError("embed_videos disagrees with the CPU reference")


def _profile_sweep(enc, cfg, suite: str = "ek100_mir") -> None:
    """(e) One suite's sweep under torch.profiler: wall, device busy (the
    union of the device's intervals), idle share, and the device time by
    kind of kernel."""
    from torch.profiler import ProfilerActivity, profile

    from avion_tpu_torch.eval.validate import build_suites, validate_all

    suites = build_suites(cfg.data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        validate_all(enc, {suite: suites[suite]}, strict=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = _device_busy_ms(prof)
    st = enc.suite_stats[suite]
    if not busy:
        log("(e) profile: the profiler saw no device time (not measured)")
        return
    log(f"(e) profile of one {suite} sweep ({st['image_rows']} clips, "
        f"{st['text_rows']} texts, {st['image_calls']} + {st['text_calls']} "
        f"tower forwards): wall {wall:.2f} ms, device busy {busy:.3f} ms, "
        f"idle share {1 - busy / wall:.4f}, data wait "
        f"{st['data_wait_s'] * 1e3:.2f} ms; device time by kind:")
    log_device_time(_device_ms_by_name(prof))


def _check_eval_shapes(shapes: list) -> list:
    """The inference forward (bf16) against its plain f32 version on seeded
    randn inputs at every shape the eval paths gave it, with the tolerances
    of phase_kernel; returns the rows."""
    rows, bad = [], []
    for i, (b, s, h, d, causal) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(i)
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        fa.reset_launches()
        with torch.inference_mode():
            out = fa.flash_attention_fused_qkv(qkv, h, s, causal=causal)
        torch.cuda.synchronize()
        if dict(fa.launches) != {"flash_fwd": 1}:
            raise RuntimeError(f"flash_fwd launches {dict(fa.launches)}")
        ref = fa.flash_attention_fused_qkv_plain(qkv.float(), h, s,
                                                 causal=causal)
        err, rel = _errors(out, ref)
        del ref
        row = {"shape": [b, s, h, d], "causal": causal, "path": "eval",
               "max_abs_err": err, "rel_rms_err": rel,
               "kernel_ms": cuda_ms(lambda: fa.flash_attention_fused_qkv(
                   qkv, h, s, causal=causal))}
        row["bound_ms"], row["bound_by"] = bound(b, s, h, d, causal)
        rows.append(row)
        log("flash_fwd at an eval shape " + json.dumps(row))
        if not (err <= TOL and rel <= REL_TOL):  # NaN fails too
            bad.append(f"{[b, s, h, d]} causal={causal}: max abs err {err}, "
                       f"rms err / rms out {rel}")
    if bad:
        raise RuntimeError("flash_fwd disagrees with its plain version at "
                           "eval shapes: " + "; ".join(bad))
    return rows


def phase_eval(tmp: str, fixture: tuple, ckpt: str) -> dict:
    """The eval slice's main paths at full width: (a) evals inside
    ``pretrain_clip.main``; (b) ``eval.validate.main``, strict, on the
    serve phase's seeded checkpoint over the five suites, each with its
    wall time, clips/s, data-wait share and metrics; (c) its launches
    against its tower forwards; (d) ``tools.embed_videos`` against the
    CPU; (e) the idle share of a profiled sweep; then the inference
    forward against its plain version at every shape (a) and (b) gave it.
    Returns the launches of (a) and (b) and those checks' rows."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.eval import validate

    log(f"== eval: the five zero-shot suites on {MODEL} at {FRAMES} frames, "
        f"val batch {EVAL_BATCH}")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fx = write_eval_fixtures(os.path.join(tmp, "eval"))
    log(f"fixtures ({EVAL_SIZES}) written in {time.perf_counter() - t0:.2f} s")
    # the inference forward's shapes on (a) and (b), ragged chunks included
    fwd_shapes, fwd = set(), fa._fwd_cuda

    def recording(qkv, heads, s, causal, sm_scale, with_lse):
        if not with_lse:
            fwd_shapes.add((qkv.shape[0], s, heads,
                            qkv.shape[-1] // (3 * heads), bool(causal)))
        return fwd(qkv, heads, s, causal, sm_scale, with_lse)

    args = _eval_args(fx, ckpt)
    saved_env = {k: os.environ.get(k) for k in fx["env"]}
    captured = None
    fa._fwd_cuda = recording
    try:
        with_eval = _eval_in_training(tmp, fx, fixture)
        os.environ.update(fx["env"])
        captured = _Captured(validate)
        torch.cuda.synchronize()
        fa.reset_launches()  # (b)'s main path, counted from here
        t0 = time.perf_counter()
        res = validate.main(args)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        wall = time.perf_counter() - t0
        (enc,) = captured.made
        forwards = captured.forwards()
        log(f"(b) validate.main wall {wall:.2f} s (model build and load "
            f"included)")
        for name, st in enc.suite_stats.items():
            log(f"  {name}: wall {st['wall_s']:.3f} s, {st['image_rows']} "
                f"clips ({st['image_rows'] / st['wall_s']:.2f} clips/s), "
                f"{st['text_rows']} texts, data-wait share "
                f"{st['data_wait_s'] / st['wall_s']:.4f}, tower forwards "
                f"{st['image_calls']} + {st['text_calls']}; " + ", ".join(
                    f"{k[len(name) + 6:]}={v:.4f}" for k, v in res.items()
                    if k.startswith(f"test_{name}_")))
        log(f"(c) launches {launches} for {forwards} tower forwards "
            f"(expected {LAYERS} per forward)")
        if set(enc.suite_stats) != {"ek100_mir", "ek100_cls", "egtea",
                                    "charades_ego", "egomcq"}:
            raise RuntimeError(f"suites run: {sorted(enc.suite_stats)}")
        if not res or not all(np.isfinite(v) for v in res.values()):
            raise RuntimeError(f"bad eval metrics {res}")
        if launches != {"flash_fwd": LAYERS * forwards}:
            raise RuntimeError(f"eval launched {launches} for {forwards} "
                               f"tower forwards")
        _profile_sweep(enc, TrainConfig().apply_overrides(args))
        del enc
        captured.made.clear()
    finally:
        fa._fwd_cuda = fwd
        if captured is not None:
            captured.restore()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    checks = _check_eval_shapes(sorted(fwd_shapes))
    _embed_check(tmp, fx, ckpt)
    log(f"eval phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"with_eval": with_eval, "eval": launches, "checks": checks}


KERNEL_SOURCES = {
    "flash_fwd": ("flash_fwd.cu", 134), "flash_fwd_lse": ("flash_fwd.cu", 91),
    "flash_bwd_combined": ("flash_bwd.cu", 494),
    "flash_bwd_dq": ("flash_bwd.cu", 220), "flash_bwd_dkv": ("flash_bwd.cu", 271),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    phase_environment()
    phase_build()
    rows = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(tmp)
        train, echo_p50 = phase_train(tmp)
        long = phase_train_long(tmp)
        data = phase_data(tmp, echo_p50)
        evals = phase_eval(tmp, data["fixture"],
                           os.path.join(tmp, "clip_vitb16_random.pt"))
    # each kernel's launches from the path that drives it: serving, the
    # data-fed 4-frame main path (run A), and the 16-frame path for the
    # split kernels; every path's counts beside them
    launches = {"flash_fwd": serve, **data["host_crop"],
                "flash_bwd_dq": long["flash_bwd_dq"],
                "flash_bwd_dkv": long["flash_bwd_dkv"]}
    by_path = {"serve": {"flash_fwd": serve}, "train_seeded_batches": train,
               "train_16_frames": long, "data_host_crop": data["host_crop"],
               "data_device_crop": data["device_crop"],
               "eval": evals["eval"], "data_with_eval": evals["with_eval"]}
    rows["flash_fwd"] += evals["checks"]
    kernels = []
    for name, (source, line) in KERNEL_SOURCES.items():
        head = rows[name][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"avion_tpu_torch/ops/csrc/{source}",
            "replaces": f"avion_tpu/ops/flash_attention.py:{line}",
            "launches": launches[name],
            "launches_by_path": {path: counts[name] for path, counts in
                                 by_path.items() if name in counts},
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "shapes": rows[name]})
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
