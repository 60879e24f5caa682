"""Device-op profiler for the CLIP train step (``avion_tpu.tools.
profile_step``): records ``--steps`` steps with ``torch.profiler``
(``core.profiling.trace``) and prints their device time by kernel kind,
tower and phase, from the chrome trace.

Usage::

    python -m avion_tpu_torch.tools.profile_step [--batch 224] [--steps 2]
        [--model CLIP_VITB16] [--frames 4] [--remat save_attn]
        [--out <dir>] [--top 25] [--device cuda|cpu]
    python -m avion_tpu_torch.tools.profile_step --trace-only <dir>

The step is the pretraining entry's (``train.pretrain_clip.
build_model_and_state``, ``train.steps.make_clip_train_step``) with its
recipe's AdamW and remat, on seeded batches; three steps warm up outside
the trace.  In the trace each device event (``kernel``, ``gpu_memcpy``,
``gpu_memset``) carries a ``correlation`` id that names the host launch
(``cuda_runtime`` / ``cuda_driver``); the launch's thread and time give
the row's

- **region**: ``vision`` / ``text`` inside the ``avion.tower.visual`` /
  ``avion.tower.text`` span (``models.clip``); a backward launch takes
  the region of the forward op with its autograd sequence number;
- **phase**: ``bwd`` inside an ``autograd::engine::evaluate_function``
  op, else ``fwd``;
- **kind**: the kernel's name without its return type, namespaces,
  template arguments and parameters (``flash_fwd_kernel``,
  ``bwd_kv_kernel``), or the copy's name.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
import re
import tempfile
import time
from collections import Counter, defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
REGIONS = {"avion.tower.visual": "vision", "avion.tower.text": "text"}
BWD_OP = "autograd::engine::evaluate_function"


def kernel_kind(name: str) -> str:
    """``void (anonymous namespace)::flash_fwd_kernel<64, false>(Params)``
    -> ``flash_fwd_kernel``; ``Memcpy HtoD (Pageable -> Device)`` ->
    ``Memcpy HtoD``."""
    n = re.sub(r"^void ", "", name.strip()).replace("(anonymous namespace)",
                                                     "")
    n = re.split(r"[<(]", n, maxsplit=1)[0].strip()
    return n.rsplit("::", 1)[-1] or name


def _load(trace_dir: str) -> list:
    paths = [p for p in glob.glob(os.path.join(trace_dir, "**", "*.json*"),
                                  recursive=True)
             if p.endswith((".json", ".json.gz"))]
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


class _Spans:
    """The host spans of one thread, by start time, to find the innermost
    one of a kind that holds a moment."""

    def __init__(self):
        self.spans = []

    def add(self, ts: float, end: float, value) -> None:
        self.spans.append((ts, end, value))

    def seal(self) -> None:
        self.spans.sort(key=lambda s: s[0])
        self.starts = [s[0] for s in self.spans]

    def holding(self, t: float):
        """The value of the latest-starting span that holds ``t``."""
        i = bisect.bisect_right(self.starts, t)
        while i > 0:
            i -= 1
            ts, end, value = self.spans[i]
            if ts <= t <= end:
                return value
        return None


def analyze_trace(trace_dir: str, top: int = 25, steps: int = 1):
    """Parse the newest chrome trace under ``trace_dir``; returns
    (rows, total_ms) with rows = [(ms_per_step, count, kind, region,
    phase)] sorted by cost, ``count`` a step."""
    evs = [e for e in _load(trace_dir) if e.get("ph") == "X"]
    regions, bwd_ops = defaultdict(_Spans), defaultdict(_Spans)
    launches, seq_ops = {}, []
    for e in evs:
        cat, name, args = e.get("cat", ""), e.get("name", ""), \
            e.get("args") or {}
        thread, ts = (e.get("pid"), e.get("tid")), float(e.get("ts", 0))
        if name in REGIONS and cat in ("user_annotation", "cpu_op"):
            regions[thread].add(ts, ts + float(e.get("dur", 0)),
                                REGIONS[name])
        elif cat == "cpu_op" and name.startswith(BWD_OP):
            bwd_ops[thread].add(ts, ts + float(e.get("dur", 0)),
                                ("bwd", args.get("Sequence number")))
        elif cat == "cpu_op" and "Sequence number" in args:
            seq_ops.append((ts, thread, args["Sequence number"]))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (thread, ts)
    for spans in (*regions.values(), *bwd_ops.values()):
        spans.seal()

    def region_at(thread, ts):
        return regions[thread].holding(ts) if thread in regions else None

    def in_bwd(thread, ts):
        return bwd_ops[thread].holding(ts) if thread in bwd_ops else None

    # each autograd sequence number's first forward op
    fwd_seq = {}
    for ts, thread, seq in sorted(seq_ops, key=lambda s: s[0]):
        if in_bwd(thread, ts) is None:
            fwd_seq.setdefault(seq, (thread, ts))
    agg, cnt = defaultdict(float), Counter()
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        host = launches.get((e.get("args") or {}).get("correlation"))
        phase, region = "fwd", None
        if host is not None:
            bwd = in_bwd(*host)
            if bwd is not None:
                phase = "bwd"
                if bwd[1] in fwd_seq:
                    region = region_at(*fwd_seq[bwd[1]])
            else:
                region = region_at(*host)
        key = (kernel_kind(e.get("name", "")), region or "other", phase)
        agg[key] += float(e.get("dur", 0)) / 1e3 / steps
        cnt[key] += 1
    rows = [(ms, cnt[k] // steps, *k) for k, ms in agg.items()]
    rows.sort(reverse=True)
    return rows[:top], sum(agg.values())


def _batches(n: int, batch: int, frames: int, size: int) -> list:
    """Seeded batches in the caption datasets' collate contract: uint8
    clips and token ids with start and end-of-text tokens."""
    import numpy as np

    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        text = rng.integers(1, 49405, (batch, 77), dtype=np.int32)
        text[:, 0] = 49406
        text[np.arange(batch), rng.integers(5, 77, batch)] = 49407
        out.append({"video": rng.integers(0, 256, (batch, frames, size, size,
                                                   3), dtype=np.uint8),
                    "text": text})
    return out


def capture(args) -> dict:
    """Three warm-up steps, then ``args.steps`` traced ones; returns the
    trace directory and the traced steps' wall ms."""
    import torch

    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.core.profiling import trace
    from avion_tpu_torch.parallel.launch import resolve_device
    from avion_tpu_torch.train.loop import setup_run
    from avion_tpu_torch.train.pretrain_clip import build_model_and_state
    from avion_tpu_torch.train.steps import make_clip_train_step

    device = resolve_device(args.device)
    remat = args.remat or ("save_attn_k10" if args.batch >= 256
                           else "save_attn")
    cfg = TrainConfig().apply_overrides([
        f"model.name={args.model}", f"data.clip_length={args.frames}",
        f"data.batch_size={args.batch}", "model.use_grad_checkpointing=true",
        f"model.remat_policy={remat}", "optim.optimizer=adamw",
        "optim.lr=4e-5", "optim.wd=0.05", "optim.warmup_epochs=1",
        f"output_dir={os.path.join(args.out, 'run')}"])
    model, opt, _ = build_model_and_state(cfg, 3 + args.steps,
                                          device=device)
    run = setup_run(cfg, model, opt, make_clip_train_step(model))
    batch = {k: torch.from_numpy(v).to(device) for k, v in _batches(
        1, args.batch, args.frames, model.image_size)[0].items()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(3):  # warm up outside the trace
        run.state, metrics = run.step(run.state, batch)
    float(metrics["loss"])
    with trace(args.out):
        sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run.state, metrics = run.step(run.state, batch)
        float(metrics["loss"])
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    return {"trace_dir": args.out, "wall_ms": wall_ms}


def main(argv=None) -> dict:
    """Prints the device time a step and the top rows; returns
    ``{"rows", "total_ms", "wall_ms"}`` (``wall_ms`` None with
    ``--trace-only``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=224)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "avion_steptrace"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace-only", default=None,
                    help="skip capture; analyze this existing trace dir")
    ap.add_argument("--model", default="CLIP_VITB16")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--remat", default=None,
                    help="remat policy (default: save_attn; b256 needs "
                         "save_attn_k10)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    wall_ms = None
    if args.trace_only is None:
        got = capture(args)
        trace_dir, wall_ms = got["trace_dir"], got["wall_ms"]
    else:
        trace_dir = args.trace_only
    rows, total = analyze_trace(trace_dir, args.top, args.steps)
    print(f"device op time: {total:.1f} ms/step "
          + (f"of {wall_ms:.1f} ms wall " if wall_ms is not None else "")
          + f"(trace: {trace_dir})")
    print(f"{'ms/step':>9}  {'n':>4}  {'kind':<28} {'region':<8} phase")
    for ms, n, kind, region, phase in rows:
        print(f"{ms:9.3f}  {n:>4}  {kind[:28]:<28} {region:<8} {phase}")
    return {"rows": rows, "total_ms": total, "wall_ms": wall_ms}


if __name__ == "__main__":
    main()
