"""Attention-kernel microbenchmark: split vs combined backward
(``avion_tpu.tools.bench_attention``).

Times the fused-qkv flash attention forward plus backward
(``ops.flash_attention.flash_attention_fused_qkv``) at ViT-B pretraining
shapes (S 785, W 768, 12 heads), comparing the two-kernel backward
(``flash_bwd_dq`` and ``flash_bwd_dkv``, each recomputing the scores)
with the combined one (``flash_bwd_combined``, the scores recomputed
once) by setting ``flash_attention._COMBINED_BWD``.  Past the dispatch
bound (``_COMBINED_MAX_SPAD``) only the split route is timed, as the
training path takes it there.  Before timing, the two routes' gradients
at batch 2 are held against each other on the device (max abs difference
within ``2e-2 * max(scale, 1)``).  Times are CUDA events on the card; the
card's name and power limit go to stderr.

Usage::

    python -m avion_tpu_torch.tools.bench_attention [--batch 64]
        [--frames 4] [--iters 20] [--heads 12] [--width 768]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from avion_tpu_torch.core.profiling import card_line, device_ms
from avion_tpu_torch.ops import flash_attention as fam
from avion_tpu_torch.parallel.launch import resolve_device


def _grad(qkv: torch.Tensor, heads: int, s: int, scale: float = 1.0,
          power: int = 1) -> torch.Tensor:
    x = qkv.detach().requires_grad_()
    o = fam.flash_attention_fused_qkv(x, heads, s)
    (o.float() ** power * scale).sum().backward()
    return x.grad


def bench_variant(qkv, heads, s, combined: bool, iters: int,
                  device: torch.device) -> float:
    """ms of one forward + backward of ``sum(o * 1e-3)`` on the route
    ``combined`` forces."""
    fam._COMBINED_BWD = combined
    return device_ms(lambda: _grad(qkv, heads, s, 1e-3), device, iters)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--grid", type=int, default=14,
                   help="patches per side (224/16)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(card_line(device), file=sys.stderr)

    s = args.frames * args.grid * args.grid + 1  # CLS
    s_pad = (s + 127) // 128 * 128
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy(rng.randn(args.batch, s, 3 * args.width).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16)
    print(f"shapes: B={args.batch} S={s} (pad {s_pad}) W={args.width} "
          f"H={args.heads}", file=sys.stderr)
    routed = fam._COMBINED_BWD
    try:
        # the combined backward's route ends at the dispatch bound; past
        # it the split kernels are what training runs
        can_combine = s_pad <= fam._COMBINED_MAX_SPAD
        if can_combine:
            small = qkv[:2]
            fam._COMBINED_BWD = False
            g_split = _grad(small, args.heads, s, power=2).float()
            fam._COMBINED_BWD = True
            g_comb = _grad(small, args.heads, s, power=2).float()
            err = (g_split - g_comb).abs().max().item()
            scale = g_split.abs().max().item()
            print(f"on-device |split-combined| max err {err:.3e} "
                  f"(scale {scale:.3e})", file=sys.stderr)
            if not err <= 2e-2 * max(scale, 1.0):
                raise RuntimeError(f"combined backward differs from the "
                                   f"split one: {err} (scale {scale})")
        ms_split = bench_variant(qkv, args.heads, s, False, args.iters,
                                 device)
        if not can_combine:
            print(f"fwd+bwd per call: split {ms_split:.3f} ms   (combined "
                  f"skipped: S_pad {s_pad} > {fam._COMBINED_MAX_SPAD})",
                  file=sys.stderr)
            out = {"metric": "flash_bwd_split_ms", "split_ms": ms_split}
            print(json.dumps(out))
            return out
        ms_comb = bench_variant(qkv, args.heads, s, True, args.iters,
                                device)
    finally:
        fam._COMBINED_BWD = routed
    print(f"fwd+bwd per call: split {ms_split:.3f} ms   combined "
          f"{ms_comb:.3f} ms   speedup {ms_split / ms_comb:.3f}x",
          file=sys.stderr)
    out = {"metric": "flash_bwd_split_vs_combined_ms", "split_ms": ms_split,
           "combined_ms": ms_comb, "speedup": ms_split / ms_comb}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
