"""Attention head-dim measurement: 12 x 64 against 6 x 128 at equal FLOPs
(``avion_tpu.tools.mxu_roofline``; the name is kept so a reader finds the
counterpart, though this card has no MXU).

Both geometries do the same attention FLOPs at width 768; what differs is
how the kernels tile them: a 64-wide head gives each score product half
the depth of a 128-wide one, and twice as many heads to walk.  This tool
times the port's flash kernels on the card at training scale (b 256,
s 785, w 768) for both head dims (``flash_attention.HEAD_DIMS``): the
forward alone (``flash_fwd``, the inference kernel) and the forward plus
backward (``flash_fwd_lse`` and the backward route the dispatch rule
picks), and prints one JSON line.  Beside each time it puts the least
time the card could take for the same work (``core.flops.
attention_bound``: the FLOPs at 989 TFLOP/s against the bytes at 3.35
TB/s, each input read once and each output written once) and the time of
PyTorch's ``scaled_dot_product_attention`` on the same inputs, a
yardstick that no path of the port calls.  Times are CUDA events; the
card's name and power limit go to stderr.

Usage::  python -m avion_tpu_torch.tools.mxu_roofline [--iters 10]
             [--batch 256] [--seq 785] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from avion_tpu_torch.core.flops import attention_bound, attn_flops
from avion_tpu_torch.core.profiling import card_line, device_ms
from avion_tpu_torch.ops import flash_attention as fa
from avion_tpu_torch.parallel.launch import resolve_device

WIDTH = 768


def bounds(b: int, s: int, h: int, d: int) -> dict:
    """The least ms of the forward (qkv read, out written) and of the
    forward plus backward (qkv and the output's gradient read, out and
    qkv's gradient written; 2 + 5 products)."""
    fwd, fwd_by = attention_bound(b, s, h, d, False, products=2, tensors=4)
    both, both_by = attention_bound(b, s, h, d, False, products=7,
                                    tensors=8)
    return {"fwd_bound_ms": fwd, "fwd_bound_by": fwd_by,
            "fwdbwd_bound_ms": both, "fwdbwd_bound_by": both_by}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--seq", type=int, default=785)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(card_line(device), file=sys.stderr)

    b, seq, w = args.batch, args.seq, WIDTH
    res = {}
    for d in fa.HEAD_DIMS:
        h = w // d
        gen = torch.Generator(device=device).manual_seed(1)
        q = torch.randn(b, seq, w, generator=gen, device=device,
                        dtype=torch.bfloat16)
        qkv = torch.cat([q, q, q], -1)  # attention(q, q, q)

        def fwd():
            with torch.no_grad():
                return fa.flash_attention_fused_qkv(qkv, h, seq)

        def fwdbwd():
            x = qkv.detach().requires_grad_()
            (fa.flash_attention_fused_qkv(x, h, seq).float() ** 2).sum() \
                .backward()
            return x.grad

        heads_first = q.view(b, seq, h, d).transpose(1, 2)

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    heads_first, heads_first, heads_first)

        def sdpa_fwdbwd():
            x = heads_first.detach().requires_grad_()
            (F.scaled_dot_product_attention(x, x, x).float() ** 2).sum() \
                .backward()
            return x.grad

        t_fwd = device_ms(fwd, device, args.iters) / 1e3
        t_both = device_ms(fwdbwd, device, args.iters) / 1e3
        res[f"{h}x{d}"] = {
            "fwd_ms": t_fwd * 1e3, "fwdbwd_ms": t_both * 1e3,
            "fwd_tflops": attn_flops(b, seq, h, d, False, 2) / t_fwd / 1e12,
            **bounds(b, seq, h, d),
            "sdpa_fwd_ms": device_ms(sdpa_fwd, device, args.iters),
            "sdpa_fwdbwd_ms": device_ms(sdpa_fwdbwd, device, args.iters)}
        del q, qkv, heads_first
    out = {"metric": "flash_attention_headdim_floor",
           "shape": f"b{b} s{seq} w{w}", **res,
           "fwd_12x64_over_6x128":
               res["12x64"]["fwd_ms"] / res["6x128"]["fwd_ms"],
           "fwdbwd_12x64_over_6x128":
               res["12x64"]["fwdbwd_ms"] / res["6x128"]["fwdbwd_ms"]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
