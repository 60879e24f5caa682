"""Narrator generation throughput (``avion_tpu.tools.bench_narrator``).

Measures clips/s of LaViLa-narrator-style caption generation, the offline
stage that writes pseudo-narration training pkls
(``second_party/lavilla_narrator/main.py``; the reference gives no
throughput).  Reports KV-cached decoding (``GatedGPT2LMHead.decode_one``
over ``precompute_cross``) or, with ``--no-cache``, full-prefix decoding
(the whole prefix through the model at every token), greedy, on random
weights drawn from a seed and pre-cast to bf16 as the captioners store
them (``eval.runners.cast_inference_params``).

The default decoder is GPT-2-medium scale (width 1024, 24 layers, 16
heads) over 256 visual tokens; ``--xl`` takes the GPT-2-XL narrator's
geometry (width 1600, 48 layers, 25 heads).  The gated GPT-2's attention
is plain PyTorch, as the JAX decoder's is: this tool launches none of the
flash kernels.  Time is the host clock around ``iters`` generations
between two ``torch.cuda.synchronize()``; the card's name and power limit
go to stderr.

Usage: python -m avion_tpu_torch.tools.bench_narrator [--batch 16]
    [--max-len 77] [--samples 3] [--no-cache] [--xl] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from avion_tpu_torch.core.profiling import card_line
from avion_tpu_torch.parallel.launch import resolve_device

GEOMETRIES = {False: (1024, 24, 16), True: (1600, 48, 25)}  # by --xl


def bench(batch: int, max_len: int, use_cache: bool, xl: bool,
          iters: int = 3, device="cuda"):
    """(clips/s, tokens/s, seconds a generation) of the decoder
    :data:`GEOMETRIES` gives ``xl``."""
    from avion_tpu_torch.eval.runners import cast_inference_params
    from avion_tpu_torch.models.gpt2_gated import (GatedGPT2LMHead,
                                                   make_decode_cache)

    device = torch.device(device)
    w, layers, heads = GEOMETRIES[xl]
    with torch.device(device):
        dec = GatedGPT2LMHead(vocab_size=50257, max_positions=128, width=w,
                              layers=layers, heads=heads, cross_freq=3,
                              dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    dec.init_weights(gen)
    cast_inference_params(dec).eval()
    enc = torch.randn(batch, 256, w, generator=gen, device=device,
                      dtype=torch.bfloat16)

    def start():
        toks = torch.zeros(batch, max_len, dtype=torch.long, device=device)
        toks[:, 0] = 11
        return toks

    @torch.no_grad()
    def gen_cached():
        cross = dec.precompute_cross(enc)
        kv = make_decode_cache(layers, batch, max_len, w, torch.bfloat16,
                               device)
        toks = start()
        for i in range(1, max_len):
            logit, kv = dec.decode_one(toks[:, i - 1:i], i - 1, kv, cross)
            toks[:, i] = logit.argmax(-1)
        return toks

    @torch.no_grad()
    def gen_full():
        toks = start()
        for i in range(1, max_len):
            logits = dec(toks, enc)
            toks[:, i] = logits[:, i - 1].argmax(-1)
        return toks

    f = gen_cached if use_cache else gen_full
    f().cpu()  # warm up; the copy waits for the device
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f()
    out.cpu()
    dt = (time.perf_counter() - t0) / iters
    return batch / dt, batch * max_len / dt, dt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=77)
    ap.add_argument("--samples", type=int, default=3,
                    help="nucleus samples per clip (scales reported clips/s)")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--xl", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(card_line(device), file=sys.stderr)
    cps, tps, dt = bench(args.batch, args.max_len, not args.no_cache,
                         args.xl, device=device)
    tag = "xl" if args.xl else "med"
    out = {"metric": f"narrator_clips_per_sec_{tag}"
                     f"{'' if not args.no_cache else '_nocache'}",
           "value": cps / args.samples, "unit": "clips/s/chip",
           "tokens_per_sec": tps, "batch_s": dt,
           "samples_per_clip": args.samples, "kv_cache": not args.no_cache}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
