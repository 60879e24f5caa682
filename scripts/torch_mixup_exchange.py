"""Time mixup / cutmix's partner exchange over a batch group: each rank
sends its rows of the global batch to rank n - 1 - r and receives that
rank's (``avion_tpu_torch.train.augment_device.global_flip``), at the
finetune recipes' per-card batch of 16-frame 224 px bf16 clips.  Also
times the same rows reversed on the card (the one-rank case) and the whole
``mixup_cutmix`` with and without the group.

    torchrun --nproc_per_node=4 scripts/torch_mixup_exchange.py [--batch 64]
    torchrun --nproc_per_node=4 scripts/torch_mixup_exchange.py \\
        --device cpu --batch 2 --frames 2 --size 32     # gloo, a rehearsal

Rank 0 prints one JSON line: the card's name and power limit, the world,
the bytes each rank sends, and each time as the mean of ``--iters`` calls
(CUDA events on the card, the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

# the repository's root, for a run from a checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from avion_tpu_torch.parallel.launch import host  # noqa: E402
from avion_tpu_torch.train.augment_device import (global_flip,  # noqa: E402
                                                  mixup_cutmix)


def timed_ms(fn, device: torch.device, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    dist.barrier()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "no nvidia-smi"


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    with host(0, torch.device(args.device)) as device:
        world, rank = dist.get_world_size(), dist.get_rank()
        gen = torch.Generator(device=device).manual_seed(rank)
        video = torch.randn(args.batch, args.frames, args.size, args.size, 3,
                            generator=gen, device=device).to(torch.bfloat16)
        labels = torch.randint(0, 3806, (args.batch,), generator=gen,
                               device=device)
        group = dist.group.WORLD

        def mix(g):
            return mixup_cutmix(torch.Generator(device=device).manual_seed(0),
                                video, labels, 3806, group=g)

        res = {
            "card": card_line() if device.type == "cuda" else "cpu",
            "world": world, "rows_a_rank": args.batch,
            "clip": [args.frames, args.size, args.size, 3],
            "bytes_sent_a_rank": video.numel() * video.element_size()
            + labels.numel() * labels.element_size(),
            "exchange_ms": timed_ms(lambda: global_flip([video, labels],
                                                        group),
                                    device, args.iters),
            "local_flip_ms": timed_ms(lambda: [video.flip(0), labels.flip(0)],
                                      device, args.iters),
            "mixup_over_group_ms": timed_ms(lambda: mix(group), device,
                                            args.iters),
            "mixup_one_rank_ms": timed_ms(lambda: mix(None), device,
                                          args.iters)}
        res["exchange_gb_per_s"] = (res["bytes_sent_a_rank"]
                                    / res["exchange_ms"] / 1e6)
        if rank == 0:
            print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
