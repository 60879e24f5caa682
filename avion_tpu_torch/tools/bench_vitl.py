"""CLIP ViT-L/14 pretraining step throughput (``avion_tpu.tools.
bench_vitl``): a second model family beside ViT-B.

Reference configuration: ViT-L/14, 4-frame clips, batch 112 a GPU on
A5000s (``docs/MODEL_ZOO.md:54``); the zoo row does not pin the epochs,
so the tool reports clips/s on this card and the share of the H100's
dense bf16 peak (``core.flops.H100_PEAK_FLOPS``) that the model FLOPs
reach, which compares across hardware.

The step is the pretraining entry's (``train.pretrain_clip.
build_model_and_state`` with grad checkpointing, ``train.steps.
make_clip_train_step``, AdamW), on seeded normalized clips at the model's
image size and random token ids; the flash kernels run every attention.
Step time is the host clock around ``iters`` steps between two
``torch.cuda.synchronize()``.  Without a batch argument it tries 96, 64,
48, 32 and reports the first that fits the card's memory.  The card's
name and power limit go to stderr.

Usage: python -m avion_tpu_torch.tools.bench_vitl [batch] [--model NAME]
           [--device cuda|cpu]
"""

from __future__ import annotations

import json
import sys
import time

import torch

from avion_tpu_torch.core.flops import H100_PEAK_FLOPS, clip_fwd_flops
from avion_tpu_torch.core.profiling import card_line
from avion_tpu_torch.parallel.launch import device_from_argv


def model_fwd_flops():
    """ViT-L/14 geometry through the shared helper."""
    return clip_fwd_flops(clip_len=4, image=224, patch=14, vw=1024, vl=24,
                          tw=768, tl=12, ctx=77)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(batch: int, warmup: int = 3, iters: int = 10,
          model_name: str = "CLIP_VITL14", device="cuda"):
    """(clips/s, seconds a step) of ``iters`` steps after ``warmup``."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.train.pretrain_clip import build_model_and_state
    from avion_tpu_torch.train.steps import make_clip_train_step

    device = torch.device(device)
    cfg = TrainConfig().apply_overrides([
        f"model.name={model_name}", "data.clip_length=4",
        f"data.batch_size={batch}", "model.use_grad_checkpointing=true",
        "model.use_flash_attn=true", "model.project_embed_dim=768",
        "optim.optimizer=adamw", "optim.lr=3e-5", "optim.warmup_epochs=1",
        "optim.epochs=5", "optim.grad_clip_norm=1.0"])
    model, optimizer, _ = build_model_and_state(cfg, 1000, device=device)
    state = TrainState.create(model, optimizer)
    step = make_clip_train_step(model)
    gen = torch.Generator(device=device).manual_seed(0)
    size = model.image_size
    data = {"video": torch.randn(batch, 4, size, size, 3, generator=gen,
                                 device=device, dtype=torch.bfloat16),
            "text": torch.randint(0, 49408, (batch, 77), generator=gen,
                                  device=device, dtype=torch.int32)}
    for _ in range(warmup):
        state, m = step(state, data)
    float(m["loss"])
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, data)
    float(m["loss"])
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    return batch / dt, dt


def main(argv=None) -> dict:
    argv, device = device_from_argv(argv if argv is not None
                                    else sys.argv[1:])
    model_name = "CLIP_VITL14"
    if "--model" in argv:
        i = argv.index("--model")
        if i + 1 >= len(argv):
            raise SystemExit("usage: [batch] [--model NAME]")
        model_name = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    print(card_line(device), file=sys.stderr)
    tag = "vitl14" if model_name == "CLIP_VITL14" else model_name.lower()
    batches = [int(argv[0])] if argv else [96, 64, 48, 32]
    for b in batches:
        try:
            r, dt = bench(b, model_name=model_name, device=device)
        except torch.cuda.OutOfMemoryError:
            print(f"batch {b} failed; trying smaller", file=sys.stderr)
            torch.cuda.empty_cache()
            continue
        out = {"metric": f"clips_per_sec_per_chip_{tag}_pretrain_b{b}",
               "value": r, "unit": "clips/s/chip",
               # the card's share of its peak; no such share on the CPU
               "mfu": (r * 3 * model_fwd_flops() / H100_PEAK_FLOPS
                       if device.type == "cuda" else None),
               "step_ms": dt * 1e3}
        print(json.dumps(out))
        return out
    raise RuntimeError(f"no batch of {batches} fits the card")


if __name__ == "__main__":
    main()
