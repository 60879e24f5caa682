"""VideoMAE pretraining step throughput (``avion_tpu.tools.
bench_videomae``).

ViT-B, 16 frames, 90% tube masking: the reference's
``main_videomae_pretrain.py`` headline, 583 GPU-hours for 800 epochs over
about 240k clips on 4 A5000s, about 91 clips/s a GPU
(:data:`BASELINE_CLIPS_PER_SEC_PER_GPU`).  The step is the pretraining
entry's (``train.videomae_pretrain.build_model_and_state`` with grad
checkpointing, ``train.steps.make_videomae_train_step``, AdamW without a
clip), on seeded normalized clips and tube masks; the flash kernels run
every attention of the encoder and the decoder.  Step time is the host
clock around ``iters`` steps between two ``torch.cuda.synchronize()``.
Without a batch argument it tries 128, 64, 32 and reports the first that
fits the card's memory.  The card's name and power limit go to stderr.

Usage: python -m avion_tpu_torch.tools.bench_videomae [batch]
           [--model NAME] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from avion_tpu_torch.core.profiling import card_line
from avion_tpu_torch.parallel.launch import device_from_argv

BASELINE_CLIPS_PER_SEC_PER_GPU = 91.4  # 800 * 240k / (583 * 3600)


def bench(batch: int = 128, warmup: int = 3, iters: int = 15,
          model_name: str = "VIDEOMAE_VITB16", device="cuda") -> float:
    """Clips/s of ``iters`` steps after ``warmup``."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.data.transforms import tube_mask_batch
    from avion_tpu_torch.train.steps import make_videomae_train_step
    from avion_tpu_torch.train.videomae_pretrain import build_model_and_state

    device = torch.device(device)
    cfg = TrainConfig().apply_overrides([
        f"model.name={model_name}", "data.clip_length=16",
        f"data.batch_size={batch}", "data.mask_ratio=0.9",
        "model.use_grad_checkpointing=true", "model.use_flash_attn=true",
        "optim.optimizer=adamw", "optim.lr=1.5e-4", "optim.warmup_epochs=1",
        "optim.epochs=800", "optim.grad_clip_norm=none"])
    model, optimizer, _ = build_model_and_state(cfg, 1000, device=device)
    state = TrainState.create(model, optimizer)
    step = make_videomae_train_step(model, model.patch_size,
                                    model.tubelet_size)
    g = model.image_size // model.patch_size
    gen = torch.Generator(device=device).manual_seed(0)
    rs = np.random.RandomState(0)
    data = {"video": torch.randn(batch, 16, model.image_size,
                                 model.image_size, 3, generator=gen,
                                 device=device, dtype=torch.bfloat16),
            "mask": torch.from_numpy(tube_mask_batch(
                rs, batch, 16 // model.tubelet_size, g, g,
                model.mask_ratio)).to(device)}
    for _ in range(warmup):
        state, m = step(state, data)
    float(m["loss"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, data)
    float(m["loss"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return batch / ((time.perf_counter() - t0) / iters)


def main(argv=None) -> dict:
    argv, device = device_from_argv(argv if argv is not None
                                    else sys.argv[1:])
    model_name = "VIDEOMAE_VITB16"
    if "--model" in argv:
        i = argv.index("--model")
        if i + 1 >= len(argv):
            raise SystemExit("usage: [batch] [--model NAME]")
        model_name = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    print(card_line(device), file=sys.stderr)
    batches = [int(argv[0])] if argv else [128, 64, 32]
    tag = model_name.lower()
    for b in batches:
        try:
            r = bench(b, model_name=model_name, device=device)
        except torch.cuda.OutOfMemoryError:
            print(f"batch {b} failed; trying smaller", file=sys.stderr)
            torch.cuda.empty_cache()
            continue
        out = {"metric": f"clips_per_sec_per_chip_{tag}_b{b}",
               "value": r, "unit": "clips/s/chip",
               "vs_baseline": r / BASELINE_CLIPS_PER_SEC_PER_GPU}
        print(json.dumps(out))
        return out
    raise RuntimeError(f"no batch of {batches} fits the card")


if __name__ == "__main__":
    main()
