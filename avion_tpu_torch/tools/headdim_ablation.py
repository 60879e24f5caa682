"""Head-split quality ablation: 12 x 64 against 6 x 128 at a fixed width
(``avion_tpu.tools.headdim_ablation``).

The ``_H128`` geometries (``models/registry.py``: ``CLIP_VITB16_H128``
and friends) keep the reference's widths, depths and parameters and halve
the head count, so each attention product contracts over 128 lanes.  Head
count at a fixed width is a (mild) capacity knob, so a speed claim for
them needs a quality measurement to stand on.  This tool runs the
controlled comparison: both arms train from the SAME initial parameters
(the fused qkv / out matrices carry no head structure, so the two models'
parameters have one shape) on the SAME synthetic concept-association
batches (K concepts, each a noisy video prototype paired with a fixed
caption), and are scored on held-out retrieval (fresh noisy clips of each
concept, top-1 over the K captions).  The only difference between the
arms is the visual tower's head split; on CUDA both arms' attention runs
the flash kernels, at head dims 64 and 128 (``flash_attention.HEAD_DIMS``).

The shared initial state is drawn by the port's seeded initializers
(``CLIP.init_weights``), not flax's; :func:`run` also takes one
(``init_state``, e.g. ``models.pt_import.params_from_jax`` of a flax
tree).  The train step and optimizer are the port's
(``train.steps.make_clip_train_step``, AdamW).

Usage::

    python -m avion_tpu_torch.tools.headdim_ablation \\
        --steps 200 --batch 64 --concepts 32 [--device cuda|cpu]

Prints one JSON line per arm and a combined line; the card's name and
power limit go to stderr.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch


def synth_concepts(rng: np.random.RandomState, n_concepts: int,
                   frames: int, size: int, block: int = 8,
                   overlap: float = 0.0):
    """Per-concept video prototypes: random block-constant uint8
    patterns (block-constant so the signal survives patchify at any
    patch size) + per-concept captions.

    ``overlap`` in [0, 1) mixes a SHARED base pattern into every
    prototype, shrinking the between-concept signal, which pulls held-out
    top-1 off its ceiling so the A/B can tell the arms apart."""
    g = size // block
    blocks = rng.randint(0, 256, (n_concepts, frames, g, g, 3))
    if overlap > 0.0:
        shared = rng.randint(0, 256, (1, frames, g, g, 3))
        blocks = (overlap * shared
                  + (1.0 - overlap) * blocks).round().astype(np.int64)
    protos = blocks.astype(np.uint8).repeat(block, axis=2).repeat(block,
                                                                  axis=3)
    captions = [f"a photo of concept number {i} doing action {i}"
                for i in range(n_concepts)]
    return protos, captions


def noisy_clip(rng: np.random.RandomState, proto: np.ndarray,
               sigma: float) -> np.ndarray:
    noise = rng.normal(0.0, sigma, proto.shape)
    return np.clip(proto.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def make_batches(seed: int, protos: np.ndarray, texts: np.ndarray,
                 steps: int, batch: int, sigma: float) -> List[Dict]:
    """The shared batch schedule, identical for every arm."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        if batch <= len(protos):
            # without replacement: duplicate captions in a batch are
            # false negatives under InfoNCE and cap clip_acc
            idx = rng.choice(len(protos), batch, replace=False)
        else:
            idx = rng.randint(0, len(protos), batch)
        video = np.stack([noisy_clip(rng, protos[i], sigma) for i in idx])
        out.append({"video": video, "text": texts[idx]})
    return out


def build_model(heads: int, *, width: int, layers: int, frames: int,
                size: int, patch: int):
    """The arm's bf16 CLIP (the JAX tool's geometry) on the meta device."""
    from avion_tpu_torch.models.clip import CLIP

    with torch.device("meta"):
        return CLIP(
            embed_dim=min(width, 512), image_size=size, patch_size=patch,
            num_frames=frames, vision_width=width, vision_layers=layers,
            vision_heads=heads, text_width=min(width, 512),
            text_heads=8 if width >= 512 else 2,
            text_layers=min(layers, 12), dtype=torch.bfloat16)


def run_arm(heads: int, *, init_state, batches, protos, texts,
            heldout_per_concept: int, sigma: float, lr: float,
            width: int, layers: int, frames: int, size: int,
            patch: int, eval_sigma=None, device="cuda") -> Dict:
    """Train one arm from ``init_state`` (a state dict) on ``batches`` and
    score held-out retrieval; returns the arm's record.  ``losses`` holds
    the loss of every step."""
    from avion_tpu_torch.core.config import OptimConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.data.transforms import (OPENAI_MEAN, OPENAI_STD,
                                                 normalize_video)
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.train.steps import make_clip_train_step

    device = torch.device(device)
    steps = len(batches)
    model = build_model(heads, width=width, layers=layers, frames=frames,
                        size=size, patch=patch).to_empty(device=device)
    model.load_state_dict(init_state, strict=True)  # a copy for this arm
    cfg = OptimConfig(optimizer="adamw", lr=lr, lr_start=lr / 10,
                      lr_end=lr / 10, warmup_epochs=0.1, epochs=1,
                      wd=0.01, grad_clip_norm=1.0)
    optimizer, _ = build_optimizer(cfg, model, steps)
    state = TrainState.create(model, optimizer)
    step = make_clip_train_step(model)

    every, losses, accs = [], [], []
    for i, b in enumerate(batches):
        state, metrics = step(state, {
            "video": torch.from_numpy(b["video"]).to(device),
            "text": torch.from_numpy(b["text"]).to(device)})
        every.append(float(metrics["loss"]))
        if i >= steps - max(1, steps // 5) or i == 0:
            losses.append(every[-1])
            accs.append(float(metrics["clip_acc"]))

    # held-out retrieval: fresh noisy clips per concept against the K
    # concept captions.  eval_sigma (a scalar or a list) above sigma probes
    # the margin of the learned representations along a noise curve
    k = len(protos)
    if eval_sigma is None:
        eval_sigmas = [sigma]
    elif np.isscalar(eval_sigma):
        eval_sigmas = [float(eval_sigma)]
    else:
        eval_sigmas = [float(s) for s in eval_sigma]
    labels = np.repeat(np.arange(k), heldout_per_concept)
    model.eval()
    with torch.no_grad():
        tvecs = model.encode_text(torch.from_numpy(texts).to(device)) \
            .float().cpu().numpy()
        bs = max(1, len(batches[0]["video"]))
        top1_by_sigma = {}
        for es in eval_sigmas:
            erng = np.random.RandomState(999)  # same clips across arms
            eval_videos = np.stack([
                noisy_clip(erng, protos[c], es)
                for c in range(k) for _ in range(heldout_per_concept)])
            vecs = []
            for i in range(0, len(eval_videos), bs):
                v = normalize_video(
                    torch.from_numpy(eval_videos[i:i + bs]).to(device),
                    OPENAI_MEAN, OPENAI_STD, torch.bfloat16)
                vecs.append(model.encode_image(v).float().cpu().numpy())
            sims = np.concatenate(vecs) @ tvecs.T
            top1_by_sigma[es] = float((sims.argmax(-1) == labels).mean())
    top1 = top1_by_sigma[eval_sigmas[0]]

    # tail-window mean; at steps=1 only the step-0 sample exists
    tail_losses = losses[1:] if len(losses) > 1 else losses[-1:]
    tail_accs = accs[1:] if len(accs) > 1 else accs[-1:]
    out = {
        "heads": heads,
        "head_dim": width // heads,
        "first_loss": losses[0],
        "final_loss": float(np.mean(tail_losses)),
        "final_clip_acc": float(np.mean(tail_accs)),
        "heldout_top1": top1,
        "losses": every,
    }
    if len(eval_sigmas) > 1:
        out["top1_by_sigma"] = {f"{s:g}": v for s, v in top1_by_sigma.items()}
    return out


def run(steps=200, batch=64, concepts=32, width=768, layers=6, frames=4,
        size=96, patch=16, sigma=25.0, lr=1e-4, heads=(12, 6),
        heldout_per_concept=4, seed=0, overlap=0.0, eval_sigma=None,
        device="cuda", init_state: Optional[dict] = None) -> Dict:
    """The A/B at one seed: the concepts, captions and batch schedule from
    ``seed``; one initial state for every arm (``init_state``, else the
    port's initializers seeded with ``seed``)."""
    from avion_tpu_torch.data.tokenizer import tokenize

    rng = np.random.RandomState(seed)
    protos, captions = synth_concepts(rng, concepts, frames, size,
                                      overlap=overlap)
    texts = np.stack([tokenize(c) for c in captions]).astype(np.int32)
    batches = make_batches(seed + 1, protos, texts, steps, batch, sigma)

    # one init shared by every arm: the parameters do not depend on the
    # head count (fused qkv), so the arms differ only in the split
    if init_state is None:
        ref = build_model(heads[0], width=width, layers=layers,
                          frames=frames, size=size,
                          patch=patch).to_empty(device="cpu")
        ref.init_weights(torch.Generator().manual_seed(seed))
        init_state = ref.state_dict()

    arms = []
    for h in heads:
        if width % h:
            raise ValueError(f"{h} heads do not divide width {width}")
        r = run_arm(h, init_state=init_state, batches=batches,
                    protos=protos, texts=texts,
                    heldout_per_concept=heldout_per_concept, sigma=sigma,
                    lr=lr, width=width, layers=layers, frames=frames,
                    size=size, patch=patch, eval_sigma=eval_sigma,
                    device=device)
        print(json.dumps({"arm": r}))
        arms.append(r)

    base = arms[0]
    summary = {"metric": "headdim_ablation", "seed": seed, "arms": arms}
    if len(arms) > 1:
        summary["top1_delta_vs_first"] = [
            a["heldout_top1"] - base["heldout_top1"] for a in arms[1:]]
        summary["loss_delta_vs_first"] = [
            a["final_loss"] - base["final_loss"] for a in arms[1:]]
        if "top1_by_sigma" in base:
            summary["top1_delta_by_sigma_vs_first"] = [
                {s: a["top1_by_sigma"][s] - base["top1_by_sigma"][s]
                 for s in base["top1_by_sigma"]}
                for a in arms[1:]]
    print(json.dumps(summary))
    return summary


def run_multi(seeds, **kw) -> Dict:
    """The A/B over several seeds (init, batch schedule and prototypes all
    re-drawn per seed): the per-seed top-1 deltas give the noise scale the
    single-run delta must be judged against."""
    runs = [run(seed=s, **kw) for s in seeds]
    summary = {"metric": "headdim_ablation_multi", "seeds": list(seeds),
               "runs": runs}
    if all("top1_delta_vs_first" in r for r in runs) and len(runs) > 1:
        deltas = np.array([r["top1_delta_vs_first"] for r in runs])
        accs = np.array([[a["heldout_top1"] for a in r["arms"]]
                         for r in runs])
        summary["top1_by_arm_mean"] = accs.mean(0).tolist()
        summary["top1_delta_mean"] = deltas.mean(0).tolist()
        summary["top1_delta_std"] = deltas.std(0).tolist()
        if all("top1_by_sigma" in a for r in runs for a in r["arms"]):
            sig = list(runs[0]["arms"][0]["top1_by_sigma"])
            # [seed, arm, sigma]
            cube = np.array([[[a["top1_by_sigma"][s] for s in sig]
                              for a in r["arms"]] for r in runs])
            summary["top1_by_sigma_arm_mean"] = [
                {s: float(v) for s, v in zip(sig, row)}
                for row in cube.mean(0)]
            d = cube[:, 1:] - cube[:, :1]  # per-seed deltas vs arm 0
            summary["top1_delta_by_sigma_mean"] = [
                {s: float(v) for s, v in zip(sig, row)}
                for row in d.mean(0)]
            summary["top1_delta_by_sigma_std"] = [
                {s: float(v) for s, v in zip(sig, row)}
                for row in d.std(0)]
    print(json.dumps(summary))
    return summary


def main(argv=None) -> Dict:
    import argparse

    from avion_tpu_torch.core.profiling import card_line
    from avion_tpu_torch.parallel.launch import resolve_device

    p = argparse.ArgumentParser(
        description="12x64 vs 6x128 head-split quality ablation")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--concepts", type=int, default=32)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--layers", type=int, default=6)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--patch", type=int, default=16)
    p.add_argument("--sigma", type=float, default=25.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--heads", type=int, nargs="+", default=[12, 6])
    p.add_argument("--heldout", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="run the full A/B once per seed and report "
                        "delta mean/std across seeds")
    p.add_argument("--overlap", type=float, default=0.0,
                   help="0..1: mix a shared base into every concept "
                        "prototype (harder, de-saturated eval)")
    p.add_argument("--eval-sigma", type=float, nargs="+", default=None,
                   help="held-out clip noise sigma(s) (default: the "
                        "train sigma); a list sweeps a noise curve")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    print(card_line(device), file=sys.stderr)
    kw = dict(steps=a.steps, batch=a.batch, concepts=a.concepts,
              width=a.width, layers=a.layers, frames=a.frames, size=a.size,
              patch=a.patch, sigma=a.sigma, lr=a.lr, heads=tuple(a.heads),
              heldout_per_concept=a.heldout, overlap=a.overlap,
              eval_sigma=a.eval_sigma, device=device)
    if a.seeds:
        return run_multi(a.seeds, **kw)
    return run(seed=a.seed, **kw)


if __name__ == "__main__":
    main()
    sys.exit(0)
