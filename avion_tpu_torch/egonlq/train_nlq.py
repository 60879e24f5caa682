"""EgoNLQ training entry: VSLNet on extracted dual-encoder features
(``avion_tpu.egonlq.train_nlq``).

Counterpart of the reference's ``egonlq/main.py:263-407``: AdamW on a
linear schedule, span + highlight losses, R@k / IoU evaluation, with the
port's operational envelope: per-step JSONL logging (``log.jsonl``),
checkpoints at epoch boundaries with auto-resume (``core.checkpoint``)
and SIGTERM / SIGUSR1 preemption (the last boundary saved, a clean stop).

Usage::

    python -m avion_tpu_torch.egonlq.train_nlq \\
        annotations=/path/nlq_train.json val_annotations=/path/nlq_val.json \\
        feature_dir=/path/features epochs=10 [--device cpu]

It runs on CUDA unless ``--device cpu`` is given.  The model's input
widths are those of the first item's features; ``video_feature_dim`` and
``query_feature_dim`` are accepted and not read, as in the JAX entry.

The optimizer is ``torch.optim.AdamW`` (betas 0.9 / 0.999, eps 1e-8,
weight decay 0.01 on every parameter, biases and LayerNorms too), which
is ``optax.adamw``'s update.  Its rate is :func:`linear_schedule`, optax's
``linear_schedule(lr, 0, total, int(total * warmup_proportion))``: it
holds ``lr`` for the first ``int(total * warmup_proportion)`` updates and
then falls linearly over ``total`` updates.  Each step's dropout draws
from a generator seeded from (seed, step).  The model is f32 throughout.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from avion_tpu_torch.core.checkpoint import Checkpointer
from avion_tpu_torch.core.logging import MetricLogger
from avion_tpu_torch.core.meters import StepTimer
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.egonlq.nlq_dataset import (NLQFeatureDataset,
                                                parse_nlq_annotations)
from avion_tpu_torch.egonlq.nlq_eval import evaluate_nlq
from avion_tpu_torch.egonlq.vslnet import (VSLNet, extract_top_spans,
                                           vslnet_loss)
from avion_tpu_torch.parallel import launch
from avion_tpu_torch.parallel.launch import (device_from_argv,
                                             install_preemption_handler,
                                             setup_host)
from avion_tpu_torch.train.steps import step_seed


@dataclass
class NLQConfig:
    annotations: str = ""
    val_annotations: str = ""
    feature_dir: str = ""
    val_feature_dir: str = ""
    output_dir: str = "./nlq_out"
    dim: int = 128
    num_heads: int = 8
    max_pos_len: int = 128
    video_feature_dim: int = 768
    query_feature_dim: int = 512
    drop_rate: float = 0.2
    variant: str = "full"  # "full" (CQAttention) | "small" (VSLNet_small)
    highlight_weight: float = 5.0
    lr: float = 1e-3
    epochs: int = 10
    batch_size: int = 32
    warmup_proportion: float = 0.0
    seed: int = 0
    print_freq: int = 10


def parse_config(argv) -> NLQConfig:
    """``key=value`` tokens over :class:`NLQConfig`'s defaults."""
    cfg = NLQConfig()
    for tok in argv:
        k, v = tok.split("=", 1)
        t = type(getattr(cfg, k))
        setattr(cfg, k, t(v) if t is not bool else v.lower() == "true")
    return cfg


def _collate(items):
    out = {}
    maxq = max(it["query"].shape[0] for it in items)
    for it in items:
        q = it["query"]
        if q.shape[0] < maxq:
            pad = np.zeros((maxq - q.shape[0], q.shape[1]), np.float32)
            it["query"] = np.concatenate([q, pad])
            it["q_mask"] = np.concatenate(
                [it["q_mask"], np.zeros(maxq - len(it["q_mask"]), np.float32)])
    for k in items[0]:
        out[k] = np.stack([it[k] for it in items])
    return out


def to_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def build_model(cfg: NLQConfig, video_dim: int, query_dim: int) -> VSLNet:
    return VSLNet(video_dim, query_dim, dim=cfg.dim, num_heads=cfg.num_heads,
                  max_pos_len=cfg.max_pos_len, drop_rate=cfg.drop_rate,
                  use_cq_attention=(cfg.variant != "small"))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int,
                    transition_begin: int = 0) -> Callable[[int], float]:
    """``optax.linear_schedule``: ``init_value`` for the first
    ``transition_begin`` counts, then a line to ``end_value`` over
    ``transition_steps`` counts, held there."""
    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return init_value
        done = min(max(count - transition_begin, 0), transition_steps)
        frac = 1.0 - done / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def build_optimizer(model: torch.nn.Module,
                    lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=0.01)``: every parameter decays."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01)


def _updates(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has applied (its moments' step count)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0


def make_train_step(model: VSLNet, optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float],
                    highlight_weight: float = 5.0, seed: int = 0):
    """``step(batch, index) -> metrics``: the loss and its parts on one
    batch of device tensors (dropout drawn from a generator seeded from
    (``seed``, ``index``)), then one AdamW update at ``schedule`` of the
    optimizer's update count."""
    device = next(model.parameters()).device

    def step(batch: Dict[str, torch.Tensor], index: int) -> dict:
        generator = torch.Generator(device).manual_seed(
            step_seed(seed, index))
        model.train()
        h, s, e = model(batch["video"], batch["v_mask"], batch["query"],
                        batch["q_mask"], False, generator)
        loss, aux = vslnet_loss(h, s, e, batch, highlight_weight)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = schedule(_updates(optimizer))
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in aux.items()}}

    return step


def main(argv=None) -> dict:
    """Train, evaluate after each epoch when ``val_annotations`` is set,
    and return {"model", "steps" (taken by this call), "step", "val"}."""
    argv, device = device_from_argv(sys.argv[1:] if argv is None else argv)
    cfg = parse_config(argv)
    os.makedirs(cfg.output_dir, exist_ok=True)
    _, device = setup_host(cfg.seed, device)

    train_samples = parse_nlq_annotations(cfg.annotations)
    train_ds = NLQFeatureDataset(train_samples, cfg.feature_dir,
                                 cfg.max_pos_len)
    b0 = _collate([train_ds[0]])
    model = build_model(cfg, b0["video"].shape[-1],
                        b0["query"].shape[-1]).to(device)
    model.init_weights(torch.Generator(device).manual_seed(cfg.seed))

    steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)
    total = steps_per_epoch * cfg.epochs
    schedule = linear_schedule(cfg.lr, 0.0, total,
                               int(total * cfg.warmup_proportion))
    optimizer = build_optimizer(model, cfg.lr)
    step = make_train_step(model, optimizer, schedule, cfg.highlight_weight,
                           cfg.seed)

    logger = MetricLogger(cfg.output_dir)
    ckpt = Checkpointer(os.path.join(cfg.output_dir, "ckpt"))
    state = TrainState.create(model, optimizer)
    restored, extra = ckpt.restore(state)
    start_epoch = 0
    if restored is not None:
        start_epoch = int((extra or {}).get("epoch", -1)) + 1
        print(f"[nlq] resumed from epoch {start_epoch}")
    install_preemption_handler()

    def save(epoch):
        s = (epoch + 1) * steps_per_epoch
        if ckpt.latest_step() == s:  # preempt right after a boundary
            return                   # save: that step already exists
        state.step = s
        ckpt.save(s, state, extra={"epoch": epoch})

    order_rng = np.random.RandomState(cfg.seed)
    for _ in range(start_epoch):
        order_rng.permutation(len(train_ds))  # keep resume order aligned
    global_step = start_epoch * steps_per_epoch
    taken = 0
    timer = StepTimer()
    marked = global_step  # windows count only post-resume steps
    stop = False
    metrics: dict = {}
    val: Optional[dict] = None
    for epoch in range(start_epoch, cfg.epochs):
        order = order_rng.permutation(len(train_ds))
        for i in range(steps_per_epoch):
            if launch.preempted():
                # the scheduler's SIGTERM: checkpoint the last epoch
                # BOUNDARY and stop (auto-resume re-runs this epoch).  In
                # the first epoch there is no boundary yet: saving the
                # mid-epoch state as one would make the resume train
                # epoch 0 twice on stepped state, so the next run starts
                # fresh.
                if epoch > 0:
                    save(epoch - 1)
                stop = True
                break
            t_fetch = time.perf_counter()
            idx = order[i * cfg.batch_size : (i + 1) * cfg.batch_size]
            batch = to_device(_collate([train_ds[int(j)] for j in idx]),
                              device)
            timer.data_time.update(time.perf_counter() - t_fetch)
            metrics = step(batch, global_step)
            global_step += 1
            taken += 1
            if (i + 1) % cfg.print_freq == 0 or i + 1 == steps_per_epoch:
                loss = float(metrics["loss"])  # waits for the step
                timer.mark_window(global_step - marked)
                marked = global_step
                logger.log(
                    {"train/loss": loss, "train/epoch": epoch,
                     **{f"train/{k}": float(v) for k, v in metrics.items()
                        if k != "loss"},
                     **{f"perf/{k}": v for k, v in timer.stats().items()}},
                    step=global_step)
        if stop:
            break
        print(f"[epoch {epoch}] loss={float(metrics['loss']):.4f}")
        if cfg.val_annotations:
            val = evaluate(cfg, model)
            print(val)
            logger.log({f"val/{k}": v for k, v in val.items()},
                       step=global_step)
        save(epoch)
    logger.finish()
    return {"model": model, "steps": taken, "step": global_step, "val": val}


@torch.inference_mode()
def evaluate(cfg: NLQConfig, model: VSLNet) -> Dict[str, float]:
    """R@1 / R@5 at IoU 0.3 / 0.5 and mIoU over ``val_annotations``: the
    top-5 spans of each query, scaled by ``duration / n_features`` (the
    end index + 1)."""
    device = next(model.parameters()).device
    val_samples = parse_nlq_annotations(cfg.val_annotations)
    val_ds = NLQFeatureDataset(
        val_samples, cfg.val_feature_dir or cfg.feature_dir, cfg.max_pos_len)
    preds, gts = [], []
    for i in range(0, len(val_ds), cfg.batch_size):
        items = [val_ds[j] for j in range(i, min(i + cfg.batch_size,
                                                 len(val_ds)))]
        batch = to_device(_collate(items), device)
        _, s, e = model(batch["video"], batch["v_mask"], batch["query"],
                        batch["q_mask"], True)
        si, ei = (t.cpu().numpy() for t in extract_top_spans(s, e, k=5))
        for b, it in enumerate(items):
            scale = float(it["duration"]) / max(int(it["n_features"]), 1)
            preds.append(np.stack([si[b] * scale, (ei[b] + 1) * scale],
                                  axis=1))
            s_ = val_samples[i + b]
            gts.append((s_["gt_start"], s_["gt_end"]))
    return evaluate_nlq(preds, gts)


if __name__ == "__main__":
    main()
