"""EK100-CLS action-recognition finetuning entry point
(``avion_tpu.train.finetune_cls``): a linear classifier on the pretrained
visual tower (``models.clip.VideoClassifier``), mixup / cutmix and label
smoothing, the learning rate scaled by batch / 128, SGD or AdamW, and the
multi-view test with verb / noun marginal accuracy.

Usage (the recipe of ``scripts/examples/finetune_cls_ek100.sh`` at one
card's share of its batch 512 over 8 cards)::

    python -m avion_tpu_torch.train.finetune_cls \
        model.name=CLIP_VITB16 model.use_grad_checkpointing=true \
        data.clip_length=16 data.batch_size=64 optim.optimizer=sgd \
        optim.lr=0.012 optim.wd=4e-5 optim.warmup_epochs=2 \
        optim.epochs=100 pretrain_model=<ckpt.pt or checkpoint dir> \
        [--device cpu]

It runs on CUDA unless ``--device cpu`` is given.  The dataset paths fall
back to EK100_VIDEO_DIR, EK100_TRAIN, EK100_VAL and EK100_ACTIONS_CSV.
The tower is built from ``model``'s widths (``image_size``,
``vision_width`` ...), not from ``model.name``, as in the JAX entry.
``pretrain_model`` is a reference-layout CLIP ``.pt`` (its visual tower,
inflated to ``data.clip_length`` frames) or a directory of this port's
checkpoints; a source without the tower's blocks raises.  A script that
calls ``main`` needs an ``if __name__ == "__main__"`` guard.

Over N ranks, one card each (gloo with ``--device cpu``), the recipe's
batch 512 over 8 cards::

    torchrun --nproc_per_node=8 -m avion_tpu_torch.train.finetune_cls \
        data.batch_size=512 mesh.data=8 ... (or mesh.data=4 mesh.fsdp=2)

``data.batch_size`` is the global batch (the learning rate scales by it),
cut into ``mesh.data * mesh.fsdp`` batch groups; ``mesh.fsdp`` shards
parameters and optimizer state (FSDP2), ``mesh.data`` replicates them
(DDP).  Mixup pairs rows across the global batch, the logged ``loss`` and
``acc1`` are means over it, each rank scores its block of the test clips,
and only rank 0 logs and writes.  ``mesh.sp`` ranks hold replicas of their
batch group's step, as in JAX; ``mesh.tensor`` cuts the blocks' heads and
MLP columns (``parallel.tensor_parallel``).
"""

from __future__ import annotations

import csv
import os
import sys
from typing import Optional

import numpy as np
import torch

from avion_tpu_torch.core.config import TrainConfig, load_dotenv
from avion_tpu_torch.data.datasets import AugmentSpec, VideoClassyDataset
from avion_tpu_torch.data.loader import DataLoader
from avion_tpu_torch.data.video_reader import default_backend
from avion_tpu_torch.eval.classification_metrics import (
    confusion_matrix, get_marginal_indexes, marginalize, mean_class_accuracy,
    topk_accuracy)
from avion_tpu_torch.eval.runners import multi_view_probs
from avion_tpu_torch.models.clip import VideoClassifier
from avion_tpu_torch.models.layers import gelu, quick_gelu
from avion_tpu_torch.models.pt_import import import_clip_pt
from avion_tpu_torch.models.vit import VisionTransformer
from avion_tpu_torch.optim.factory import (apply_batch_lr_scale,
                                           build_optimizer)
from avion_tpu_torch.parallel.launch import device_from_argv
from avion_tpu_torch.parallel.mesh import Mesh
from avion_tpu_torch.parallel.sharding import shard_model
from avion_tpu_torch.train.common import (extract_visual_params,
                                          latest_model_state, over_mesh,
                                          whole_model)
from avion_tpu_torch.train.loop import (finish_if_preempted, save_epoch,
                                        setup_run, train_one_epoch)
from avion_tpu_torch.train.steps import make_cls_train_step, prep_video
from avion_tpu_torch.train.videomae_finetune import make_mixup


def env_defaults(cfg: TrainConfig) -> TrainConfig:
    d = cfg.data
    d.dataset = "ek100_cls"
    d.root = d.root or os.environ.get("EK100_VIDEO_DIR", "")
    d.root_val = d.root_val or d.root
    d.train_metadata = d.train_metadata or os.environ.get("EK100_TRAIN", "")
    d.val_metadata = d.val_metadata or os.environ.get("EK100_VAL", "")
    d.label_map = d.label_map or os.environ.get("EK100_ACTIONS_CSV", "")
    return cfg


def load_actions(actions_csv: str):
    """EPIC-100 actions.csv -> (action label texts, (verb, noun) pairs,
    'v:n' -> action-id mapping)."""
    labels, pairs, mapping = [], [], {}
    with open(actions_csv) as f:
        reader = csv.reader(f)
        next(reader)
        for i, row in enumerate(reader):
            labels.append(row[3].replace("_", " "))
            verb, noun = int(row[1]), int(row[2])
            pairs.append((verb, noun))
            mapping[f"{verb}:{noun}"] = i
    return labels, pairs, mapping


def build_classifier(cfg: TrainConfig, num_classes: int,
                     dtype=None) -> VideoClassifier:
    """The classifier on the meta device: a visual tower of ``model``'s
    widths at ``data.clip_length`` frames (bf16 compute unless ``dtype``),
    with the model's patch dropout, DropPath and remat, and
    ``classifier_dropout`` before ``fc_cls``."""
    m = cfg.model
    with torch.device("meta"):
        visual = VisionTransformer(
            image_size=m.image_size, patch_size=m.patch_size,
            num_frames=cfg.data.clip_length, width=m.vision_width,
            layers=m.vision_layers, heads=m.vision_heads,
            act=quick_gelu if m.use_quick_gelu else gelu,
            dtype=dtype if dtype is not None else torch.bfloat16,
            patch_dropout=m.patch_dropout, remat=m.use_grad_checkpointing,
            drop_path_rate=m.drop_path_rate)
        return VideoClassifier(visual, num_classes,
                               dropout=m.classifier_dropout)


def load_visual_tower(model: VideoClassifier, path: str,
                      num_frames: int) -> None:
    """Overlay a CLIP's visual tower onto ``model.visual``: a ``.pt`` /
    ``.pth`` through ``import_clip_pt`` (which raises on a file with no
    visual block) and ``extract_visual_params``, or the newest checkpoint
    of this port under a directory (an orbax directory raises and names
    ``export_clip_to_pt``).  Keys the tower lacks are skipped and a shape
    that differs raises, as the JAX entry's merge; a source without every
    transformer block of the tower raises."""
    state = (import_clip_pt(path, num_frames=num_frames)
             if path.endswith((".pt", ".pth")) else latest_model_state(path))
    missing = model.visual.load_state_dict(extract_visual_params(state),
                                           strict=False).missing_keys
    if any(k.startswith("transformer.") for k in missing):
        raise ValueError(f"{path}: the visual tower's weights are not all "
                         f"there (missing e.g. {missing[:3]})")


def build_model_and_state(cfg: TrainConfig, num_classes: int,
                          niter_per_ep: int, device="cuda", dtype=None,
                          mesh: Optional[Mesh] = None):
    """(classifier on ``device``, optimizer, lr schedule): weights drawn on
    the CPU from ``torch.Generator().manual_seed(cfg.seed)``, then the
    pretrained tower overlaid; the optimizer with layer decay, when set,
    over ``model.vision_layers``.  The learning rate is taken as it stands
    (``main`` scales it by batch / 128 first).  A ``mesh`` with ``fsdp``
    shards the model (FSDP2) before the optimizer is built over it."""
    model = build_classifier(cfg, num_classes, dtype).to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    if cfg.pretrain_model:
        load_visual_tower(model, cfg.pretrain_model, cfg.data.clip_length)
        print(f"[init] visual tower from {cfg.pretrain_model}")
    model = model.to(device)
    if mesh is not None:
        shard_model(model, mesh)
    optimizer, schedule = build_optimizer(
        cfg.optim, model, niter_per_ep, num_layers=cfg.model.vision_layers)
    return model, optimizer, schedule


def main(argv=None) -> dict:
    """Finetune (and test); returns ``{"steps", "step", "epochs", "eval":
    the test metrics by epoch, "decode_backend", "transfers"}``.  Under
    torchrun every rank runs it; a process group it joined is left when it
    returns."""
    load_dotenv()
    argv, device = device_from_argv(
        argv if argv is not None else sys.argv[1:])
    cfg = env_defaults(TrainConfig().apply_overrides(argv))
    return over_mesh(cfg, device, _train)


def _train(cfg: TrainConfig, device: torch.device, mesh: Mesh) -> dict:
    d = cfg.data
    labels, pairs, mapping = load_actions(d.label_map)
    num_classes = len(labels)
    # lr x batch / 128 (main_lavila_finetune_cls.py:367-370)
    apply_batch_lr_scale(cfg.optim, d.batch_size, default_base=128)
    train_ds = VideoClassyDataset(
        "ek100_cls", d.root, d.train_metadata, is_training=True,
        clip_length=d.clip_length, chunk_len=d.chunk_len,
        threads=d.decode_threads, decode_fast=d.decode_fast,
        label_mapping=mapping, num_sample=d.repeated_aug,
        augment=AugmentSpec(crop_size=d.crop_size, mode="rrc",
                            scale_min=d.scale_min, scale_max=d.scale_max))
    train_loader = DataLoader(train_ds, d.batch_size, shuffle=True,
                              drop_last=True, num_workers=d.num_workers,
                              seed=cfg.seed, process_index=mesh.batch_index,
                              process_count=mesh.n_batch_shards)
    print(f"[data] {len(train_ds)} clips, decode backend "
          f"{default_backend()}, {d.num_workers} workers, batch group "
          f"{mesh.batch_index} of {mesh.n_batch_shards}")
    niter = max(1, len(train_loader)) * max(1, d.echo_factor)
    model, optimizer, _ = build_model_and_state(cfg, num_classes, niter,
                                                device=device, mesh=mesh)
    step_fn = make_cls_train_step(model, label_smoothing=cfg.smoothing,
                                  mixup_fn=make_mixup(cfg, num_classes),
                                  seed=cfg.seed + 1)
    run = setup_run(cfg, model, optimizer, step_fn, mesh=mesh)
    start_step, best, epochs, evals = run.state.step, -1.0, [], {}

    def test() -> dict:
        return validate(cfg, whole_model(
            model, lambda: build_classifier(cfg, num_classes)), pairs,
            mesh.batch_group)

    try:
        for epoch in range(run.start_epoch, cfg.optim.epochs):
            if cfg.evaluate:
                break
            train_loader.set_epoch(epoch)
            metrics = train_one_epoch(run, train_loader, epoch)
            epochs.append(metrics)
            print(f"[epoch {epoch}] " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
            if finish_if_preempted(run, epoch, metrics):
                break
            eval_metrics = {}
            if cfg.eval_freq and (epoch + 1) % cfg.eval_freq == 0:
                eval_metrics = test()
                if eval_metrics:
                    evals[epoch] = eval_metrics
                    print(f"[epoch {epoch} test] {eval_metrics}")
                    run.logger.log(eval_metrics, step=run.state.step)
            score = eval_metrics.get("acc1", metrics.get("acc1", 0))
            is_best = score > best
            best = max(best, score)
            save_epoch(run, epoch, {**metrics, **eval_metrics}, is_best)
        if cfg.evaluate:
            evals[-1] = test()
            print(evals[-1])
        run.ckpt.wait()
        run.logger.finish()
    finally:
        train_loader.close()
    return {"steps": run.state.step - start_step, "step": run.state.step,
            "epochs": epochs, "eval": evals,
            "decode_backend": default_backend(),
            "transfers": dict(train_loader.transfers)}


def cls_metrics(probs: np.ndarray, labels: np.ndarray, pairs) -> dict:
    """Top-1 / top-5 accuracy, the mean class accuracy of the confusion
    matrix, and the verb and noun top-1 of the marginalized probabilities
    (``main_lavila_finetune_cls.py:810-955``)."""
    acc1, acc5 = topk_accuracy(probs, labels, (1, 5))
    cm = confusion_matrix(np.argmax(probs, 1), labels, len(pairs))
    out = {"acc1": acc1, "acc5": acc5,
           "mean_class_acc": mean_class_accuracy(cm)[0]}
    for col, mode in enumerate(("verb", "noun")):
        mp = marginalize(probs, get_marginal_indexes(pairs, mode))
        part = np.asarray([pairs[a][col] for a in labels])
        out[f"{mode}_acc1"] = topk_accuracy(mp, part, (1,))[0]
    return {k: float(v) for k, v in out.items()}


@torch.no_grad()
def validate(cfg: TrainConfig, model: torch.nn.Module, pairs,
             group=None) -> dict:
    """The multi-view test: ``data.num_clips`` centre views of each test
    clip, the softmax averaged over them, then :func:`cls_metrics`; empty
    without ``data.val_metadata``.  Over a batch ``group`` each rank
    scores its block of the clips (``eval.runners.multi_view_probs``)."""
    d = cfg.data
    if not d.val_metadata:
        return {}
    mapping = {f"{v}:{n}": i for i, (v, n) in enumerate(pairs)}
    val_ds = VideoClassyDataset(
        "ek100_cls", d.root_val or d.root, d.val_metadata,
        is_training=False, clip_length=d.clip_length, chunk_len=d.chunk_len,
        num_clips=d.num_clips, label_mapping=mapping,
        augment=AugmentSpec(crop_size=d.crop_size, mode="center"))
    dtype = getattr(model, "dtype", torch.bfloat16)
    probs, labels = multi_view_probs(
        lambda video: model(prep_video(video, dtype)), val_ds,
        d.val_batch_size, d.num_workers, next(model.parameters()).device,
        group)
    return cls_metrics(probs, labels, pairs)


if __name__ == "__main__":
    main()
