"""VideoMAE supervised finetuning entry point on Kinetics-400
(``avion_tpu.train.videomae_finetune``): the MAE encoder loaded into the
finetune ViT, layer-wise learning-rate decay, mixup / cutmix on the device,
label smoothing, an EMA of the weights, RandAugment and cube random
erasing on the host, repeated augmentation, and the multi-view test
(``num_clips`` temporal x ``num_crops`` spatial views, softmax mean).

Usage::

    python -m avion_tpu_torch.train.videomae_finetune \
        model.name=VIDEOMAE_VITB16_FT data.clip_length=16 \
        data.batch_size=128 optim.lr=1e-3 optim.layer_decay=0.75 \
        mixup=0.8 cutmix=1.0 use_ema=true data.repeated_aug=2 \
        data.root=$K400_ROOT data.train_metadata=$K400_TRAIN_LIST \
        data.val_metadata=$K400_VAL_LIST pretrain_model=<ckpt> \
        [--device cpu]

It runs on CUDA unless ``--device cpu`` is given; the dataset paths fall
back to K400_ROOT, K400_TRAIN_LIST and K400_VAL_LIST.  ``pretrain_model``
is a ``.pt`` / ``.pth`` in the VideoMAE finetune layout
(``models.pt_import.import_videomae_pt``, which raises on a file holding
no encoder block) or a directory of this port's checkpoints, such as a
``videomae_pretrain`` run's, whose encoder it takes; a source that lacks
any encoder weight raises.  A script that calls
``main`` needs an ``if __name__ == "__main__"`` guard.

Over N ranks, one card each (gloo with ``--device cpu``)::

    torchrun --nproc_per_node=4 -m avion_tpu_torch.train.videomae_finetune \
        data.batch_size=512 mesh.data=4 ... (or mesh.data=2 mesh.fsdp=2)

``data.batch_size`` is the global batch (the learning rate scales by it),
cut into ``mesh.data * mesh.fsdp`` batch groups; ``mesh.fsdp`` shards
parameters, optimizer state and the EMA (FSDP2), ``mesh.data`` replicates
them (DDP).  Mixup pairs rows across the global batch, the logged ``loss``
and ``acc1`` are means over it, each rank scores its block of the test
videos (on a gathered copy of the EMA weights), and only rank 0 logs and
writes.  ``mesh.sp`` ranks hold replicas of their batch group's step, as in
JAX; ``mesh.tensor`` cuts the blocks' heads and MLP columns
(``parallel.tensor_parallel``).
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Optional

import numpy as np
import torch

from avion_tpu_torch.core.config import TrainConfig, load_dotenv
from avion_tpu_torch.data.datasets import AugmentSpec, VideoClassyDataset
from avion_tpu_torch.data.loader import DataLoader
from avion_tpu_torch.data.rand_augment import (rand_augment_clip,
                                               random_erase_clip)
from avion_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from avion_tpu_torch.data.video_reader import default_backend
from avion_tpu_torch.eval.classification_metrics import topk_accuracy
from avion_tpu_torch.eval.runners import multi_view_probs
from avion_tpu_torch.models.pt_import import import_videomae_pt
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.optim.factory import (apply_batch_lr_scale,
                                           build_optimizer)
from avion_tpu_torch.parallel.launch import device_from_argv
from avion_tpu_torch.parallel.mesh import Mesh
from avion_tpu_torch.parallel.sharding import shard_model
from avion_tpu_torch.train.augment_device import mixup_cutmix
from avion_tpu_torch.train.common import (latest_model_state, over_mesh,
                                          whole_model)
from avion_tpu_torch.train.loop import (finish_if_preempted, save_epoch,
                                        setup_run, train_one_epoch)
from avion_tpu_torch.train.steps import make_cls_train_step, prep_video


class AugmentedK400(VideoClassyDataset):
    """Host RandAugment and cube random erasing on the training views, each
    view with its own draws."""

    def __init__(self, *args, use_randaug=True, erase_prob=0.25, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_randaug = use_randaug
        self.erase_prob = erase_prob

    def __getitem__(self, i):
        item = super().__getitem__(i)
        if not self.is_training:
            return item
        views = item if isinstance(item, list) else [item]
        rng = np.random.RandomState()
        for v in views:
            if self.use_randaug:
                v["video"] = rand_augment_clip(v["video"], rng)
            if self.erase_prob > 0:
                v["video"] = random_erase_clip(v["video"], rng,
                                               self.erase_prob)
        return item


def build_model(cfg: TrainConfig, dtype=None) -> torch.nn.Module:
    """The configured ``FinetuneVideoMAE`` (``VIDEOMAE_VITB16_FT`` unless
    ``model.name`` names a VideoMAE entry) on the meta device."""
    name = cfg.model.name if "VIDEOMAE" in cfg.model.name \
        else "VIDEOMAE_VITB16_FT"
    with torch.device("meta"):
        return create_model(
            name, num_frames=cfg.data.clip_length,
            num_classes=cfg.model.num_classes or 400,
            use_flash_attn=cfg.model.use_flash_attn,
            use_grad_checkpointing=cfg.model.use_grad_checkpointing,
            drop_path_rate=cfg.model.drop_path_rate,
            fc_drop_rate=cfg.model.classifier_dropout, dtype=dtype)


def load_encoder(model: torch.nn.Module, path: str) -> None:
    """Overlay pretrained weights onto ``model`` (keys it lacks are
    skipped, a shape that differs raises, as the JAX entry's merge): a
    ``.pt`` / ``.pth`` through :func:`import_videomae_pt`, or the newest
    checkpoint of this port under a directory.  Raises when it lacks any
    encoder weight."""
    state = (import_videomae_pt(path) if path.endswith((".pt", ".pth"))
             else latest_model_state(path))
    missing = model.load_state_dict(state, strict=False).missing_keys
    if any(k.startswith("encoder.") for k in missing):
        raise ValueError(f"{path}: the encoder's weights are not all there "
                         f"(missing e.g. {missing[:3]})")


def build_model_and_state(cfg: TrainConfig, niter_per_ep: int,
                          device="cuda", dtype=None,
                          mesh: Optional[Mesh] = None):
    """(model on ``device``, optimizer, lr schedule): weights drawn on the
    CPU from ``torch.Generator().manual_seed(cfg.seed)``, then
    ``pretrain_model`` overlaid; layer decay over the encoder's layers.  A
    ``mesh`` with ``fsdp`` shards the model (FSDP2) before the optimizer
    is built over it."""
    model = build_model(cfg, dtype).to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    if cfg.pretrain_model:
        load_encoder(model, cfg.pretrain_model)
        print(f"[init] encoder from {cfg.pretrain_model}")
    model.to(device)
    if mesh is not None:
        shard_model(model, mesh)
    optimizer, schedule = build_optimizer(cfg.optim, model, niter_per_ep,
                                          num_layers=model.layers)
    return model, optimizer, schedule


def make_mixup(cfg: TrainConfig, num_classes: int):
    """The configured mixup / cutmix, or None when both are off."""
    if not (cfg.mixup > 0 or cfg.cutmix > 0):
        return None
    return functools.partial(
        mixup_cutmix, num_classes=num_classes, mixup_alpha=cfg.mixup,
        cutmix_alpha=cfg.cutmix, switch_prob=cfg.mixup_switch_prob,
        prob=cfg.mixup_prob, smoothing=cfg.smoothing, mode=cfg.mixup_mode,
        cutmix_minmax=cfg.cutmix_minmax)


def main(argv=None) -> dict:
    """Train (and test); returns ``{"steps", "step", "epochs", "eval": the
    test metrics by epoch, "decode_backend", "transfers"}``.  Under
    torchrun every rank runs it; a process group it joined is left when it
    returns."""
    load_dotenv()
    argv, device = device_from_argv(
        argv if argv is not None else sys.argv[1:])
    cfg = TrainConfig().apply_overrides(argv)
    d = cfg.data
    d.dataset = "kinetics"
    d.root = d.root or os.environ.get("K400_ROOT", "")
    d.train_metadata = d.train_metadata or os.environ.get(
        "K400_TRAIN_LIST", "")
    d.val_metadata = d.val_metadata or os.environ.get("K400_VAL_LIST", "")
    return over_mesh(cfg, device, _train)


def _train(cfg: TrainConfig, device: torch.device, mesh: Mesh) -> dict:
    d = cfg.data
    num_classes = cfg.model.num_classes or 400
    d.crop_size = build_model(cfg).image_size
    train_ds = AugmentedK400(
        "kinetics", d.root, d.train_metadata, is_training=True,
        clip_length=d.clip_length, clip_stride=d.clip_stride,
        threads=d.decode_threads, num_sample=d.repeated_aug,
        decode_fast=d.decode_fast, use_randaug=d.rand_aug,
        erase_prob=d.erase_prob,
        augment=AugmentSpec(crop_size=d.crop_size, mode="rrc",
                            scale_min=d.scale_min, scale_max=d.scale_max,
                            hflip_prob=0.5))
    train_loader = DataLoader(train_ds, d.batch_size, shuffle=True,
                              drop_last=True, num_workers=d.num_workers,
                              seed=cfg.seed, process_index=mesh.batch_index,
                              process_count=mesh.n_batch_shards)
    print(f"[data] {len(train_ds)} videos, decode backend "
          f"{default_backend()}, {d.num_workers} workers, batch group "
          f"{mesh.batch_index} of {mesh.n_batch_shards}")
    niter = max(1, len(train_loader)) * max(1, d.echo_factor)
    # lr x batch / 256 (main_videomae_finetune.py:285-288)
    apply_batch_lr_scale(cfg.optim, d.batch_size, default_base=256)
    model, optimizer, _ = build_model_and_state(cfg, niter, device=device,
                                                mesh=mesh)
    step_fn = make_cls_train_step(
        model, label_smoothing=cfg.smoothing,
        ema_decay=cfg.ema_decay if cfg.use_ema else None,
        mixup_fn=make_mixup(cfg, num_classes), seed=cfg.seed + 1)
    run = setup_run(cfg, model, optimizer, step_fn, use_ema=cfg.use_ema,
                    mesh=mesh)
    start_step, best, epochs, evals = run.state.step, -1.0, [], {}
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
            if cfg.eval_freq and (epoch + 1) % cfg.eval_freq == 0 \
                    and d.val_metadata:
                eval_metrics = evals[epoch] = validate(cfg, run)
                print(f"[epoch {epoch} test] {eval_metrics}")
                run.logger.log(eval_metrics, step=run.state.step)
            score = eval_metrics.get("acc1", metrics.get("acc1", 0))
            is_best = score > best
            best = max(best, score)
            save_epoch(run, epoch, {**metrics, **eval_metrics}, is_best)
        if cfg.evaluate and d.val_metadata:
            evals[-1] = validate(cfg, run)
            print(evals[-1])
        run.ckpt.wait()
        run.logger.finish()
    finally:
        train_loader.close()
    return {"steps": run.state.step - start_step, "step": run.state.step,
            "epochs": epochs, "eval": evals,
            "decode_backend": default_backend(),
            "transfers": dict(train_loader.transfers)}


@torch.no_grad()
def validate(cfg: TrainConfig, run) -> dict:
    """The multi-view test: ``num_clips`` x ``num_crops`` centre views of
    each validation video, the softmax averaged over them, top-1 / top-5
    accuracy; on the EMA weights when ``use_ema`` (an unsharded copy of the
    model holding them; under ``fsdp`` the weights are gathered first).
    Frames are normalized with the ImageNet statistics into bf16, as the
    JAX entry does.  Over the run's batch group each rank scores its block
    of the videos (``eval.runners.multi_view_probs``); every rank calls
    it."""
    d = cfg.data
    ema = run.state.ema if cfg.use_ema else None
    model = whole_model(run.state.model, lambda: build_model(cfg), ema)
    par = run.state.parallel
    val_ds = VideoClassyDataset(
        "kinetics", d.root_val or d.root, d.val_metadata, is_training=False,
        clip_length=d.clip_length, clip_stride=d.clip_stride,
        num_clips=d.num_clips, num_crops=d.num_crops,
        augment=AugmentSpec(crop_size=d.crop_size, mode="center"))
    probs, labels = multi_view_probs(
        lambda video: model(prep_video(video, mean=IMAGENET_MEAN,
                                       std=IMAGENET_STD)),
        val_ds, d.val_batch_size, d.num_workers,
        next(model.parameters()).device,
        par.mesh.batch_group if par is not None else None)
    acc1, acc5 = topk_accuracy(probs, labels, (1, 5))
    return {"acc1": float(acc1), "acc5": float(acc5)}


if __name__ == "__main__":
    main()
