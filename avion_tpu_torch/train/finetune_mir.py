"""EK100-MIR retrieval finetuning entry point
(``avion_tpu.train.finetune_mir``): start from a pretrained dual encoder,
finetune on EPIC-Kitchens-100 with the max-margin ranking loss over
relevancy-sampled positives, and evaluate retrieval mAP / nDCG.

Usage (the recipe of ``scripts/examples/finetune_mir_ek100.sh`` at one
card's share of its batch 512 over 8 cards)::

    python -m avion_tpu_torch.train.finetune_mir \
        model.name=CLIP_VITB16 model.use_grad_checkpointing=true \
        data.clip_length=16 data.batch_size=64 optim.lr=1e-5 \
        optim.wd=0.05 optim.warmup_epochs=1 optim.epochs=100 \
        pretrain_model=<ckpt.pt or checkpoint dir> [--device cpu]

It runs on CUDA unless ``--device cpu`` is given.  The dataset paths fall
back to EK100_VIDEO_DIR, EK100_TRAIN, EK100_VAL and RELEVANCY_PATH; with
``data.shard_dir`` it reads tar shards, the relevancy extras still coming
from ``data.train_metadata``.  The validation encodes a bf16 copy of the
model (``eval.validate.run_validation``) and picks the best checkpoint on
``avg_map``.  A script that calls ``main`` needs an ``if __name__ ==
"__main__"`` guard (the loader's forkserver workers re-import it).

Over N ranks, one card each (gloo with ``--device cpu``), the recipe's
batch 512 over 8 cards::

    torchrun --nproc_per_node=8 -m avion_tpu_torch.train.finetune_mir \
        data.batch_size=512 mesh.data=8 ... (or mesh.data=4 mesh.fsdp=2)

``data.batch_size`` is the global batch, cut into ``mesh.data * mesh.fsdp``
batch groups; ``mesh.fsdp`` shards parameters and optimizer state (FSDP2),
``mesh.data`` replicates them (DDP).  The max-margin loss sees the global
batch, each rank validates its share of the clips, and only rank 0 logs and
writes.  ``mesh.sp`` ranks hold replicas of their batch group's step, as in
JAX; ``mesh.tensor`` cuts the blocks' heads and MLP columns
(``parallel.tensor_parallel``).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from avion_tpu_torch.core.config import TrainConfig, load_dotenv
from avion_tpu_torch.data.datasets import AugmentSpec, VideoCaptionDataset
from avion_tpu_torch.data.loader import DataLoader
from avion_tpu_torch.data.video_reader import default_backend
from avion_tpu_torch.eval.validate import run_validation
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.parallel.launch import device_from_argv
from avion_tpu_torch.parallel.mesh import Mesh
from avion_tpu_torch.parallel.sharding import shard_model
from avion_tpu_torch.train.common import (load_pretrained_params, over_mesh,
                                          whole_model)
from avion_tpu_torch.train.loop import (finish_if_preempted, save_epoch,
                                        setup_run, train_one_epoch)
from avion_tpu_torch.train.steps import make_mir_finetune_step


def env_defaults(cfg: TrainConfig) -> TrainConfig:
    d = cfg.data
    d.dataset = "ek100_mir"
    d.root = d.root or os.environ.get("EK100_VIDEO_DIR", "")
    d.root_val = d.root_val or d.root
    d.train_metadata = d.train_metadata or os.environ.get("EK100_TRAIN", "")
    d.val_metadata = d.val_metadata or os.environ.get("EK100_VAL", "")
    d.relevancy_path = d.relevancy_path or os.environ.get("RELEVANCY_PATH", "")
    return cfg


def build_model(cfg: TrainConfig, dtype=None) -> torch.nn.Module:
    """The configured CLIP on the meta device, with the keywords the JAX
    entry passes (no patch dropout, CLS pooling)."""
    m = cfg.model
    with torch.device("meta"):
        return create_model(
            m.name, num_frames=cfg.data.clip_length,
            project_embed_dim=m.project_embed_dim,
            use_quick_gelu=m.use_quick_gelu, use_flash_attn=m.use_flash_attn,
            use_grad_checkpointing=m.use_grad_checkpointing,
            input_norm=m.input_norm, dtype=dtype)


def build_model_and_state(cfg: TrainConfig, niter_per_ep: int,
                          device="cuda", dtype=None,
                          mesh: Optional[Mesh] = None):
    """(model on ``device``, optimizer, lr schedule): weights drawn on the
    CPU from ``torch.Generator().manual_seed(cfg.seed)``, then
    ``pretrain_model`` merged in (``train.common.load_pretrained_params``);
    layer decay, when set, over ``model.vision_layers``, as in the JAX
    entry.  A ``mesh`` with ``fsdp`` shards the model (FSDP2) before the
    optimizer is built over it."""
    model = build_model(cfg, dtype).to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    if cfg.pretrain_model:
        load_pretrained_params(cfg.pretrain_model, model,
                               num_frames=cfg.data.clip_length,
                               context_length=model.context_length,
                               vocab_size=model.vocab_size)
        print(f"[init] loaded pretrain weights from {cfg.pretrain_model}")
    model = model.to(device)
    if mesh is not None:
        shard_model(model, mesh)
    optimizer, schedule = build_optimizer(
        cfg.optim, model, niter_per_ep, num_layers=cfg.model.vision_layers)
    return model, optimizer, schedule


def build_loader(cfg: TrainConfig, mesh: Optional[Mesh] = None):
    """(train dataset, ``DataLoader``): per-file EK100 clips with
    relevancy-sampled positives, or tar shards (``data.shard_dir``) whose
    relevancy extras come from ``data.train_metadata``.  Over a ``mesh``
    the loader yields this rank's batch group's rows of each global
    batch."""
    d = cfg.data
    augment = AugmentSpec(crop_size=d.crop_size, mode="rrc",
                          scale_min=d.scale_min, scale_max=d.scale_max)
    if d.shard_dir:
        from avion_tpu_torch.data.shards import ShardedVideoCaptionDataset

        train_ds = ShardedVideoCaptionDataset(
            d.shard_dir, is_training=True, clip_length=d.clip_length,
            threads=d.decode_threads, augment=augment,
            subsample_stride=d.subsample_stride,
            decode_fast=bool(d.decode_fast)
            if d.decode_fast is not None else True,
            mir_metadata=d.train_metadata)
    else:
        train_ds = VideoCaptionDataset(
            "ek100_mir", d.root, d.train_metadata, is_training=True,
            clip_length=d.clip_length, chunk_len=d.chunk_len,
            threads=d.decode_threads, decode_fast=d.decode_fast,
            subsample_stride=d.subsample_stride, augment=augment)
    loader = DataLoader(
        train_ds, d.batch_size, shuffle=True, drop_last=True,
        num_workers=d.num_workers, prefetch_depth=d.prefetch_depth,
        seed=cfg.seed,
        process_index=mesh.batch_index if mesh is not None else 0,
        process_count=mesh.n_batch_shards if mesh is not None else 1)
    return train_ds, loader


def run_mir_validation(cfg: TrainConfig, model: torch.nn.Module,
                       group=None) -> dict:
    """EK100-MIR mAP / nDCG (``vis_map`` ... ``avg_ndcg``) of ``model`` on
    ``data.val_metadata`` with ``data.relevancy_path``, encoded by a bf16
    copy (the model keeps its weights and mode; a sharded model's weights
    are gathered first) with each rank of the batch ``group`` encoding its
    rows; empty when either path is not configured.  A failure raises.
    Every rank calls it."""
    model = whole_model(model, lambda: build_model(cfg))
    res = run_validation(model, cfg.data, env={}, strict=True, group=group)
    prefix = "test_ek100_mir_"
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def main(argv=None) -> dict:
    """Finetune (and validate); returns ``{"steps", "step", "epochs",
    "eval": the MIR metrics by epoch, "decode_backend", "transfers"}``.
    Under torchrun every rank runs it; a process group it joined is left
    when it returns."""
    load_dotenv()
    argv, device = device_from_argv(
        argv if argv is not None else sys.argv[1:])
    cfg = env_defaults(TrainConfig().apply_overrides(argv))
    return over_mesh(cfg, device, _train)


def _train(cfg: TrainConfig, device: torch.device, mesh: Mesh) -> dict:
    train_ds, train_loader = build_loader(cfg, mesh)
    print(f"[data] {len(train_ds)} clips, decode backend "
          f"{default_backend()}, {cfg.data.num_workers} workers, batch "
          f"group {mesh.batch_index} of {mesh.n_batch_shards}")
    # steps per epoch include the echo repeats (the LR schedule spans the
    # true step count)
    niter = max(1, len(train_loader)) * max(1, cfg.data.echo_factor)
    model, optimizer, _ = build_model_and_state(cfg, niter, device=device,
                                                mesh=mesh)
    # patch dropout draws from (seed + 1, step), as the JAX entry's key
    step_fn = make_mir_finetune_step(model, seed=cfg.seed + 1)
    # the max-margin loss leaves the logit scale without a gradient
    run = setup_run(cfg, model, optimizer, step_fn, mesh=mesh,
                    find_unused=True)
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
            if cfg.eval_freq and (epoch + 1) % cfg.eval_freq == 0:
                eval_metrics = run_mir_validation(cfg, model,
                                                  mesh.batch_group)
                if eval_metrics:
                    evals[epoch] = eval_metrics
                    print(f"[epoch {epoch} test] {eval_metrics}")
                    run.logger.log(eval_metrics, step=run.state.step)
            score = eval_metrics.get("avg_map", 0.0)
            is_best = score > best
            best = max(best, score)
            save_epoch(run, epoch, {**metrics, **eval_metrics}, is_best)
        if cfg.evaluate:
            evals[-1] = run_mir_validation(cfg, model, mesh.batch_group)
            print(evals[-1])
        run.ckpt.wait()
        run.logger.finish()
    finally:
        train_loader.close()
    return {"steps": run.state.step - start_step, "step": run.state.step,
            "epochs": epochs, "eval": evals,
            "decode_backend": default_backend(),
            "transfers": dict(train_loader.transfers)}


if __name__ == "__main__":
    main()
