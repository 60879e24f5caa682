"""VideoMAE masked-autoencoder pretraining entry point
(``avion_tpu.train.videomae_pretrain``): Kinetics strided clips with a
multi-scale crop and flip on the host, 90% tube masking, the encoder on
the visible tokens only, the normalized-pixel MSE target, AdamW with the
learning rate scaled by batch / 256, and checkpoint / resume.

Usage::

    python -m avion_tpu_torch.train.videomae_pretrain \
        model.name=VIDEOMAE_VITB16 model.use_grad_checkpointing=true \
        data.clip_length=16 data.clip_stride=4 data.batch_size=128 \
        data.root=$K400_ROOT data.train_metadata=$K400_TRAIN_LIST \
        optim.lr=1.5e-4 optim.betas=0.9,0.95 [--device cpu]

It runs on CUDA unless ``--device cpu`` is given; the dataset paths fall
back to K400_ROOT and K400_TRAIN_LIST.  Under data echoing
(``data.echo_factor > 1``) each step draws its own tube masks on the
device.  A script that calls ``main`` needs an ``if __name__ ==
"__main__"`` guard (the loader's forkserver workers re-import it).

Over N ranks, one card each (gloo with ``--device cpu``), the recipe's
batch 512 over four cards::

    torchrun --nproc_per_node=4 -m avion_tpu_torch.train.videomae_pretrain \
        data.batch_size=512 mesh.data=4 ... (or mesh.data=2 mesh.fsdp=2)

``data.batch_size`` is the global batch (the learning rate scales by it),
cut into ``mesh.data * mesh.fsdp`` batch groups; ``mesh.fsdp`` shards
parameters and optimizer state (FSDP2), ``mesh.data`` replicates them
(DDP).  Each batch group draws its own tube masks, the logged ``loss`` is
the mean over the global batch, and only rank 0 logs and writes.
``mesh.sp`` ranks hold replicas of their batch group's step, as in JAX;
``mesh.tensor`` cuts the blocks' heads and MLP columns
(``parallel.tensor_parallel``).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from avion_tpu_torch.core.config import TrainConfig, load_dotenv
from avion_tpu_torch.data.datasets import AugmentSpec, KineticsDataset
from avion_tpu_torch.data.loader import DataLoader
from avion_tpu_torch.data.video_reader import default_backend
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.parallel.launch import device_from_argv
from avion_tpu_torch.parallel.mesh import Mesh
from avion_tpu_torch.parallel.sharding import shard_model
from avion_tpu_torch.train.common import over_mesh
from avion_tpu_torch.train.loop import (finish_if_preempted, save_epoch,
                                        setup_run, train_one_epoch)
from avion_tpu_torch.train.steps import make_videomae_train_step


def build_model(cfg: TrainConfig, dtype=None) -> torch.nn.Module:
    """The configured ``PretrainVideoMAE`` (``VIDEOMAE_VITB16`` unless
    ``model.name`` names a VideoMAE entry) on the meta device."""
    name = cfg.model.name if "VIDEOMAE" in cfg.model.name \
        else "VIDEOMAE_VITB16"
    with torch.device("meta"):
        return create_model(
            name, num_frames=cfg.data.clip_length,
            use_flash_attn=cfg.model.use_flash_attn,
            use_grad_checkpointing=cfg.model.use_grad_checkpointing,
            decoder_depth=cfg.model.decoder_layers,
            mask_ratio=cfg.data.mask_ratio, dtype=dtype)


def build_model_and_state(cfg: TrainConfig, niter_per_ep: int,
                          device="cuda", dtype=None,
                          mesh: Optional[Mesh] = None):
    """(model on ``device``, optimizer, lr schedule).  The weights are
    drawn on the CPU from ``torch.Generator().manual_seed(cfg.seed)`` with
    the flax initializers' distributions; layer decay, when configured,
    counts the encoder's layers.  A ``mesh`` with ``fsdp`` shards the model
    (FSDP2) before the optimizer is built over it."""
    model = build_model(cfg, dtype).to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.seed)).to(device)
    if mesh is not None:
        shard_model(model, mesh)
    optimizer, schedule = build_optimizer(cfg.optim, model, niter_per_ep,
                                          num_layers=model.encoder_layers)
    return model, optimizer, schedule


def main(argv=None) -> dict:
    """Train; returns ``{"steps": steps taken by this call, "step": the
    train state's step, "epochs": each epoch's metrics, "decode_backend":
    ..., "transfers": the loader's worker transfers}``.  Under torchrun
    every rank runs it; a process group it joined is left when it
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
    return over_mesh(cfg, device, _train)


def _train(cfg: TrainConfig, device: torch.device, mesh: Mesh) -> dict:
    d = cfg.data
    geometry = build_model(cfg)
    cfg.model.patch_size = geometry.patch_size
    cfg.model.tubelet_size = geometry.tubelet_size
    d.crop_size = geometry.image_size
    train_ds = KineticsDataset(
        d.root, d.train_metadata, clip_length=d.clip_length,
        clip_stride=d.clip_stride, threads=d.decode_threads,
        decode_fast=d.decode_fast, crop_size=d.crop_size,
        patch_size=cfg.model.patch_size,
        tubelet_size=cfg.model.tubelet_size, mask_ratio=d.mask_ratio,
        augment=AugmentSpec(crop_size=d.crop_size, mode="msc",
                            hflip_prob=0.5))
    train_loader = DataLoader(train_ds, d.batch_size, shuffle=True,
                              drop_last=True, num_workers=d.num_workers,
                              prefetch_depth=d.prefetch_depth, seed=cfg.seed,
                              process_index=mesh.batch_index,
                              process_count=mesh.n_batch_shards)
    print(f"[data] {len(train_ds)} videos, decode backend "
          f"{default_backend()}, {d.num_workers} workers, batch group "
          f"{mesh.batch_index} of {mesh.n_batch_shards}")
    # steps per epoch include the echo repeats
    niter = max(1, len(train_loader)) * max(1, d.echo_factor)
    cfg.optim.lr = cfg.optim.lr * d.batch_size / 256
    model, optimizer, _ = build_model_and_state(cfg, niter, device=device,
                                                mesh=mesh)
    # echoed repeats must not reuse the host batch's tube masks; the
    # draws come from (seed + 1, step), as the JAX entry's step key
    step_fn = make_videomae_train_step(
        model, patch_size=cfg.model.patch_size,
        tubelet_size=cfg.model.tubelet_size,
        regen_mask=d.echo_factor > 1, seed=cfg.seed + 1)
    run = setup_run(cfg, model, optimizer, step_fn, mesh=mesh)
    start_step, epochs = run.state.step, []
    try:
        for epoch in range(run.start_epoch, cfg.optim.epochs):
            train_loader.set_epoch(epoch)
            metrics = train_one_epoch(run, train_loader, epoch)
            epochs.append(metrics)
            print(f"[epoch {epoch}] " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
            if finish_if_preempted(run, epoch, metrics):
                break
            if (epoch + 1) % cfg.save_freq == 0 \
                    or epoch + 1 == cfg.optim.epochs:
                save_epoch(run, epoch, metrics)
        run.ckpt.wait()
        run.logger.finish()
    finally:
        train_loader.close()
    return {"steps": run.state.step - start_step, "step": run.state.step,
            "epochs": epochs, "decode_backend": default_backend(),
            "transfers": dict(train_loader.transfers)}


if __name__ == "__main__":
    main()
