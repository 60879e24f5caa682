"""CLIP video-text contrastive pretraining entry point
(``avion_tpu.train.pretrain_clip``): Ego4D video-text contrastive training
on decoded video, with host or device crop, cosine LR, bf16 compute, the
hand-written flash-attention kernels, and checkpoint / resume.

Usage::

    python -m avion_tpu_torch.train.pretrain_clip \
        model.name=CLIP_VITB16 data.clip_length=4 data.batch_size=256 \
        data.root=$ROOT data.train_metadata=$TRAIN_METADATA [--device cpu]

ViT-L/14 at the reference's global batch of 896 on one card, through
cached gradient accumulation (8 microbatches of 112) and bf16 optimizer
state::

    python -m avion_tpu_torch.train.pretrain_clip \
        model.name=CLIP_VITL14 data.clip_length=4 data.batch_size=896 \
        optim.update_freq=8 optim.accum=cached optim.state_dtype=bfloat16 \
        model.use_grad_checkpointing=true data.root=$ROOT \
        data.train_metadata=$TRAIN_METADATA

It runs on CUDA unless ``--device cpu`` is given.  Dataset paths fall back
to the environment variables the reference reads (ROOT, ROOT_VAL,
TRAIN_METADATA, VAL_METADATA, RELEVANCY_PATH).  The configured zero-shot
suites (``eval.validate``) run before the first epoch and every
``eval_freq`` epochs, on a bf16 copy of the model, and
``test_ek100_mir_avg_map`` picks the best checkpoint when that suite runs.
``loss=siglip`` trains the sigmoid loss and switches on the model's
``use_logit_bias``.  ``optim.update_freq`` > 1 accumulates: with
``optim.accum=cached`` ``data.batch_size`` is the whole contrastive batch,
cut into ``update_freq`` microbatches (``steps.
make_clip_accum_train_step``); with ``multistep`` each batch is its own
contrastive batch and the optimizer averages ``update_freq`` of them.

Over N ranks, one card each (gloo with ``--device cpu``)::

    torchrun --nproc_per_node=N -m avion_tpu_torch.train.pretrain_clip \
        data.batch_size=$((256 * N)) mesh.data=... mesh.fsdp=... \
        mesh.sp=... mesh.tensor=... mesh.pp=... mesh.ep=... \
        mesh.dcn_data=... [model.sequence_parallel=true model.pooling=gap] \
        [model.moe_experts=8] [model.pipeline=true] ...

``data.batch_size`` is the global batch, cut into ``mesh.data *
mesh.fsdp`` batch groups (``parallel.mesh``); ``mesh.fsdp`` shards
parameters and optimizer state (FSDP2), ``mesh.data`` replicates them
(DDP), ``mesh.sp`` with ``model.sequence_parallel=true`` splits the
visual tower's tokens over the ring, ``mesh.tensor`` cuts the blocks'
heads and MLP columns (``parallel.tensor_parallel``; the ring's hops then
run on H / t heads), ``mesh.ep`` with ``model.moe_experts=N`` cuts the
mixture-of-experts blocks' experts (``ops.moe``) and ``mesh.pp`` with
``model.pipeline=true`` the visual tower's layers into GPipe stages
(``parallel.pipeline``).  Only rank 0 logs and writes; the losses see
the global batch.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch

from avion_tpu_torch.core.config import TrainConfig, load_dotenv
from avion_tpu_torch.data.datasets import (AugmentSpec, ConcatDataset,
                                           VideoCaptionDataset)
from avion_tpu_torch.data.loader import DataLoader
from avion_tpu_torch.data.video_reader import default_backend
from avion_tpu_torch.eval.validate import run_validation
from avion_tpu_torch.models.pt_import import import_clip_pt
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.parallel.launch import device_from_argv
from avion_tpu_torch.parallel.mesh import Mesh
from avion_tpu_torch.parallel.sharding import shard_model
from avion_tpu_torch.train.common import over_mesh, whole_model
from avion_tpu_torch.train.loop import (finish_if_preempted, save_epoch,
                                        setup_run, train_one_epoch)
from avion_tpu_torch.train.steps import (make_clip_accum_train_step,
                                         make_clip_train_step)


def env_defaults(cfg: TrainConfig) -> TrainConfig:
    """Dataset paths fall back to the reference's environment variables
    (ROOT, ROOT_VAL, TRAIN_METADATA, VAL_METADATA, RELEVANCY_PATH)."""
    d = cfg.data
    d.root = d.root or os.environ.get("ROOT", "")
    d.root_val = d.root_val or os.environ.get("ROOT_VAL", d.root)
    d.train_metadata = d.train_metadata or os.environ.get("TRAIN_METADATA", "")
    d.val_metadata = d.val_metadata or os.environ.get("VAL_METADATA", "")
    d.relevancy_path = d.relevancy_path or os.environ.get("RELEVANCY_PATH", "")
    return cfg


def build_model(cfg: TrainConfig, dtype=None) -> torch.nn.Module:
    """The configured CLIP on the meta device (no storage yet)."""
    m = cfg.model
    with torch.device("meta"):
        return create_model(
            m.name, num_frames=cfg.data.clip_length,
            project_embed_dim=m.project_embed_dim,
            use_quick_gelu=m.use_quick_gelu,
            use_flash_attn=m.use_flash_attn,
            use_grad_checkpointing=m.use_grad_checkpointing,
            remat_policy=m.remat_policy,
            sequence_parallel=m.sequence_parallel,
            moe_experts=m.moe_experts, pipeline=m.pipeline,
            pipeline_microbatches=m.pipeline_microbatches,
            patch_dropout=m.patch_dropout, pooling=m.pooling,
            input_norm=m.input_norm,
            freeze_temperature=m.freeze_temperature,
            temperature_init=m.temperature_init,
            use_logit_bias=m.use_logit_bias, dtype=dtype)


def build_model_and_state(cfg: TrainConfig, niter_per_ep: int,
                          device="cuda", dtype=None,
                          mesh: Optional[Mesh] = None):
    """Returns (model on ``device``, optimizer, lr schedule).  Weights are
    drawn on the CPU from ``torch.Generator().manual_seed(cfg.seed)`` with
    the flax initializers' distributions (so a seed gives the same weights
    on every device and every rank), then ``pretrain_model`` is merged in
    with ``strict=False`` (missing keys keep their init).  A ``mesh`` with
    ``fsdp`` shards the model (FSDP2) before the optimizer is built over
    it."""
    model = build_model(cfg, dtype).to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    if cfg.pretrain_model:  # e.g. OpenAI CLIP weights or an AVION .pt
        imported = import_clip_pt(cfg.pretrain_model,
                                  num_frames=cfg.data.clip_length,
                                  context_length=model.context_length,
                                  vocab_size=model.vocab_size)
        model.load_state_dict(imported, strict=False)
        print(f"[init] imported weights from {cfg.pretrain_model}")
    model = model.to(device)
    if mesh is not None:
        shard_model(model, mesh)
    optimizer, schedule = build_optimizer(cfg.optim, model, niter_per_ep)
    return model, optimizer, schedule


def build_loaders(cfg: TrainConfig, mesh: Optional[Mesh] = None):
    """(train dataset, train ``DataLoader``): per-file chunked video, or
    packed shards (``data.shard_dir``), plus ``data.train_metadata_aux``
    pkls concatenated into the train set.  Over a ``mesh`` the loader
    yields this rank's batch group's rows of each global batch."""
    d = cfg.data
    augment = AugmentSpec(
        crop_size=d.crop_size,
        # fused_decode_crop=False moves crop / resize / flip to the device
        # (ops/fused_input); the host then only decodes
        mode="rrc" if d.fused_decode_crop else "device_rrc",
        decode_size=d.decode_size, scale_min=d.scale_min,
        scale_max=d.scale_max, hflip_prob=d.hflip_prob,
        vflip_prob=d.vflip_prob,
    )

    def make_ds(meta):
        return VideoCaptionDataset(
            d.dataset, d.root, meta,
            is_training=True, clip_length=d.clip_length,
            chunk_len=d.chunk_len, fps=d.fps, threads=d.decode_threads,
            decode_fast=d.decode_fast, augment=augment,
            subsample_stride=d.subsample_stride,
        )

    if d.shard_dir:
        from avion_tpu_torch.data.shards import ShardedVideoCaptionDataset

        train_ds = ShardedVideoCaptionDataset(
            d.shard_dir, is_training=True, clip_length=d.clip_length,
            threads=d.decode_threads, augment=augment,
            subsample_stride=d.subsample_stride,
            decode_fast=bool(d.decode_fast)
            if d.decode_fast is not None else True,
        )
    else:
        train_ds = make_ds(d.train_metadata)
    if d.train_metadata_aux:
        paths = [p.strip() for p in d.train_metadata_aux.split(",")
                 if p.strip()]
        aux = [make_ds(p) for p in paths]
        for i, (p, ds) in enumerate(zip(paths, aux)):
            print(f"auxiliary dataset [{i}]: source={p} len={len(ds)}")
        train_ds = ConcatDataset([train_ds] + aux)
    train_loader = DataLoader(
        train_ds, d.batch_size, shuffle=True, drop_last=True,
        num_workers=d.num_workers, prefetch_depth=d.prefetch_depth,
        seed=cfg.seed,
        process_index=mesh.batch_index if mesh is not None else 0,
        process_count=mesh.n_batch_shards if mesh is not None else 1,
    )
    return train_ds, train_loader


def make_step(cfg: TrainConfig, model: torch.nn.Module):
    """The entry's train step, chosen as the JAX entry chooses it: the
    cached accumulation step when ``optim.update_freq`` > 1 and
    ``optim.accum=cached``, else the one-shot step.  Patch dropout draws
    from (``seed + 1``, step), as the JAX entry's step key."""
    common = dict(label_smoothing=cfg.label_smoothing,
                  crop_size=cfg.data.crop_size, seed=cfg.seed + 1,
                  loss_type=cfg.loss, siglip_chunked=cfg.siglip_chunked,
                  moe_aux_weight=cfg.model.moe_aux_weight,
                  moe_zloss_weight=cfg.model.moe_zloss_weight)
    if cfg.optim.update_freq > 1 and cfg.optim.accum == "cached":
        if cfg.data.batch_size % cfg.optim.update_freq:
            raise ValueError(
                f"cached accumulation needs data.batch_size "
                f"({cfg.data.batch_size}) to divide by optim.update_freq "
                f"({cfg.optim.update_freq})")
        return make_clip_accum_train_step(model, cfg.optim.update_freq,
                                          **common)
    return make_clip_train_step(model, **common)


def _eval_model(cfg: TrainConfig, model: torch.nn.Module) -> torch.nn.Module:
    """The model the suites encode with: ``model`` itself, or under
    ``fsdp`` an unsharded copy of its gathered weights (every rank calls
    this)."""
    return whole_model(model, lambda: build_model(cfg))


def main(argv=None) -> dict:
    """Train; returns ``{"steps": steps taken by this call, "step": the
    train state's step, "epochs": each epoch's metrics, "eval": the
    zero-shot metrics by epoch (-1 before the first), "decode_backend":
    ..., "transfers": the loader's worker transfers}``.  Under torchrun
    (or another launcher, ``parallel.launch``) every rank runs it; a
    process group it joined is left when it returns."""
    load_dotenv()  # dataset-path env vars, the reference's .env convention
    argv, device = device_from_argv(
        argv if argv is not None else sys.argv[1:])
    cfg = env_defaults(TrainConfig().apply_overrides(argv))
    if cfg.loss == "siglip":
        # the sigmoid loss learns the pairwise bias (arXiv:2303.15343)
        cfg.model.use_logit_bias = True
    return over_mesh(cfg, device, _train)


def _train(cfg: TrainConfig, device: torch.device, mesh: Mesh) -> dict:
    train_ds, train_loader = build_loaders(cfg, mesh)
    print(f"[data] {len(train_ds)} clips, decode backend "
          f"{default_backend()}, {cfg.data.num_workers} workers, batch "
          f"group {mesh.batch_index} of {mesh.n_batch_shards}")
    # steps per epoch include the echo repeats (the LR schedule spans
    # the true step count)
    niter = max(1, len(train_loader)) * max(1, cfg.data.echo_factor)
    model, optimizer, _ = build_model_and_state(cfg, niter, device=device,
                                                mesh=mesh)
    run = setup_run(cfg, model, optimizer, make_step(cfg, model), mesh=mesh)
    start_step = run.state.step
    best, epochs, evals = -1.0, [], {}
    try:
        if cfg.eval_freq and run.start_epoch == 0:
            # zero-shot pass before training
            zs = run_validation(_eval_model(cfg, model), cfg.data,
                                group=mesh.batch_group)
            if zs:
                evals[-1] = zs
                print(f"[epoch -1 zero-shot] {zs}")
                run.logger.log(zs, step=0)
        for epoch in range(run.start_epoch, cfg.optim.epochs):
            train_loader.set_epoch(epoch)
            metrics = train_one_epoch(run, train_loader, epoch)
            epochs.append(metrics)
            print(f"[epoch {epoch}] " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
            if finish_if_preempted(run, epoch, metrics):
                break
            eval_metrics = {}
            if cfg.eval_freq and (epoch + 1) % cfg.eval_freq == 0:
                eval_metrics = run_validation(
                    _eval_model(cfg, model), cfg.data,
                    group=mesh.batch_group)
                if eval_metrics:
                    evals[epoch] = eval_metrics
                    run.logger.log(eval_metrics, step=run.state.step)
            score = eval_metrics.get("test_ek100_mir_avg_map",
                                     metrics.get("clip_acc", 0))
            is_best = score > best
            best = max(best, score)
            if (epoch + 1) % cfg.save_freq == 0 \
                    or epoch + 1 == cfg.optim.epochs:
                save_epoch(run, epoch, {**metrics, **eval_metrics}, is_best)
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
