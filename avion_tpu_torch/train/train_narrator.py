"""VCLM narrator training entry (``avion_tpu.train.train_narrator``):
caption generation on narrated clips with next-token cross-entropy.

Usage (the VCLM at 4 frames, batch 256 on one card)::

    python -m avion_tpu_torch.train.train_narrator \
        model.name=VCLM_VITB16 data.clip_length=4 data.batch_size=256 \
        data.root=$ROOT data.train_metadata=$TRAIN_METADATA \
        optim.epochs=5 [--device cpu]

It runs on CUDA unless ``--device cpu`` is given; the dataset paths fall
back to ROOT and TRAIN_METADATA.  A ``model.name`` that starts with
neither ``VCLM`` nor ``LAVILA`` trains ``VCLM_VITB16``;
``model.vision_heads=6 model.text_heads=4`` gives the head_dim-128
geometry.
``model.name=VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL`` is LaViLa's
narrator (``models.lavila``), always trained by LaViLa's recipe
(``LavilaNarrator.freeze``): only the gated cross sub-blocks, the queries
and their pool train, and the optimizer holds only those.  Its loss is the token mean of the next-token NLL of the
model's ``logits`` against its ``labels``.  It reads GPT-2's ids: the
captions are tokenized with ``tools.narrator.gpt2_tokenizer``
(transformers' ``GPT2Tokenizer`` and its ``gpt2`` files, which it
raises without) into LaViLa's 77 tokens.  The clips are the
Ego4D caption layout (``VideoCaptionDataset("ego4d", ...)``, random
resized crops), the narrations tokenized to the model's 77 tokens.  On
CUDA both attention stacks (the visual tower and the decoder's causal
self-attention) run the flash kernels.  A script that calls ``main``
needs an ``if __name__ == "__main__"`` guard (the loader's forkserver
workers re-import it).

Over N ranks, one card each (gloo with ``--device cpu``)::

    torchrun --nproc_per_node=N -m avion_tpu_torch.train.train_narrator \
        data.batch_size=<global> mesh.data=.. mesh.fsdp=..

``data.batch_size`` is the global batch, cut into ``mesh.data * mesh.fsdp``
batch groups; ``mesh.fsdp`` shards parameters and optimizer state (FSDP2),
``mesh.data`` replicates them (DDP).  The loss is the mean over the global
batch's non-padding tokens, as the JAX step's, and only rank 0 logs and
writes.  ``mesh.sp`` ranks hold replicas of their batch group's step, as in
JAX; ``mesh.tensor`` cuts the blocks' heads and MLP columns
(``parallel.tensor_parallel``); ``mesh.pp`` with ``model.pipeline=true``
cuts the decoder's cross-attention groups into GPipe stages
(``parallel.pipeline_gated``; ``model.pipeline_microbatches``, and
``model.use_grad_checkpointing`` recomputes each group, as JAX's
``pipeline_remat``), else its ranks hold replicas, as ``mesh.ep``'s do.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import torch
import torch.distributed as dist

from avion_tpu_torch.core.config import TrainConfig, load_dotenv
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.data.datasets import AugmentSpec, VideoCaptionDataset
from avion_tpu_torch.data.loader import DataLoader
from avion_tpu_torch.data.tokenizer import BosEosIds
from avion_tpu_torch.data.video_reader import default_backend
from avion_tpu_torch.models.lavila import LavilaNarrator
from avion_tpu_torch.models.narrator import caption_nll, label_nll
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.parallel.launch import device_from_argv
from avion_tpu_torch.parallel.mesh import Mesh
from avion_tpu_torch.parallel.sharding import shard_model
from avion_tpu_torch.train.common import over_mesh
from avion_tpu_torch.train.loop import (finish_if_preempted, save_epoch,
                                        setup_run, train_one_epoch)
from avion_tpu_torch.train.steps import (_apply_or_skip, _backward,
                                         _group_mean, _parallel_parts,
                                         _phase, _spanned, prep_video)


LAVILA_CONTEXT = 77  # the tokens of a caption LaViLa's narrator reads


def make_narrator_step(model: torch.nn.Module) -> Callable:
    """``step(state, batch) -> (state, metrics)``: the caption loss of
    ``model(video, text)`` (``video`` uint8, normalized here with OpenAI's
    statistics, or normalized float; ``text`` [B, L] ids; a model that
    returns ``logits`` and ``labels``, LaViLa's, is scored on those),
    backward, the optimizer's update (its clip when configured), and the
    skip of a step whose loss is not finite.  Under a batch group the loss
    is the global batch's token mean: each rank's summed NLL over the
    group's token count, times the group's size, which DDP / FSDP2 average
    back.  The VCLM draws nothing at random.  Metrics: ``loss`` (device tensor; the
    global mean) and ``step_ok``.  Under a profiler it records the spans
    of ``train.steps``' steps."""
    dtype = getattr(model, "dtype", torch.bfloat16)

    def step(state: TrainState, batch):
        call, model, group, _ = _parallel_parts(state, 0)
        with _phase("prep"):
            video = prep_video(batch["video"], dtype=dtype, model=model)
        with _phase("forward"):
            out = call(video, batch["text"].long())
        with _phase("loss"):
            nll, count = (label_nll(out["logits"], out["labels"])
                          if isinstance(out, dict)
                          else caption_nll(out, batch["text"]))
            world = (dist.get_world_size(group)
                     if group is not None and dist.is_initialized() else 1)
            if world > 1:
                count = count.detach().clone()
                dist.all_reduce(count, group=group)
            loss = nll * world / count.clamp_min(1.0)
            metrics = _group_mean({"loss": loss}, group)
        _backward(state, loss)
        ok = _apply_or_skip(state, metrics["loss"])
        return state, {**metrics, "step_ok": float(ok)}

    return _spanned(step)


def build_model(cfg: TrainConfig, dtype=None) -> torch.nn.Module:
    """The configured narrator (``VCLM_VITB16`` unless ``model.name``
    starts with ``VCLM`` or ``LAVILA``) on the meta device, with
    ``model.vision_heads`` and ``model.text_heads``; the LaViLa narrator
    frozen by LaViLa's recipe."""
    m = cfg.model
    name = (m.name if m.name.startswith(("VCLM", "LAVILA"))
            else "VCLM_VITB16")
    with torch.device("meta"):
        model = create_model(
            name, num_frames=cfg.data.clip_length,
            use_flash_attn=m.use_flash_attn, pipeline=m.pipeline,
            pipeline_microbatches=m.pipeline_microbatches,
            pipeline_remat=m.use_grad_checkpointing,
            vision_heads=m.vision_heads, heads=m.text_heads, dtype=dtype)
    if isinstance(model, LavilaNarrator):
        model.freeze()
    return model


def build_model_and_state(cfg: TrainConfig, niter_per_ep: int,
                          device="cuda", dtype=None,
                          mesh: Optional[Mesh] = None):
    """(model on ``device``, optimizer, lr schedule): weights drawn on the
    CPU from ``torch.Generator().manual_seed(cfg.seed)`` with the flax
    initializers' distributions; layer decay, when configured, over the
    decoder's ``layers``, as the JAX entry passes.  A ``mesh`` with
    ``fsdp`` shards the model (FSDP2) before the optimizer is built over
    it."""
    model = build_model(cfg, dtype).to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.seed)).to(device)
    if mesh is not None:
        shard_model(model, mesh)
    optimizer, schedule = build_optimizer(cfg.optim, model, niter_per_ep,
                                          num_layers=model.layers)
    return model, optimizer, schedule


def build_loader(cfg: TrainConfig, context_length: int,
                 mesh: Optional[Mesh] = None, tokenizer=None):
    """(dataset, ``DataLoader``) of the Ego4D caption layout with random
    resized crops, captions by ``tokenizer`` (``data.tokenizer.tokenize``'s;
    default CLIP's BPE); over a ``mesh`` this rank's batch group's rows."""
    d = cfg.data
    train_ds = VideoCaptionDataset(
        "ego4d", d.root, d.train_metadata, is_training=True,
        clip_length=d.clip_length, chunk_len=d.chunk_len, fps=d.fps,
        threads=d.decode_threads, decode_fast=d.decode_fast,
        context_length=context_length, tokenizer=tokenizer,
        augment=AugmentSpec(crop_size=d.crop_size, mode="rrc",
                            scale_min=d.scale_min, scale_max=d.scale_max))
    loader = DataLoader(
        train_ds, d.batch_size, shuffle=True, drop_last=True,
        num_workers=d.num_workers, prefetch_depth=d.prefetch_depth,
        seed=cfg.seed,
        process_index=mesh.batch_index if mesh is not None else 0,
        process_count=mesh.n_batch_shards if mesh is not None else 1)
    return train_ds, loader


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
    d.root = d.root or os.environ.get("ROOT", "")
    d.train_metadata = d.train_metadata or os.environ.get(
        "TRAIN_METADATA", "")
    return over_mesh(cfg, device, _train)


def _train(cfg: TrainConfig, device: torch.device, mesh: Mesh) -> dict:
    model = build_model(cfg)
    if isinstance(model, LavilaNarrator):
        from avion_tpu_torch.tools.narrator import gpt2_tokenizer

        context, tokenizer = LAVILA_CONTEXT, BosEosIds(gpt2_tokenizer())
    else:
        context, tokenizer = model.context_length, None
    train_ds, train_loader = build_loader(cfg, context, mesh, tokenizer)
    print(f"[data] {len(train_ds)} clips, decode backend "
          f"{default_backend()}, {cfg.data.num_workers} workers, batch "
          f"group {mesh.batch_index} of {mesh.n_batch_shards}")
    # steps per epoch include the echo repeats (the LR schedule spans the
    # true step count)
    niter = max(1, len(train_loader)) * max(1, cfg.data.echo_factor)
    model, optimizer, _ = build_model_and_state(cfg, niter, device=device,
                                                mesh=mesh)
    run = setup_run(cfg, model, optimizer, make_narrator_step(model),
                    mesh=mesh)
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
