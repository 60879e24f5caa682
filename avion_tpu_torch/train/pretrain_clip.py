"""CLIP video-text contrastive pretraining (``avion_tpu.train.pretrain_clip``):
the model, its optional weight import and the optimizer.

The entry's ``main`` and ``build_loaders`` need the datasets and video
decode, which come with the data slice; until then a caller drives
:func:`build_model_and_state`, ``train.steps.make_clip_train_step`` and
``train.loop`` with any iterable of batches in the ``VideoCaptionDataset``
collate contract (see ``chip_smoke.py``'s train phase).
"""

from __future__ import annotations

import os

import torch

from avion_tpu_torch.core.config import TrainConfig
from avion_tpu_torch.models.pt_import import import_clip_pt
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.optim.factory import build_optimizer


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
                          device="cuda", dtype=None):
    """Returns (model on ``device``, optimizer, lr schedule).  Weights are
    drawn on the CPU from ``torch.Generator().manual_seed(cfg.seed)`` with
    the flax initializers' distributions (so a seed gives the same weights
    on every device), then ``pretrain_model`` is merged in with
    ``strict=False`` (missing keys keep their init)."""
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
    optimizer, schedule = build_optimizer(cfg.optim, model, niter_per_ep)
    return model, optimizer, schedule
