"""The CLIP train step (``avion_tpu.train.steps.make_clip_train_step``,
loss ``"clip"``): forward, loss, backward, gradient clip, AdamW update,
logit-scale clamp, and the skip of a step whose loss is not finite.

The JAX step is one jitted function that selects the old or the new state
on device.  Here the update happens in place, so the step reads
``isfinite(loss)`` on the host once per step (one device synchronization)
and, when it is false, leaves the parameters, the Adam moments and the
optimizer's update count as they were; ``state.step`` advances either way,
as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.data.transforms import (OPENAI_MEAN, OPENAI_STD,
                                             normalize_video)
from avion_tpu_torch.losses.losses import clip_loss
from avion_tpu_torch.ops.fused_input import crop_resize_flip_normalize

LOGIT_SCALE_MAX = 4.6052  # ln(100); scripts/main_lavila_pretrain.py:880


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s random draws under base ``seed``: the
    JAX step folds ``state.step`` into its key, so step k draws the same
    patch-dropout mask whether or not the run was resumed before it."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def prep_video(video: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
               batch=None, model=None, crop_size=None) -> torch.Tensor:
    """Normalize a uint8 batch on its device; float input passes through
    (already normalized).  A model built with ``input_norm`` takes the
    uint8 batch itself and normalizes inside its stem.  When the batch
    carries host-sampled crop parameters (``crop``/``hflip``) and
    ``crop_size`` is given, crop + resize + flip + normalize run on the
    device (``ops/fused_input``)."""
    if batch is not None and "crop" in batch and crop_size is not None:
        return crop_resize_flip_normalize(
            video, batch["crop"], batch.get("hflip"),
            out_size=(crop_size, crop_size), dtype=dtype)
    if video.dtype == torch.uint8:
        if model is not None and getattr(model, "input_norm", "none") != "none":
            return video
        return normalize_video(video, OPENAI_MEAN, OPENAI_STD, dtype)
    return video


@torch.no_grad()
def _clamp_logit_scale(model: torch.nn.Module) -> None:
    if hasattr(model, "logit_scale"):
        model.logit_scale.clamp_(0.0, LOGIT_SCALE_MAX)


def make_clip_train_step(model: torch.nn.Module,
                         label_smoothing: float = 0.0,
                         crop_size: Optional[int] = None,
                         seed: int = 1) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.
    ``batch``: ``video`` [B, T, H, W, 3] (uint8 or normalized float) and
    ``text`` [B, L] token ids on the model's device (with ``crop`` /
    ``hflip``, the clip is cropped to ``crop_size`` on the device).  Patch
    dropout draws from a generator on the model's device seeded from
    (``seed``, ``state.step``) (:func:`step_seed`); the entry passes
    ``cfg.seed + 1``, which the default is for the default seed 0.
    Metrics: ``loss``, ``clip_acc``, ``logit_scale`` and ``grad_norm`` as
    device tensors, ``step_ok`` as a float.  The update is the state's
    optimizer's (the JAX package's step takes it as
    ``tx``).  The loss is ``clip``; SigLIP waits for a later slice."""
    dtype = getattr(model, "dtype", torch.bfloat16)

    def step(state: TrainState, batch):
        model, opt = state.model, state.optimizer
        generator = torch.Generator(next(model.parameters()).device)
        generator.manual_seed(step_seed(seed, state.step))
        video = prep_video(batch["video"], dtype=dtype, batch=batch,
                           model=model, crop_size=crop_size)
        out = model(video, batch["text"].long(), deterministic=False,
                    generator=generator)
        metrics = clip_loss(out["image_embed"], out["text_embed"],
                            out["logit_scale"], label_smoothing)
        metrics["logit_scale"] = out["logit_scale"].detach()
        loss = metrics["loss"]
        opt.zero_grad()
        loss.backward()
        metrics["grad_norm"] = opt.global_norm()
        ok = bool(torch.isfinite(loss))  # the step's one host read
        if ok:
            opt.update(metrics["grad_norm"])
            _clamp_logit_scale(model)
        state.step += 1
        metrics["loss"] = loss.detach()
        metrics["step_ok"] = float(ok)
        return state, metrics

    return step
