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

from typing import Callable

import torch

from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.data.transforms import (OPENAI_MEAN, OPENAI_STD,
                                             normalize_video)
from avion_tpu_torch.losses.losses import clip_loss

LOGIT_SCALE_MAX = 4.6052  # ln(100); scripts/main_lavila_pretrain.py:880


def prep_video(video: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
               batch=None, model=None) -> torch.Tensor:
    """Normalize a uint8 batch on its device; float input passes through
    (already normalized).  A model built with ``input_norm`` takes the
    uint8 batch itself and normalizes inside its stem.  Batches carrying
    crop parameters (device-side crop/resize/flip) wait for the data
    slice."""
    if batch is not None and "crop" in batch:
        raise NotImplementedError(
            "device-side crop/resize (ops/fused_input) is not in the "
            "PyTorch port yet")
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
                         label_smoothing: float = 0.0) -> Callable:
    """Returns ``step(state, batch, generator=None) -> (state, metrics)``.
    ``batch``: ``video`` [B, T, H, W, 3] (uint8 or normalized float) and
    ``text`` [B, L] token ids on the model's device; ``generator`` feeds
    patch dropout.  Metrics: ``loss``, ``clip_acc``, ``logit_scale`` and
    ``grad_norm`` as device tensors, ``step_ok`` as a float.  The update
    is the state's optimizer's (the JAX package's step takes it as
    ``tx``).  The loss is ``clip``; SigLIP waits for a later slice."""
    dtype = getattr(model, "dtype", torch.bfloat16)

    def step(state: TrainState, batch, generator=None):
        model, opt = state.model, state.optimizer
        video = prep_video(batch["video"], dtype=dtype, batch=batch,
                           model=model)
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
