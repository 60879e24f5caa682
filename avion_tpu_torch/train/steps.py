"""The train steps (``avion_tpu.train.steps``): CLIP's (loss ``"clip"`` or
``"siglip"``), CLIP's cached gradient accumulation over microbatches,
EK100-MIR's finetune step (max-margin ranking loss), VideoMAE's
pretraining step and the classification finetune step: forward, loss,
backward, gradient clip, the optimizer's update (CLIP's logit-scale clamp,
the finetune's EMA), and the skip of a step whose loss is not finite.

The JAX step is one jitted function that selects the old or the new state
on device.  Here the update happens in place, so the step reads
``isfinite(loss)`` on the host once per step (one device synchronization)
and, when it is false, leaves the parameters, the Adam moments and the
optimizer's update count as they were; ``state.step`` advances either way,
as in the JAX package.  Each step's random draws (patch dropout,
DropPath, tube masks, mixup) come from a generator on the model's device
seeded from (``seed``, ``state.step``), as the JAX steps fold the step
into their key.

Under a mesh (``state.parallel``, ``parallel.sharding.Parallel``) every
step calls the wrapped model (DDP's, or the FSDP2 module) and reduces the
gradients once an update: the cached accumulation's first M - 1 backwards
run without synchronization.  The step sees the global batch, as the JAX
step does: the contrastive and max-margin losses gather the embeddings
over the batch group; the classification and VideoMAE losses are means
over each rank's rows (equal counts, so their average over the ranks is
the global mean), and their logged metrics are means over the group.  A
step is skipped on every rank alike, on the group's loss.  Each batch
group seeds its draws (patch dropout, DropPath, tube masks) with its index
folded in, so the groups' rows draw different masks while the ``sp`` ranks
of a group draw the same; mixup / cutmix draws alike on every rank and
mixes the global batch (``train.augment_device``).

Under a profiler each step records the span ``avion.step`` and, inside it
and in this order, its phases (``core.profiling.span``):
``avion.step.prep`` (the batch onto the model's input, the generator, the
masks and mixup), ``.forward`` (the model), ``.loss`` (the loss, the MoE
router terms, the metrics' mean over the batch group), ``.backward``
(``zero_grad``, ``backward()``, the mesh's reduction) and ``.update``
(the gradient norm, the optimizer's update, the logit-scale clamp, the
EMA), which holds ``.read``, the host's read of ``isfinite(loss)``.  The
cached accumulation repeats prep, forward, loss and backward once a
microbatch.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from avion_tpu_torch.core.profiling import span
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD,
                                             OPENAI_MEAN, OPENAI_STD,
                                             normalize_video, tube_mask_device)
from avion_tpu_torch.losses.losses import (clip_loss, gather_batch,
                                           max_margin_ranking_loss,
                                           siglip_loss, siglip_loss_chunked,
                                           soft_target_cross_entropy,
                                           softmax_cross_entropy,
                                           videomae_loss)
from avion_tpu_torch.ops.fused_input import crop_resize_flip_normalize
from avion_tpu_torch.ops.moe import moe_metrics

LOGIT_SCALE_MAX = 4.6052  # ln(100); scripts/main_lavila_pretrain.py:880


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s random draws under base ``seed``: the
    JAX step folds ``state.step`` into its key, so step k draws the same
    patch-dropout mask whether or not the run was resumed before it.  The
    CPU generator keeps only the low 32 bits of a seed, so those mix the
    base seed (times an odd constant, one to one modulo 2**32) with the
    step; the high 32 bits, which the CUDA generator also reads, hold the
    base seed."""
    seed &= 0xFFFFFFFF
    return (seed << 32) | ((seed * 0x9E3779B1 + step) & 0xFFFFFFFF)


def prep_video(video: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
               batch=None, model=None, crop_size=None, *, mean=None,
               std=None) -> torch.Tensor:
    """Normalize a uint8 batch on its device with ``mean`` / ``std``
    (default OpenAI's); float input passes through (already normalized).
    A model built with ``input_norm`` takes the uint8 batch itself and
    normalizes inside its stem.  When the batch carries host-sampled crop
    parameters (``crop``/``hflip``) and ``crop_size`` is given, crop +
    resize + flip + normalize run on the device (``ops/fused_input``)."""
    mean = mean if mean is not None else OPENAI_MEAN
    std = std if std is not None else OPENAI_STD
    if batch is not None and "crop" in batch and crop_size is not None:
        return crop_resize_flip_normalize(
            video, batch["crop"], batch.get("hflip"),
            out_size=(crop_size, crop_size), mean=mean, std=std, dtype=dtype)
    if video.dtype == torch.uint8:
        if model is not None and getattr(model, "input_norm", "none") != "none":
            return video
        return normalize_video(video, mean, std, dtype)
    return video


def _step_generator(model: torch.nn.Module, seed: int,
                    step: int) -> torch.Generator:
    generator = torch.Generator(next(model.parameters()).device)
    generator.manual_seed(step_seed(seed, step))
    return generator


def _parallel_parts(state: TrainState, seed: int):
    """(the model to call, the module to read, the loss's batch group, the
    seed of this rank's draws) of ``state``."""
    par = state.parallel
    if par is None:
        return state.model, state.model, None, seed
    return (par.model, par.module, par.mesh.batch_group,
            seed + 1000003 * par.mesh.batch_index)


def _finish_backward(state: TrainState) -> None:
    if state.parallel is not None:
        state.parallel.finish_backward()


def _phase(name: str) -> span:
    """The step's phase ``name``, the span ``avion.step.<name>``."""
    return span("avion.step." + name)


def _spanned(step: Callable) -> Callable:
    """``step`` inside the span ``avion.step``, which holds its phases."""

    @functools.wraps(step)
    def spanned(state: TrainState, batch):
        with span("avion.step"):
            return step(state, batch)

    return spanned


def _backward(state: TrainState, objective: torch.Tensor,
              zero_grad: bool = True, finish: bool = True) -> None:
    """The phase ``backward``: the gradients cleared (``zero_grad``),
    ``objective.backward()``, and with ``finish`` the mesh's reduction."""
    with _phase("backward"):
        if zero_grad:
            state.optimizer.zero_grad()
        objective.backward()
        if finish:
            _finish_backward(state)


def _group_mean(values: Dict[str, torch.Tensor],
                group) -> Dict[str, torch.Tensor]:
    """``values`` (scalars of this rank's rows, detached) as their means
    over the batch ``group``, whose ranks hold as many rows each: one
    all-reduce; themselves without a group of more than one."""
    values = {k: v.detach() for k, v in values.items()}
    if group is None or not dist.is_initialized() \
            or dist.get_world_size(group) == 1:
        return values
    flat = torch.stack([v.float() for v in values.values()])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return dict(zip(values, flat.unbind()))


@torch.no_grad()
def _clamp_logit_scale(model: torch.nn.Module) -> None:
    if hasattr(model, "logit_scale"):
        model.logit_scale.clamp_(0.0, LOGIT_SCALE_MAX)


def _apply_or_skip(state: TrainState, loss: torch.Tensor,
                   ema_decay: Optional[float] = None,
                   clip_metrics: Optional[dict] = None) -> bool:
    """The phase ``update`` after the backward: when the loss is finite
    (the step's one host read, the phase ``read``), hand the gradients to
    the optimizer (which clips and updates, or under ``update_freq``
    accumulates) and average the parameters into the EMA; else leave all
    of it.  ``state.step`` advances either way.  A CLIP step passes its
    ``clip_metrics``: the gradients' global norm joins them as
    ``grad_norm`` (the optimizer clips by it), and an applied update
    clamps the logit scale."""
    with _phase("update"):
        grad_norm = None
        if clip_metrics is not None:
            grad_norm = clip_metrics["grad_norm"] = \
                state.optimizer.global_norm()
        with _phase("read"):
            ok = bool(torch.isfinite(loss))
        if ok:
            state.optimizer.update(grad_norm)
            if clip_metrics is not None:
                _clamp_logit_scale(state.model)
            if state.ema is not None and ema_decay is not None:
                state.update_ema(ema_decay)
        state.step += 1
    return ok


def _contrastive_loss(model: torch.nn.Module, loss_type: str,
                      label_smoothing: float, siglip_chunked: bool
                      ) -> Callable:
    """``loss(image_embed, text_embed, scale, bias, group) -> {"loss",
    "clip_acc"}`` over the batch ``group`` (None: these rows alone) for
    ``loss_type`` ``clip`` or ``siglip`` (which needs a model built with
    ``use_logit_bias``)."""
    if loss_type == "clip":
        return lambda zi, zt, scale, bias, group: clip_loss(
            zi, zt, scale, label_smoothing, group)
    if loss_type != "siglip":
        raise ValueError(f"unknown loss_type {loss_type!r}")
    if getattr(model, "logit_bias", None) is None:
        raise ValueError("loss_type 'siglip' needs a model built with "
                         "use_logit_bias=True")
    return siglip_loss_chunked if siglip_chunked else siglip_loss


def _finish_clip_step(state: TrainState, metrics: dict) -> dict:
    """After the backward: ``grad_norm``, the update or its skip, the
    logit-scale clamp; ``metrics`` detached, with ``step_ok``."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    ok = _apply_or_skip(state, metrics["loss"], clip_metrics=metrics)
    metrics["step_ok"] = float(ok)
    return metrics


def _add_moe(model: torch.nn.Module, metrics: dict, aux_weight: float,
             zloss_weight: float, scale: float = 1.0) -> torch.Tensor:
    """The router losses of a MoE tower's last forward added to
    ``metrics["loss"]`` (and their metrics to ``metrics``, as the JAX step
    reads its collections); returns the objective to differentiate, where
    the router terms count ``scale`` times (1 / M in each of the cached
    accumulation's M passes)."""
    moe = moe_metrics(model, aux_weight, zloss_weight)
    if moe is None:
        return metrics["loss"]
    objective = moe.pop("objective")
    obj = metrics["loss"] + scale * objective
    metrics["loss"] = metrics["loss"] + objective
    metrics.update(moe)
    return obj


def make_clip_train_step(model: torch.nn.Module,
                         label_smoothing: float = 0.0,
                         crop_size: Optional[int] = None,
                         seed: int = 1, loss_type: str = "clip",
                         siglip_chunked: bool = True,
                         moe_aux_weight: float = 0.01,
                         moe_zloss_weight: float = 0.0) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.
    ``batch``: ``video`` [B, T, H, W, 3] (uint8 or normalized float) and
    ``text`` [B, L] token ids on the model's device (with ``crop`` /
    ``hflip``, the clip is cropped to ``crop_size`` on the device).  Patch
    dropout draws from a generator on the model's device seeded from
    (``seed``, ``state.step``) (:func:`step_seed`); the entry passes
    ``cfg.seed + 1``, which the default is for the default seed 0.
    ``loss_type``: ``clip`` (InfoNCE) or ``siglip`` (the model's
    ``logit_bias`` learned; ``siglip_chunked`` takes the ring form, which
    on one process is the dense loss).  Metrics: ``loss``, ``clip_acc``,
    ``logit_scale`` and ``grad_norm`` as device tensors, ``step_ok`` as a
    float.  The update is the state's optimizer's (the JAX package's step
    takes it as ``tx``).  A MoE tower's router losses join the loss,
    ``moe_aux_weight * moe_aux`` and, with ``moe_zloss_weight`` > 0,
    ``moe_zloss_weight * moe_zloss``, and the metrics add ``moe_aux``
    (``moe_zloss``), ``moe_load_max``, ``moe_load_min`` and
    ``moe_overflow`` (``ops.moe.moe_metrics``)."""
    dtype = getattr(model, "dtype", torch.bfloat16)
    loss_fn = _contrastive_loss(model, loss_type, label_smoothing,
                                siglip_chunked)

    def step(state: TrainState, batch):
        call, model, group, rank_seed = _parallel_parts(state, seed)
        with _phase("prep"):
            generator = _step_generator(model, rank_seed, state.step)
            video = prep_video(batch["video"], dtype=dtype, batch=batch,
                               model=model, crop_size=crop_size)
        with _phase("forward"):
            out = call(video, batch["text"].long(), deterministic=False,
                       generator=generator)
        with _phase("loss"):
            metrics = loss_fn(out["image_embed"], out["text_embed"],
                              out["logit_scale"], out.get("logit_bias"),
                              group)
            metrics["logit_scale"] = out["logit_scale"]
            obj = _add_moe(model, metrics, moe_aux_weight, moe_zloss_weight)
        _backward(state, obj)
        return state, _finish_clip_step(state, metrics)

    return _spanned(step)


def make_clip_accum_train_step(model: torch.nn.Module, update_freq: int,
                               label_smoothing: float = 0.0,
                               crop_size: Optional[int] = None,
                               seed: int = 1, loss_type: str = "clip",
                               siglip_chunked: bool = True,
                               moe_aux_weight: float = 0.01,
                               moe_zloss_weight: float = 0.0) -> Callable:
    """Cached gradient accumulation (``avion_tpu.train.steps.
    make_clip_accum_train_step``): the contrastive loss of the whole batch
    at one microbatch's activation memory, for one extra forward.
    ``step(state, batch) -> (state, metrics)``; ``batch`` arrives
    microbatch-major, each entry [M, B / M, ...] with M = ``update_freq``
    (``train.loop`` reshapes it).

    - Pass 1, without gradients (the inference attention kernel), caches
      every microbatch's image and text embeddings, [B, E] each; under a
      mesh each microbatch's rows are gathered over the batch group, so
      the cache holds the global batch, microbatch-major.
    - Pass 2 re-encodes microbatch m with gradients (the forward with lse
      and the backward), splices its rows into the cached matrices out of
      place, takes the loss of the whole batch and calls ``backward()``;
      each row is live in exactly one pass, so the gradient accumulated
      over the M passes is the whole batch's.  Under a mesh the live rows
      are gathered with a summing backward, and only the last pass's
      backward reduces the gradients across the ranks.  The logit scale
      (and bias) are live only at m = 0, else their gradient would be M
      times too large.
    - Microbatch m draws its patch dropout from a generator seeded from
      (``seed``, ``state.step * M + m``) in both passes, so the live rows
      reproduce the cached ones.
    - Metrics (``loss``, ``clip_acc``, ``logit_scale``) are the mean over
      the passes, ``grad_norm`` the norm of the accumulated gradient; one
      update (or its skip) and one host read a call, as
      :func:`make_clip_train_step`.
    - A MoE tower's router losses of pass m count 1 / M in its objective,
      so the accumulated gradient is the one-shot step's; the reported
      loss carries them whole (the JAX step's rule)."""
    micro = int(update_freq)
    dtype = getattr(model, "dtype", torch.bfloat16)
    loss_fn = _contrastive_loss(model, loss_type, label_smoothing,
                                siglip_chunked)

    def step(state: TrainState, batch):
        call, model, group, rank_seed = _parallel_parts(state, seed)

        def encode(m: int, fn) -> dict:
            with _phase("prep"):
                mb = {k: v[m] for k, v in batch.items()}
                video = prep_video(mb["video"], dtype=dtype, batch=mb,
                                   model=model, crop_size=crop_size)
                generator = _step_generator(model, rank_seed,
                                            state.step * micro + m)
            with _phase("forward"):
                return fn(video, mb["text"].long(), deterministic=False,
                          generator=generator)

        with torch.no_grad():
            cached = [encode(m, model) for m in range(micro)]
            with _phase("forward"):
                zi = torch.cat([gather_batch(c["image_embed"], group)
                                for c in cached])
                zt = torch.cat([gather_batch(c["text_embed"], group)
                                for c in cached])
        del cached
        rows = zi.shape[0] // micro
        state.optimizer.zero_grad()
        total = None
        for m in range(micro):
            last = m == micro - 1
            with (contextlib.nullcontext() if last or state.parallel is None
                  else state.parallel.no_sync()):
                out = encode(m, call)
                with _phase("loss"):
                    live = slice(m * rows, (m + 1) * rows)
                    zi_m = torch.slice_scatter(
                        zi, gather_batch(out["image_embed"],
                                         group).to(zi.dtype),
                        start=live.start, end=live.stop)
                    zt_m = torch.slice_scatter(
                        zt, gather_batch(out["text_embed"],
                                         group).to(zt.dtype),
                        start=live.start, end=live.stop)
                    scale, bias = out["logit_scale"], out.get("logit_bias")
                    if m:
                        scale = scale.detach()
                        bias = None if bias is None else bias.detach()
                    # the cache is the global batch already
                    metrics = loss_fn(zi_m, zt_m, scale, bias, None)
                    obj = _add_moe(model, metrics, moe_aux_weight,
                                   moe_zloss_weight, 1.0 / micro)
                _backward(state, obj, zero_grad=False, finish=last)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["logit_scale"] = out["logit_scale"].detach()
            del obj
            total = metrics if total is None else {
                k: total[k] + v for k, v in metrics.items()}
            del out, zi_m, zt_m
        return state, _finish_clip_step(
            state, {k: v / micro for k, v in total.items()})

    return _spanned(step)


def make_mir_finetune_step(model: torch.nn.Module, margin: float = 0.2,
                           seed: int = 1) -> Callable:
    """EK100-MIR finetune: ``step(state, batch) -> (state, metrics)``.
    ``batch``: ``video`` and ``text`` as for :func:`make_clip_train_step`;
    the model runs in train mode, its patch dropout and DropPath drawing
    from (``seed``, ``state.step``), and the loss is
    :func:`max_margin_ranking_loss` of its embeddings (over the batch
    group's global batch under a mesh).  Unlike the CLIP step there is no
    logit-scale clamp (the JAX step has none), and the logit scale gets no
    gradient.  Metrics: ``loss``, ``max_margin_loss`` (device tensors) and
    ``step_ok``."""
    dtype = getattr(model, "dtype", torch.bfloat16)

    def step(state: TrainState, batch):
        call, model, group, rank_seed = _parallel_parts(state, seed)
        with _phase("prep"):
            generator = _step_generator(model, rank_seed, state.step)
            video = prep_video(batch["video"], dtype=dtype, model=model)
        with _phase("forward"):
            out = call(video, batch["text"].long(), deterministic=False,
                       generator=generator)
        with _phase("loss"):
            loss = max_margin_ranking_loss(
                out["image_embed"], out["text_embed"], margin=margin,
                group=group)["loss"]
        _backward(state, loss)
        ok = _apply_or_skip(state, loss)
        return state, {"loss": loss.detach(),
                       "max_margin_loss": loss.detach(),
                       "step_ok": float(ok)}

    return _spanned(step)


def make_videomae_train_step(model: torch.nn.Module, patch_size: int = 16,
                             tubelet_size: int = 2,
                             normalize_target: bool = True,
                             regen_mask: bool = False,
                             seed: int = 1) -> Callable:
    """VideoMAE pretraining: ``step(state, batch) -> (state, metrics)``.
    ``batch``: ``video`` [B, T, H, W, 3] (uint8, normalized here with the
    ImageNet statistics, or normalized float) and ``mask`` [B, N] bool.
    ``regen_mask`` draws the tube masks on the device instead (under data
    echoing the repeats of a batch would otherwise reconstruct the same
    tokens).  The masks and DropPath draw from (``seed``, ``state.step``).
    Every row must mask the model's count of tokens: the loss is a mean
    over this rank's masked tokens, which averages to the global batch's
    mean over the ranks only then (checked on the device, without a host
    read).  Metrics: ``loss`` (device tensor; the group's mean) and
    ``step_ok``."""
    dtype = getattr(model, "dtype", torch.bfloat16)
    n_masked = model.num_patches - model.n_visible

    def step(state: TrainState, batch):
        call, model, group, rank_seed = _parallel_parts(state, seed)
        with _phase("prep"):
            generator = _step_generator(model, rank_seed, state.step)
            video = prep_video(batch["video"], dtype, mean=IMAGENET_MEAN,
                               std=IMAGENET_STD)
            mask = batch["mask"]
            if regen_mask:
                b, t, h, w, _ = video.shape
                mask = tube_mask_device(generator, b, t // tubelet_size,
                                        h // patch_size, w // patch_size,
                                        model.mask_ratio, video.device)
            torch._assert_async((mask.sum(dim=-1) == n_masked).all(),
                                f"every row must mask {n_masked} tokens")
        with _phase("forward"):
            pred, masked_idx = call(video, mask, deterministic=False,
                                    generator=generator)
        with _phase("loss"):
            loss = videomae_loss(pred, video, masked_idx, patch_size,
                                 tubelet_size, normalize_target)["loss"]
            metrics = _group_mean({"loss": loss}, group)
        _backward(state, loss)
        ok = _apply_or_skip(state, metrics["loss"])
        return state, {**metrics, "step_ok": float(ok)}

    return _spanned(step)


def make_cls_train_step(model: torch.nn.Module, label_smoothing: float = 0.0,
                        ema_decay: Optional[float] = None,
                        mixup_fn: Optional[Callable] = None,
                        seed: int = 1) -> Callable:
    """Classification finetune: ``step(state, batch) -> (state, metrics)``.
    ``batch["label"]`` holds int labels [B] or soft targets [B, classes];
    ``video`` is normalized with OpenAI's statistics, as the JAX step does.
    ``mixup_fn(generator, video, labels, group=...) -> (video, soft
    targets)`` mixes int-labelled batches on the device, the global batch
    over the batch group.  With ``ema_decay`` and a state that carries an
    EMA, the average follows each applied update.  Mixup draws from
    (``seed``, ``state.step``) alike on every rank; DropPath continues that
    generator on batch group 0 (and on one process) and draws from its own
    on the other groups.  Metrics: ``loss`` and ``acc1`` (device tensors;
    the group's means) and ``step_ok``."""
    dtype = getattr(model, "dtype", torch.bfloat16)

    def step(state: TrainState, batch):
        call, model, group, rank_seed = _parallel_parts(state, seed)
        with _phase("prep"):
            generator = _step_generator(model, seed, state.step)
            video = prep_video(batch["video"], dtype=dtype)
            label = batch["label"]
            if mixup_fn is not None and label.dim() == 1:
                video, label = mixup_fn(generator, video, label, group=group)
            if rank_seed != seed:
                generator = _step_generator(model, rank_seed, state.step)
        with _phase("forward"):
            logits = call(video, deterministic=False, generator=generator)
        with _phase("loss"):
            if label.dim() == logits.dim():
                loss = soft_target_cross_entropy(logits, label)
                hard = label.argmax(dim=-1)
            else:
                loss = softmax_cross_entropy(logits, label.long(),
                                             label_smoothing)
                hard = label
            acc = 100.0 * (logits.detach().argmax(dim=-1)
                           == hard).float().mean()
            metrics = _group_mean({"loss": loss, "acc1": acc}, group)
        _backward(state, loss)
        ok = _apply_or_skip(state, metrics["loss"], ema_decay)
        return state, {**metrics, "step_ok": float(ok)}

    return _spanned(step)
