"""Training-run harness (``avion_tpu.train.loop``): set up the run with
auto-resume, train one epoch over any iterable loader, save, and stop
cleanly on preemption.

One device, no mesh: a ``cfg.mesh`` that asks for more than one device
raises until the parallel slice.  The JAX package's resume semantics are
kept: a mid-epoch preemption checkpoint records the batches consumed, a
resumed epoch skips them (rounded down to a whole echo group under data
echoing), and the preemption save waits for an echo-group boundary so
the optimizer's update count matches the resume point exactly.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from avion_tpu_torch.core.checkpoint import Checkpointer
from avion_tpu_torch.core.config import TrainConfig
from avion_tpu_torch.core.logging import MetricLogger
from avion_tpu_torch.core.meters import AverageMeter, ProgressMeter, StepTimer
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.data.loader import device_prefetch, echo_batches
from avion_tpu_torch.parallel.launch import preempted


@dataclass
class Run:
    cfg: TrainConfig
    device: torch.device
    state: TrainState
    step: Callable
    ckpt: Checkpointer
    logger: MetricLogger
    start_epoch: int = 0
    # mid-epoch resume: batches of start_epoch consumed before a
    # preemption checkpoint (wired to the loader's skip_batches)
    start_batch: int = 0


def _one_device(cfg: TrainConfig) -> None:
    m = cfg.mesh
    sizes = {"data": 1 if m.data == -1 else m.data, "fsdp": m.fsdp,
             "pp": m.pp, "sp": m.sp, "ep": m.ep, "tensor": m.tensor,
             "dcn_data": m.dcn_data}
    wide = {k: v for k, v in sizes.items() if v != 1}
    if wide:
        raise NotImplementedError(
            f"mesh {wide}: the PyTorch port trains on one device until the "
            f"parallel slice")


def setup_run(cfg: TrainConfig, model: torch.nn.Module, optimizer,
              step_fn: Callable) -> Run:
    """``model`` on its device and ``optimizer`` over its parameters
    (``pretrain_clip.build_model_and_state``); restores the newest
    checkpoint under ``<output_dir>/ckpt`` when ``resume`` or
    ``auto_resume`` is set."""
    _one_device(cfg)
    device = next(model.parameters()).device
    state = TrainState.create(model, optimizer)
    ckpt = Checkpointer(os.path.join(cfg.output_dir, "ckpt"))
    logger = MetricLogger(cfg.output_dir, cfg.wandb, cfg.wandb_project,
                          cfg.run_name, cfg.to_dict())
    start_epoch, start_batch = 0, 0
    if cfg.resume or cfg.auto_resume:
        restored, extra = ckpt.restore(state)
        if restored is not None:
            start_epoch = (extra or {}).get("epoch", 0)
            start_batch = (extra or {}).get("batch_in_epoch", 0)
            print(f"[resume] restored step {state.step} "
                  f"(epoch {start_epoch}"
                  + (f", batch {start_batch}" if start_batch else "") + ")")
    return Run(cfg, device, state, step_fn, ckpt, logger, start_epoch,
               start_batch)


def train_one_epoch(run: Run, loader, epoch: int) -> Dict[str, float]:
    """Steps over ``loader`` (an iterable of dicts of numpy arrays),
    echoing each batch ``cfg.data.echo_factor`` times.  Metrics reach the
    host every ``print_freq`` steps; the returned epoch summary averages
    every step."""
    cfg = run.cfg
    meters = {"loss": AverageMeter("loss", ":.4f")}
    timer = StepTimer()
    echo = max(1, cfg.data.echo_factor)
    n_batches = len(loader) * echo if hasattr(loader, "__len__") else 0
    progress = ProgressMeter(
        n_batches, [timer.batch_time, timer.data_time, meters["loss"]],
        prefix=f"Epoch [{epoch}] ")

    # batches of this epoch consumed before this process started; the
    # loop counter i is relative to THIS process, so a second preemption
    # must checkpoint skipped + i
    skipped = 0
    if run.start_batch and epoch == run.start_epoch \
            and hasattr(loader, "skip_batches"):
        skipped = (run.start_batch // echo) * echo
        loader.skip_batches = skipped // echo
        run.start_batch = 0
        print(f"[resume] skipping {skipped} consumed steps "
              f"({loader.skip_batches} batches)")

    it = echo_batches(iter(device_prefetch(loader, run.device, depth=2)),
                      echo)
    msum, mcount = None, 0
    i = -1
    while True:
        t_fetch = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        timer.data_time.update(time.perf_counter() - t_fetch)
        i += 1
        if preempted() and (skipped + i) % echo == 0:
            # checkpoint mid-epoch at an echo-group boundary and stop;
            # auto-resume continues at the next batch of this epoch
            save_epoch(run, epoch - 1, batch_in_epoch=skipped + i)
            run.ckpt.wait()
            break
        run.state, metrics = run.step(run.state, batch)
        msum = dict(metrics) if msum is None else {
            k: msum[k] + v for k, v in metrics.items()}
        mcount += 1
        if i % cfg.print_freq == 0:
            loss = float(metrics["loss"])
            timer.mark_window(min(i + 1, cfg.print_freq))
            meters["loss"].update(loss)
            for k, v in metrics.items():
                if k != "loss":
                    meters.setdefault(k, AverageMeter(k, ":.4f")).update(
                        float(v))
            progress.display(i)
            run.logger.log(
                {"train/loss": loss, "train/epoch": epoch,
                 **{f"train/{k}": float(v) for k, v in metrics.items()
                    if k != "loss"},
                 **{f"perf/{k}": v for k, v in timer.stats().items()}},
                step=run.state.step)
    if msum is not None:
        last = {k: float(v) / mcount for k, v in msum.items()}
    else:
        last = {k: m.avg for k, m in meters.items()}
    last.update(timer.stats())
    return last


def finish_if_preempted(run: Run, epoch: int,
                        metrics: Optional[dict] = None) -> bool:
    """Entry-loop guard after ``train_one_epoch``: True when a preemption
    signal fired.  A signal that fired after the epoch's last batch saves
    the epoch boundary here, so no completed work is replayed."""
    if not preempted():
        return False
    run.ckpt.wait()
    latest = run.ckpt.latest_step()
    if latest is None or latest < run.state.step:
        save_epoch(run, epoch, metrics)
        run.ckpt.wait()
    return True


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, (np.integer, int)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        return float(obj)
    return obj


def save_epoch(run: Run, epoch: int, metrics: Optional[dict] = None,
               is_best: bool = False, batch_in_epoch: int = 0) -> None:
    """``batch_in_epoch > 0`` marks a mid-epoch (preemption) checkpoint:
    resume re-enters epoch ``epoch + 1`` skipping that many batches."""
    extra = {"epoch": epoch + 1, "config": run.cfg.to_dict(),
             "metrics": metrics or {}, "is_best": is_best}
    if batch_in_epoch:
        extra["batch_in_epoch"] = int(batch_in_epoch)
    run.ckpt.save(run.state.step, run.state, extra=_jsonable(extra))
