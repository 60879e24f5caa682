"""The port's training loop on the CPU with an in-memory loader: set up,
train, save, resume (step, parameters and optimizer state come back
exactly), data echoing, and the preemption save at an echo-group
boundary with the mid-epoch resume that follows it."""

import json
import os

import numpy as np
import pytest
import torch

from avion_tpu_torch.core.config import TrainConfig
from avion_tpu_torch.data.loader import device_prefetch, echo_batches
from avion_tpu_torch.parallel import launch
from avion_tpu_torch.train.loop import (finish_if_preempted, save_epoch,
                                        setup_run, train_one_epoch)
from avion_tpu_torch.train.pretrain_clip import build_model_and_state
from avion_tpu_torch.train.steps import make_clip_train_step


class Loader:
    """Seeded batches in the VideoCaptionDataset collate contract, with the
    DataLoader's ``skip_batches`` resume hook."""

    def __init__(self, n=4, seed=0):
        rs = np.random.RandomState(seed)
        self.batches = [
            {"video": rs.randint(0, 256, (4, 2, 32, 32, 3), np.uint8),
             "text": rs.randint(1, 49000, (4, 77)).astype(np.int32)}
            for _ in range(n)]
        self.skip_batches = 0
        self.served = []

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        skip, self.skip_batches = self.skip_batches, 0
        for i in range(skip, len(self.batches)):
            self.served.append(i)
            yield self.batches[i]


def _run(tmp_path, *overrides):
    cfg = TrainConfig().apply_overrides([
        "model.name=CLIP_TINY", "data.clip_length=2", "data.batch_size=4",
        "model.use_grad_checkpointing=true", "optim.grad_clip_norm=1.0",
        "optim.lr=1e-3", f"output_dir={tmp_path}", "print_freq=1",
        *overrides])
    model, opt, _ = build_model_and_state(cfg, 4, device="cpu")
    return setup_run(cfg, model, opt, make_clip_train_step(model))


def _state(run):
    return ({k: v.clone() for k, v in run.state.model.state_dict().items()},
            run.state.optimizer.state_dict())


def test_train_save_resume_restores_everything(tmp_path):
    run = _run(tmp_path)
    metrics = train_one_epoch(run, Loader(), 0)
    assert run.state.step == 4 and run.state.optimizer.count == 4
    assert np.isfinite(metrics["loss"]) and metrics["step_ok"] == 1.0
    save_epoch(run, 0, metrics)
    params, opt = _state(run)
    assert os.path.exists(tmp_path / "ckpt" / "4" / "state.pt")
    with open(tmp_path / "log.jsonl") as f:
        assert len(f.readlines()) == 4

    again = _run(tmp_path, "seed=1")  # other init, then the checkpoint
    assert again.state.step == 4 and again.start_epoch == 1
    got_params, got_opt = _state(again)
    for k in params:
        assert torch.equal(got_params[k], params[k]), k
    assert got_opt["count"] == opt["count"] == 4
    for i, s in opt["adamw"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got_opt["adamw"]["state"][i][k], v), (i, k)
    # the restored run trains on identically
    for r in (run, again):
        train_one_epoch(r, Loader(1, seed=5), 1)
    assert all(torch.equal(a, b) for a, b in zip(
        run.state.model.parameters(), again.state.model.parameters()))


def test_echo_batches_repeats_each_batch():
    assert list(echo_batches(iter("abc"), 3)) == list("aaabbbccc")
    assert list(echo_batches(iter("abc"), 1)) == list("abc")


def test_device_prefetch_on_cpu_passes_tensors():
    loader = Loader(2)
    out = list(device_prefetch(loader, "cpu"))
    assert len(out) == 2 and out[0]["video"].dtype == torch.uint8
    assert np.array_equal(out[1]["text"].numpy(), loader.batches[1]["text"])


def test_preemption_saves_at_an_echo_group_boundary(tmp_path):
    run = _run(tmp_path, "data.echo_factor=2")
    inner = run.step

    def step(state, batch):
        state, metrics = inner(state, batch)
        if state.step == 3:  # the signal arrives inside an echo group
            launch._PREEMPTED["flag"] = True
        return state, metrics

    run.step = step
    try:
        train_one_epoch(run, Loader(), 0)
        assert run.state.step == 4  # the group finished, then the save
        assert finish_if_preempted(run, 0)
    finally:
        launch._PREEMPTED["flag"] = False
    assert run.ckpt.latest_step() == 4
    with open(tmp_path / "ckpt" / "4" / "extra.json") as f:
        extra = json.load(f)
    assert extra["epoch"] == 0 and extra["batch_in_epoch"] == 4

    again = _run(tmp_path, "data.echo_factor=2")
    assert again.start_epoch == 0 and again.start_batch == 4
    loader = Loader()
    train_one_epoch(again, loader, 0)
    assert loader.served == [2, 3]  # batches 0 and 1 were consumed
    assert again.state.step == 8 and again.state.optimizer.count == 8


def test_multi_device_mesh_raises(tmp_path):
    with pytest.raises(NotImplementedError):
        _run(tmp_path, "mesh.data=2")
