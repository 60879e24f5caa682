"""The contrastive extras through the port's entries on the CPU
(``--device cpu``): ``pretrain_clip.main`` on ``CLIP_TINY`` with SigLIP,
cached accumulation over 2 microbatches and bf16 optimizer state, and with
``accum=multistep``; each run of 2 steps against 1 step, a preemption
checkpoint (in the middle of a multistep accumulation), a resume and 1
step, parameters and optimizer state bit for bit.  The finetune entries
with ``optim.update_freq=2`` (MIR) and ``optim.state_dtype=bfloat16``
(CLS)."""

import os
import os.path as osp

import numpy as np
import pytest
import torch

from avion_tpu_torch.train import finetune_cls, finetune_mir, pretrain_clip
from test_torch_finetune_entry import _cls_args, _mir_args, ek100  # noqa
from test_torch_pretrain_entry import (_args, _params, same_items,  # noqa
                                       tiny_ego4d)

MODES = {
    "siglip_cached_bf16": ("loss=siglip", "optim.update_freq=2",
                           "optim.accum=cached", "optim.state_dtype=bfloat16",
                           "model.patch_dropout=0.5"),
    "multistep": ("optim.update_freq=2", "optim.accum=multistep"),
}


def _state(out):
    ckpt = osp.join(out, "ckpt")
    steps = [int(n) for n in os.listdir(ckpt) if n.isdigit()]
    return torch.load(osp.join(ckpt, str(max(steps)), "state.pt"),
                      weights_only=True)


@pytest.mark.parametrize("mode", list(MODES))
def test_pretrain_main_trains_and_resumes_exactly(tiny_ego4d, tmp_path,
                                                  monkeypatch, same_items,
                                                  mode):
    from avion_tpu_torch.train import loop

    root, meta = tiny_ego4d
    extra = (*MODES[mode], "--device", "cpu")
    whole = str(tmp_path / "whole")
    res = pretrain_clip.main(_args(root, meta, whole, "true", *extra))
    assert res["steps"] == res["step"] == 2
    assert np.isfinite(res["epochs"][0]["loss"])
    assert res["epochs"][0]["step_ok"] == 1.0

    calls = []  # preempted() is asked once before each step
    monkeypatch.setattr(loop, "preempted",
                        lambda: calls.append(1) or len(calls) >= 2)
    split = str(tmp_path / "split")
    assert pretrain_clip.main(_args(root, meta, split, "true", *extra))[
        "step"] == 1
    monkeypatch.setattr(loop, "preempted", lambda: False)
    assert pretrain_clip.main(_args(root, meta, split, "true", *extra))[
        "steps"] == 1

    a, b = _state(whole), _state(split)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    opt_a, opt_b = a["optimizer"], b["optimizer"]
    moments = [v for s in opt_a["adamw"]["state"].values()
               for v in s.values()]
    if mode == "multistep":
        assert opt_a["count"] == opt_b["count"] == 1
        assert {v.dtype for v in moments} == {torch.float32}
    else:
        assert opt_a["count"] == opt_b["count"] == 2
        assert {v.dtype for v in moments} == {torch.bfloat16}
        bias = a["model"]["logit_bias"].item()
        assert bias != -10.0 and np.isfinite(bias)
    for i, s in opt_a["adamw"]["state"].items():
        for name, v in s.items():
            assert torch.equal(v, opt_b["adamw"]["state"][i][name]), name


def test_finetune_entries_take_update_freq_and_bf16_state(ek100, tmp_path):
    mir = str(tmp_path / "mir")
    res = finetune_mir.main(_mir_args(ek100, mir) + [
        "optim.update_freq=2", "--device", "cpu"])
    assert res["steps"] == 2 and np.isfinite(res["epochs"][0]["loss"])
    state = _state(mir)["optimizer"]
    assert state["count"] == 1 and state["mini_step"] == 0
    cls = str(tmp_path / "cls")
    res = finetune_cls.main(_cls_args(ek100, cls) + [
        "optim.state_dtype=bfloat16", "--device", "cpu"])
    assert res["steps"] == 2 and np.isfinite(res["epochs"][0]["loss"])
    state = _state(cls)["optimizer"]
    assert state["count"] == 2
    assert {v.dtype for s in state["sgd"]["state"].values()
            for v in s.values()} == {torch.bfloat16}
