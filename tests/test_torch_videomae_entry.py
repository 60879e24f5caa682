"""The port's VideoMAE entries on the CPU (``--device cpu``):
``videomae_pretrain.main`` and ``videomae_finetune.main`` train the tiny
registry models on a ``chip_smoke.write_k400_fixture`` layout, log,
checkpoint and test (the finetune's multi-view accuracy on its EMA
weights), resume exactly after a preemption, take the pretraining run's
encoder, and raise without CUDA unless told the CPU."""

import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from avion_tpu_torch.train import loop, videomae_finetune, videomae_pretrain

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def k400(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("k400"))
    return root, chip_smoke.write_k400_fixture(root, videos=8, frames=24,
                                               w=64, h=48, fps=10, classes=3)


@pytest.fixture
def same_items(monkeypatch):
    """Every training item draws from seed 0, so two runs see the same
    batches."""
    orig = np.random.RandomState
    monkeypatch.setattr(np.random, "RandomState",
                        lambda seed=None: orig(0 if seed is None else seed))


def _pretrain_args(k400, out, *extra):
    root, meta = k400
    return ["model.name=VIDEOMAE_TINY", f"data.root={root}",
            f"data.train_metadata={meta}", "data.clip_length=4",
            "data.clip_stride=2", "data.mask_ratio=0.5", "data.batch_size=4",
            "data.num_workers=0", "optim.epochs=1", "optim.lr=1e-3",
            "optim.warmup_epochs=0", f"output_dir={out}", "print_freq=1",
            *extra, "--device", "cpu"]


def _finetune_args(k400, out, *extra):
    root, meta = k400
    return ["model.name=VIDEOMAE_TINY_FT", "model.num_classes=3",
            f"data.root={root}", f"data.train_metadata={meta}",
            f"data.val_metadata={meta}", "data.clip_length=4",
            "data.clip_stride=2", "data.batch_size=2", "data.repeated_aug=2",
            "data.val_batch_size=4", "data.num_clips=2", "data.num_crops=3",
            "data.num_workers=0", "optim.epochs=1", "optim.lr=1e-3",
            "optim.warmup_epochs=0", "optim.layer_decay=0.75", "mixup=0.8",
            "cutmix=1.0", "smoothing=0.1", "use_ema=true", "ema_decay=0.9",
            "model.drop_path_rate=0.1", "eval_freq=1", f"output_dir={out}",
            "print_freq=1", *extra, "--device", "cpu"]


def _log(out):
    return [json.loads(line) for line in open(osp.join(out, "log.jsonl"))]


def _state(out):
    ckpt = osp.join(out, "ckpt")
    step = max(int(n) for n in os.listdir(ckpt) if n.isdigit())
    return torch.load(osp.join(ckpt, str(step), "state.pt"),
                      weights_only=True)


def _assert_equal_states(a, b, keys=("model",)):
    for part in keys:
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


def _whole_and_split(monkeypatch, main, args_of, tmp_path, steps):
    """``steps`` steps in one call, against one step, a preemption
    checkpoint and a resume; returns both final states."""
    whole = str(tmp_path / "whole")
    assert main(args_of(whole))["step"] == steps
    calls = []  # preempted() is asked once before each step
    monkeypatch.setattr(loop, "preempted",
                        lambda: calls.append(1) or len(calls) >= 2)
    split = str(tmp_path / "split")
    assert main(args_of(split))["step"] == 1
    monkeypatch.setattr(loop, "preempted", lambda: False)
    res = main(args_of(split))
    assert res["steps"] == steps - 1 and res["step"] == steps
    return _state(whole), _state(split)


def test_pretrain_main_trains_and_resumes_exactly(k400, tmp_path,
                                                  monkeypatch, same_items):
    a, b = _whole_and_split(
        monkeypatch, videomae_pretrain.main,
        lambda out: _pretrain_args(k400, out, "model.drop_path_rate=0.5"),
        tmp_path, 2)
    _assert_equal_states(a, b)
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 2
    out = str(tmp_path / "whole")
    logs = _log(out)
    assert [r["step"] for r in logs] == [1, 2]
    assert all(np.isfinite(r["train/loss"]) for r in logs)
    cfg = json.load(open(osp.join(out, "config.json")))
    assert cfg["data"]["dataset"] == "kinetics"
    again = videomae_pretrain.main(_pretrain_args(k400, out))
    assert again["steps"] == 0 and again["step"] == 2
    # lr x batch / 256 in the checkpoint's config
    extra = json.load(open(osp.join(out, "ckpt", "2", "extra.json")))
    assert extra["config"]["optim"]["lr"] == pytest.approx(1e-3 * 4 / 256)


def test_pretrain_echo_draws_new_masks(k400, tmp_path, same_items):
    """Under data.echo_factor=2 each repeat of a decoded batch draws its own
    tube masks on the device, so the repeats' losses differ."""
    out = str(tmp_path / "echo")
    res = videomae_pretrain.main(_pretrain_args(
        k400, out, "data.echo_factor=2", "optim.lr=0"))
    assert res["step"] == 4
    losses = [r["train/loss"] for r in _log(out)]
    assert losses[0] != losses[1] and losses[2] != losses[3]


def test_finetune_main_tests_on_the_ema_and_resumes_exactly(
        k400, tmp_path, monkeypatch, same_items):
    a, b = _whole_and_split(
        monkeypatch, videomae_finetune.main,
        lambda out: _finetune_args(k400, out), tmp_path, 4)
    _assert_equal_states(a, b, ("model", "ema"))
    assert not torch.equal(a["ema"]["head.weight"], a["model"]["head.weight"])
    out = str(tmp_path / "whole")
    rows = [r for r in _log(out) if "acc1" in r and "train/loss" not in r]
    assert len(rows) == 1 and {"acc1", "acc5"} <= set(rows[0])
    assert all(0 <= rows[0][k] <= 100 for k in ("acc1", "acc5"))
    extra = json.load(open(osp.join(out, "ckpt", "4", "extra.json")))
    assert extra["is_best"] and "acc5" in extra["metrics"]
    # lr x batch / 256; layer decay leaves the head at the full rate
    assert extra["config"]["optim"]["lr"] == pytest.approx(1e-3 * 2 / 256)


def test_finetune_takes_the_pretraining_runs_encoder(k400, tmp_path):
    mae = str(tmp_path / "mae")
    videomae_pretrain.main(_pretrain_args(k400, mae, "data.clip_length=4"))
    encoder = {k: v for k, v in _state(mae)["model"].items()
               if k.startswith(("encoder.", "patch_embed."))}
    model, _, _ = videomae_finetune.build_model_and_state(
        videomae_finetune.TrainConfig().apply_overrides(
            ["model.name=VIDEOMAE_TINY_FT", "model.num_classes=3",
             "data.clip_length=4", f"pretrain_model={mae}"]), 4,
        device="cpu")
    sd = model.state_dict()
    for k, v in encoder.items():
        assert torch.equal(sd[k], v), k


def test_finetune_refuses_a_pretraining_layout_file(k400, tmp_path):
    path = str(tmp_path / "pretrain_layout.pt")
    torch.save({"encoder.blocks.0.norm1.weight": torch.ones(48)}, path)
    with pytest.raises(ValueError, match="pretraining layout"):
        videomae_finetune.main(_finetune_args(
            k400, str(tmp_path / "ft"), f"pretrain_model={path}"))


@pytest.mark.parametrize("main", [videomae_pretrain.main,
                                  videomae_finetune.main],
                         ids=["pretrain", "finetune"])
def test_mains_need_cuda_unless_told_the_cpu(k400, tmp_path, main):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = str(tmp_path / "run")
    args = _pretrain_args(k400, out)[:-2]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(args)
    assert not osp.exists(out)
