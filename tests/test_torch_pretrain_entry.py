"""The port's training entry on the CPU (``--device cpu``): ``main`` trains
``CLIP_TINY`` (2 frames, 32 px, batch 8) on a tiny chunked ego4d tree with
host and with device crop, writes ``config.json``, ``log.jsonl`` and a
checkpoint, and resumes; it raises without CUDA unless told the CPU; over
2 gloo ranks at ``mesh.pp=2`` (pipelined tower) and ``mesh.ep=2`` (MoE
tower) it writes the one-process checkpoint layout.  One step on a decoded device-crop batch
matches the JAX step on the same weights."""

import json
import os
import os.path as osp
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.optim.factory import build_optimizer as jax_build_optimizer
from avion_tpu.train.steps import make_clip_train_step as jax_make_step
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.data.datasets import AugmentSpec, VideoCaptionDataset
from avion_tpu_torch.models.clip import CLIP
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.train import pretrain_clip
from avion_tpu_torch.train.steps import make_clip_train_step

FPS = 10
CHUNK = 2
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_train_step.py's


@pytest.fixture(scope="module")
def tiny_ego4d(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ego4d"))
    samples = []
    for v in range(8):
        d = osp.join(root, f"vid{v}.mp4")
        os.makedirs(d)
        for chunk in (0, 2):
            vw = cv2.VideoWriter(osp.join(d, f"{chunk}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), FPS,
                                 (48, 40))
            rs = np.random.RandomState(10 * v + chunk)
            for _ in range(CHUNK * FPS):
                vw.write(rs.randint(0, 256, (40, 48, 3), np.uint8))
            vw.release()
        samples.append((f"vid{v}", 0.3, 3.5, f"does action number {v}"))
    meta = osp.join(root, "meta.pkl")
    with open(meta, "wb") as f:
        pickle.dump(samples * 2, f)  # 16 rows: 2 batches of 8
    return root, meta


def _args(root, meta, out, fused, *extra):
    return ["model.name=CLIP_TINY", f"data.root={root}",
            f"data.train_metadata={meta}", f"data.chunk_len={CHUNK}",
            f"data.fps={FPS}", "data.clip_length=2", "data.crop_size=32",
            "data.decode_size=40", "data.batch_size=8", "data.num_workers=0",
            f"data.fused_decode_crop={fused}", "data.hflip_prob=0.5",
            "optim.epochs=1", "optim.lr=1e-3", "optim.warmup_epochs=0",
            f"output_dir={out}", "print_freq=1", *extra]


@pytest.mark.parametrize("fused", ["true", "false"])
def test_main_trains_on_decoded_video_and_resumes(tiny_ego4d, tmp_path,
                                                  fused):
    root, meta = tiny_ego4d
    out = str(tmp_path / "run")
    args = _args(root, meta, out, fused, "--device", "cpu")
    res = pretrain_clip.main(args)
    assert res["steps"] == res["step"] == 2
    assert res["decode_backend"] in ("native", "cv2")
    assert np.isfinite(res["epochs"][0]["loss"])
    assert res["epochs"][0]["step_ok"] == 1.0
    cfg = json.load(open(osp.join(out, "config.json")))
    assert cfg["data"]["fused_decode_crop"] is (fused == "true")
    logs = [json.loads(line) for line in open(osp.join(out, "log.jsonl"))]
    assert [r["step"] for r in logs] == [1, 2]
    assert all(np.isfinite(r["train/loss"]) and "perf/data_time_win" in r
               for r in logs)
    assert os.listdir(osp.join(out, "ckpt")) == ["2"]
    again = pretrain_clip.main(args)  # restores, nothing left to train
    assert again["steps"] == 0 and again["step"] == 2


def test_main_needs_cuda_unless_told_the_cpu(tiny_ego4d, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    root, meta = tiny_ego4d
    out = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="--device cpu"):
        pretrain_clip.main(_args(root, meta, out, "true"))
    assert not osp.exists(out)


@pytest.mark.parametrize("extra", [
    ["mesh.pp=2", "model.pipeline=true"],
    ["mesh.ep=2", "model.moe_experts=4"]], ids=["pp", "ep"])
def test_main_over_pp_and_ep_then_resumed_alone(tiny_ego4d, tmp_path,
                                                extra):
    """``main`` over 2 gloo ranks with the pipelined tower at ``mesh.pp=2``
    or the MoE tower at ``mesh.ep=2`` for an epoch: both ranks train on
    the same batches (the same loss and gradient norm), its checkpoint
    holds the one-process layout (the stage or expert leaves gathered
    whole; the pipelined tower's loads into the sequential one), and
    ``main`` alone resumes from it for a second epoch.  Each step against
    the JAX step: ``test_torch_parallel_moe_pp``."""
    import torch_parallel_workers as workers
    from torch_dist import run_ranks

    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.train.common import latest_model_state

    root, meta = tiny_ego4d
    out = str(tmp_path / "run")
    model = [e for e in extra if e.startswith("model.")]
    ranks = run_ranks(workers.entry_main, 2, "pretrain_clip",
                      _args(root, meta, out, "true", *extra, "--device",
                            "cpu"), timeout=120)
    assert [r["step"] for r in ranks] == [2, 2]
    a, b = (r["epochs"][0] for r in ranks)
    for key in ("loss", "grad_norm", "clip_acc"):
        assert a[key] == b[key], key
    if "model.moe_experts=4" in model:
        assert np.isfinite(a["moe_aux"]) and 0 <= a["moe_overflow"] <= 1
    state = latest_model_state(osp.join(out, "ckpt"))
    kw = {"moe_experts": 4} if "model.moe_experts=4" in model else {}
    whole = create_model("CLIP_TINY", num_frames=2, project_embed_dim=512,
                         **kw)
    whole.load_state_dict(state, strict=True)  # pipelined -> sequential
    res = pretrain_clip.main(_args(root, meta, out, "true", *model,
                                   "optim.epochs=2", "--device", "cpu"))
    assert res["step"] == 4 and res["steps"] == 2


def test_zero_shot_suites_follow_the_jax_activation_rules(tmp_path):
    from avion_tpu.eval.validate import build_suites as jax_build_suites
    from avion_tpu_torch.core.config import DataConfig
    from avion_tpu_torch.eval.validate import build_suites

    meta_dir = tmp_path / "meta"
    meta_dir.mkdir()
    rel = tmp_path / "rel.pkl"
    rel.write_bytes(b"")
    cases = [
        ({}, {}),
        ({"val_metadata": "v.csv", "relevancy_path": str(rel)}, {}),
        ({"val_metadata": "v.csv", "relevancy_path": str(tmp_path / "no")},
         {}),
        ({}, {"EGTEA_DATA_DIR": "x", "EGTEA_META_DIR": str(meta_dir)}),
        ({}, {"EGTEA_DATA_DIR": "x", "EGTEA_META_DIR": str(tmp_path / "no")}),
        ({}, {"CHARADES_DATA_DIR": "x", "CHARADES_META_DIR": str(meta_dir)}),
        ({}, {"EGO4D_MCQ_DATA_DIR": "x", "EGO4D_MCQ_META_DIR": "y"}),
        ({"val_metadata": "v.csv"}, {"EK100_ACTIONS_CSV": str(rel),
                                     "EK100_VIDEO_DIR": "d"}),
        ({}, {"EK100_ACTIONS_CSV": str(rel), "EK100_VIDEO_DIR": "d"}),
    ]
    for data, env in cases:
        cfg = DataConfig(**data)
        assert list(build_suites(cfg, env)) == \
            list(jax_build_suites(None, cfg, env)), (data, env)


@pytest.fixture(scope="module")
def mir_layout(tmp_path_factory):
    """An EK100 MIR test layout (and the other suites', unused here) of
    ``chip_smoke.write_eval_fixtures``, in 2 s chunks at 10 fps."""
    import sys

    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke.write_eval_fixtures(
        str(tmp_path_factory.mktemp("eval")), seed=0, w=64, h=48, fps=FPS,
        chunk_s=CHUNK, clip_s=2, mir_clips=6, egtea_clips=1,
        charades_videos=1, charades_classes=1, mcq_items=1)["data"]


def _mir_args(mir):
    return ["eval_freq=1", f"data.val_metadata={mir['val_metadata']}",
            f"data.relevancy_path={mir['relevancy_path']}",
            f"data.root_val={mir['root_val']}", "data.val_batch_size=4"]


def _extras(out):
    """Each checkpoint's extra.json, by step."""
    ckpt = osp.join(out, "ckpt")
    return {int(n): json.load(open(osp.join(ckpt, n, "extra.json")))
            for n in os.listdir(ckpt) if n.isdigit()}


MIR_KEYS = {f"test_ek100_mir_{k}" for k in (
    "vis_map", "txt_map", "avg_map", "vis_ndcg", "txt_ndcg", "avg_ndcg")}


def test_main_evaluates_before_training_and_after_each_epoch(
        tiny_ego4d, mir_layout, tmp_path):
    root, meta = tiny_ego4d
    out = str(tmp_path / "run")
    res = pretrain_clip.main(_args(root, meta, out, "true", "optim.epochs=2",
                                   *_mir_args(mir_layout), "--device", "cpu"))
    assert res["step"] == 4 and sorted(res["eval"]) == [-1, 0, 1]
    for metrics in res["eval"].values():
        assert set(metrics) == MIR_KEYS
        assert all(np.isfinite(v) for v in metrics.values())
    logs = [json.loads(line) for line in open(osp.join(out, "log.jsonl"))]
    assert [r["step"] for r in logs if MIR_KEYS <= set(r)] == [0, 2, 4]
    extras = _extras(out)
    assert sorted(extras) == [2, 4]
    maps = [res["eval"][e]["test_ek100_mir_avg_map"] for e in (0, 1)]
    assert [extras[s]["is_best"] for s in (2, 4)] == [True, maps[1] > maps[0]]
    for s, e in ((2, 0), (4, 1)):
        assert extras[s]["metrics"]["test_ek100_mir_avg_map"] == maps[e]
        assert "clip_acc" in extras[s]["metrics"]


def test_eval_leaves_the_trained_parameters_bit_equal(
        tiny_ego4d, mir_layout, tmp_path, same_items):
    """2 steps with the epoch -1 and epoch 0 evals against 2 steps with
    eval_freq=0: the same parameters, bit for bit."""
    root, meta = tiny_ego4d
    runs = {}
    for name, extra in (("eval", _mir_args(mir_layout)),
                        ("none", ["eval_freq=0"])):
        out = str(tmp_path / name)
        res = pretrain_clip.main(_args(root, meta, out, "true", *extra,
                                       "model.patch_dropout=0.5",
                                       "--device", "cpu"))
        assert res["step"] == 2
        runs[name] = (res, _params(out))
    assert sorted(runs["eval"][0]["eval"]) == [-1, 0]
    assert runs["none"][0]["eval"] == {}
    a, b = runs["eval"][1], runs["none"][1]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_main_survives_a_failing_suite(tiny_ego4d, mir_layout, tmp_path):
    """Inside training a suite that fails gives ``test_<suite>_error`` (and
    its traceback); the best checkpoint then follows clip_acc."""
    root, meta = tiny_ego4d
    broken = dict(mir_layout, val_metadata=str(tmp_path / "no_test.csv"))
    out = str(tmp_path / "run")
    res = pretrain_clip.main(_args(root, meta, out, "true",
                                   *_mir_args(broken), "--device", "cpu"))
    assert res["eval"] == {-1: {"test_ek100_mir_error": 1.0},
                           0: {"test_ek100_mir_error": 1.0}}
    extra = _extras(out)[2]
    assert extra["is_best"] and extra["metrics"]["test_ek100_mir_error"] == 1


def _params(out):
    """The model parameters of the newest checkpoint under ``out``."""
    ckpt = osp.join(out, "ckpt")
    step = max(int(n) for n in os.listdir(ckpt) if n.isdigit())
    return torch.load(osp.join(ckpt, str(step), "state.pt"),
                      weights_only=True)["model"]


@pytest.fixture
def same_items(monkeypatch):
    """Every training item draws its crop and frame jitter from seed 0
    (the datasets seed each item's draws from the OS otherwise), so that
    two runs see the same batches."""
    orig = np.random.RandomState
    monkeypatch.setattr(np.random, "RandomState",
                        lambda seed=None: orig(0 if seed is None else seed))


def test_patch_dropout_draws_follow_the_step_across_a_resume(
        tiny_ego4d, tmp_path, monkeypatch, same_items):
    """2 steps in one call against 1 step, a preemption checkpoint, a
    resume and 1 step: step k draws the same patch-dropout mask either
    way, as the JAX step folds the step into its key."""
    from avion_tpu_torch.train import loop

    root, meta = tiny_ego4d
    extra = ("model.patch_dropout=0.5", "--device", "cpu")
    whole = str(tmp_path / "whole")
    assert pretrain_clip.main(_args(root, meta, whole, "true", *extra))[
        "step"] == 2

    calls = []  # preempted() is asked once before each step
    monkeypatch.setattr(loop, "preempted",
                        lambda: calls.append(1) or len(calls) >= 2)
    split = str(tmp_path / "split")
    assert pretrain_clip.main(_args(root, meta, split, "true", *extra))[
        "step"] == 1
    monkeypatch.setattr(loop, "preempted", lambda: False)
    res = pretrain_clip.main(_args(root, meta, split, "true", *extra))
    assert res["steps"] == 1 and res["step"] == 2
    a, b = _params(whole), _params(split)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


SERVED = dict(embed_dim=32, image_size=32, patch_size=16, num_frames=2,
              vision_width=64, vision_layers=2, vision_heads=2,
              context_length=77, vocab_size=49408, text_width=32,
              text_heads=2, text_layers=2)
OPT = dict(lr=1e-3, lr_start=1e-4, warmup_epochs=0.5, epochs=1, wd=0.05,
           grad_clip_norm=1.0)


def test_device_crop_step_matches_jax(tiny_ego4d, monkeypatch):
    """A decoded device_rrc batch (crops and flips drawn by the training
    sampler from seeded generators) through the port's step and the JAX
    step, on the same f32 weights.  The JAX step rounds its cropped input
    to bf16 even for an f32 model, where the port keeps the model's dtype
    (as its uint8 path does): the JAX side is given f32 input here, and
    the crop's own bf16 rounding is held in test_torch_fused_input.py."""
    import functools

    from avion_tpu.train import steps as jax_steps
    from avion_tpu_torch.data.datasets import caption_item, collate

    root, meta = tiny_ego4d
    ds = VideoCaptionDataset(
        "ego4d", root, meta, is_training=True, clip_length=2,
        chunk_len=CHUNK, fps=FPS,
        augment=AugmentSpec(crop_size=32, mode="device_rrc", decode_size=40,
                            scale_min=0.3, hflip_prob=0.5))
    items = []
    for i in range(6):
        rng = np.random.RandomState(i)
        frames, crop, hflip = ds._load(ds.samples[i], rng)
        items.append(caption_item(frames, ds.samples[i].caption, rng, 77,
                                  "random", crop, hflip))
    batch = collate(items)
    assert batch["video"].shape == (6, 2, 40, 40, 3)
    assert 0 < batch["hflip"].sum() < 6
    assert (batch["crop"][:, 2:] < 1).all()

    monkeypatch.setattr(jax_steps, "prep_video", functools.partial(
        jax_steps.prep_video, dtype=jnp.float32))
    jm = JaxCLIP(**SERVED, use_flash=False, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)),
                     jnp.zeros((1, 77), jnp.int32))["params"]
    tx, _ = jax_build_optimizer(JaxOptimConfig(**OPT), params, 4)
    jstate = JaxTrainState.create(params, tx)
    _, jmetrics = jax.jit(jax_make_step(jm, tx, crop_size=32))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))

    model = CLIP(**SERVED, dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(params)),
                          strict=True)
    opt, _ = build_optimizer(OptimConfig(**OPT), model, 4)
    step = make_clip_train_step(model, crop_size=32)
    _, metrics = step(TrainState.create(model, opt),
                      {k: torch.from_numpy(np.asarray(v))
                       for k, v in batch.items()})
    for key in ("loss", "clip_acc", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   err_msg=key, **TOL)
