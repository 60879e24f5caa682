"""The port's training entry on the CPU (``--device cpu``): ``main`` trains
``CLIP_TINY`` (2 frames, 32 px, batch 8) on a tiny chunked ego4d tree with
host and with device crop, writes ``config.json``, ``log.jsonl`` and a
checkpoint, and resumes; it raises without CUDA unless told the CPU, and
on what later slices bring.  One step on a decoded device-crop batch
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
    ["loss=siglip"], ["optim.update_freq=2"],
    ["data.val_metadata=val.csv", "data.relevancy_path={meta}"]],
    ids=["siglip", "update_freq", "zero_shot"])
def test_main_raises_on_later_slices(tiny_ego4d, tmp_path, extra):
    root, meta = tiny_ego4d
    extra = [e.format(meta=meta) for e in extra]
    with pytest.raises(NotImplementedError, match="slice"):
        pretrain_clip.main(_args(root, meta, str(tmp_path / "run"), "true",
                                 *extra, "--device", "cpu"))


def test_zero_shot_suites_follow_the_jax_activation_rules(tmp_path):
    from avion_tpu.eval.validate import build_suites
    from avion_tpu_torch.core.config import DataConfig

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
        assert pretrain_clip.zero_shot_suites(cfg, env) == \
            list(build_suites(None, cfg, env)), (data, env)


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
