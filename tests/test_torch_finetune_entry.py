"""The port's CLIP finetune entries on the CPU (``--device cpu``), on a
``chip_smoke.write_ek100_fixture`` layout: ``finetune_mir.main`` and
``finetune_cls.main`` each start from a reference-layout ``.pt``, train one
epoch, log their validation (MIR mAP / nDCG; the multi-view test's top-1,
mean class and verb / noun accuracy), a second call resumes and takes no
step, and ``evaluate=true`` restores and only validates, with the same
metrics; without CUDA they raise unless told the CPU.
``finetune_cls.validate`` gives the JAX function's metrics on the same
clips through the same linear scorer."""

import json
import os.path as osp
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from avion_tpu.core.config import TrainConfig as JaxTrainConfig
from avion_tpu.train import finetune_cls as jax_finetune_cls
from avion_tpu_torch.core.config import TrainConfig
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.train import finetune_cls, finetune_mir

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CHUNK = 2


@pytest.fixture(scope="module")
def ek100(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ek100"))
    fx = chip_smoke.write_ek100_fixture(root, w=64, h=48, fps=10,
                                        chunk_s=CHUNK, train_clips=8,
                                        test_clips=8)
    ckpt = osp.join(root, "clip_tiny.pt")
    model = create_model("CLIP_TINY").init_weights(
        torch.Generator().manual_seed(5))
    torch.save({"state_dict": model.state_dict()}, ckpt)
    return fx, ckpt


def _data_args(fx, *extra):
    return [f"data.root={fx['root']}", f"data.train_metadata={fx['train']}",
            f"data.val_metadata={fx['test']}", f"data.chunk_len={CHUNK}",
            "data.clip_length=2", "data.crop_size=32", "data.batch_size=4",
            "data.val_batch_size=4", "data.num_workers=0", "optim.epochs=1",
            "optim.warmup_epochs=0", "print_freq=1", "eval_freq=1", *extra]


def _mir_args(ek100, out):
    fx, ckpt = ek100
    return ["model.name=CLIP_TINY", "model.project_embed_dim=32",
            f"data.relevancy_path={fx['relevancy']}",
            "optim.lr=1e-4", f"pretrain_model={ckpt}", f"output_dir={out}",
            *_data_args(fx)]


def _cls_args(ek100, out):
    fx, ckpt = ek100
    return ["model.image_size=32", "model.vision_width=64",
            "model.vision_layers=2", "model.vision_heads=2",
            f"data.label_map={fx['actions']}", "data.num_clips=2",
            "optim.optimizer=sgd", "optim.lr=0.012", "optim.wd=4e-5",
            "mixup=0.8", f"pretrain_model={ckpt}", f"output_dir={out}",
            *_data_args(fx)]


def _log(out):
    with open(osp.join(out, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_finetune_mir_main_trains_validates_and_resumes(ek100, tmp_path):
    out = str(tmp_path / "mir")
    res = finetune_mir.main(_mir_args(ek100, out) + ["--device", "cpu"])
    assert res["steps"] == 2 and res["step"] == 2
    assert np.isfinite(res["epochs"][0]["loss"])
    metrics = res["eval"][0]
    assert set(metrics) == {"vis_map", "txt_map", "avg_map", "vis_ndcg",
                            "txt_ndcg", "avg_ndcg"}
    assert all(np.isfinite(v) for v in metrics.values())
    logs = _log(out)
    assert any("train/loss" in r for r in logs)
    assert any(r.get("avg_map") == metrics["avg_map"] for r in logs)
    with open(osp.join(out, "ckpt", "2", "extra.json")) as f:
        extra = json.load(f)
    assert extra["is_best"] and extra["metrics"]["avg_map"] == \
        metrics["avg_map"]
    again = finetune_mir.main(_mir_args(ek100, out) + ["--device", "cpu"])
    assert again["steps"] == 0 and again["step"] == 2
    # evaluate=true restores the newest checkpoint and only validates
    only = finetune_mir.main(_mir_args(ek100, out)
                             + ["evaluate=true", "--device", "cpu"])
    assert only["steps"] == 0 and set(only["eval"]) == {-1}
    np.testing.assert_allclose(only["eval"][-1]["avg_map"],
                               metrics["avg_map"], rtol=1e-6)


def test_finetune_cls_main_trains_tests_and_resumes(ek100, tmp_path):
    out = str(tmp_path / "cls")
    res = finetune_cls.main(_cls_args(ek100, out) + ["--device", "cpu"])
    assert res["steps"] == 2 and res["step"] == 2
    assert np.isfinite(res["epochs"][0]["loss"])
    metrics = res["eval"][0]
    assert set(metrics) == {"acc1", "acc5", "mean_class_acc", "verb_acc1",
                            "noun_acc1"}
    logs = _log(out)
    assert any("train/loss" in r for r in logs)
    assert any(r.get("verb_acc1") == metrics["verb_acc1"] for r in logs)
    with open(osp.join(out, "ckpt", "2", "extra.json")) as f:
        extra = json.load(f)  # the run's config, lr x batch / 128
    assert extra["config"]["optim"]["lr"] == pytest.approx(0.012 * 4 / 128)
    again = finetune_cls.main(_cls_args(ek100, out) + ["--device", "cpu"])
    assert again["steps"] == 0 and again["step"] == 2
    only = finetune_cls.main(_cls_args(ek100, out)
                             + ["evaluate=true", "--device", "cpu"])
    assert only["steps"] == 0 and only["eval"] == {-1: metrics}


@pytest.mark.parametrize("main", [finetune_mir.main, finetune_cls.main],
                         ids=["mir", "cls"])
def test_mains_need_cuda_unless_told_the_cpu(ek100, tmp_path, main):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    args = (_mir_args if main is finetune_mir.main else _cls_args)(
        ek100, str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(args)


class _Scorer(torch.nn.Module):
    """Logits as a fixed linear map of the normalized clip (bf16 input,
    f32 product), the same on both sides."""

    dtype = torch.bfloat16

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))

    def forward(self, video):
        return video.reshape(video.shape[0], -1).float() @ self.w


def test_validate_matches_jax_on_the_same_scores(ek100, mesh_dp):
    fx, _ = ek100
    args = _data_args(fx, f"data.label_map={fx['actions']}",
                      "data.num_clips=2")
    _, pairs, _ = finetune_cls.load_actions(fx["actions"])
    w = (np.random.RandomState(0).standard_normal((2 * 32 * 32 * 3,
                                                   len(pairs)))
         * 0.05).astype(np.float32)
    jax_model = SimpleNamespace(apply=lambda variables, v: (
        v.reshape(v.shape[0], -1).astype(jnp.float32)
        @ variables["params"]["w"]))
    run = SimpleNamespace(mesh=mesh_dp, state=SimpleNamespace(
        params={"w": jnp.asarray(w)}))
    jcfg = jax_finetune_cls.env_defaults(
        JaxTrainConfig().apply_overrides(args))
    ref = jax_finetune_cls.validate(jcfg, jax_model, run, pairs)
    cfg = finetune_cls.env_defaults(TrainConfig().apply_overrides(args))
    got = finetune_cls.validate(cfg, _Scorer(w), pairs)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-6,
                                   err_msg=k)
    assert jax.device_count() == 8  # the JAX side ran on the CPU mesh
