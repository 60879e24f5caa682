"""The convergence drill's five held-out evals against the JAX tool's, on
the same data and the same weights: the port restores a checkpoint of its
own (``<run>/ckpt/<step>/state.pt`` holding ``params_from_jax`` of the
weights), the JAX function gets the flax weights from a stand-in for its
orbax ``Checkpointer``; both read the run's ``config.json`` and decode
through cv2.  Tolerances: a top-k accuracy within one held-out clip of
JAX's (the towers run in bf16 on both sides, where a near tie may turn),
the masked-reconstruction MSE within 1e-4 relative (f32), retrieval mAP /
nDCG within 2e-2 (bf16), NLQ recall within one query and mIoU within
0.5 (f32)."""

import os
import os.path as osp
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avion_tpu.data.video_reader as jvr
import avion_tpu.tools.e2e_convergence as jt
import avion_tpu_torch.data.video_reader as pvr
import avion_tpu_torch.tools.e2e_convergence as pt
from avion_tpu_torch.core.config import TrainConfig
from avion_tpu_torch.models.pt_import import params_from_jax

STEP = 7


@pytest.fixture(scope="module", autouse=True)
def cv2_both():
    """Both packages decode through cv2 (the native reader may load in one
    interpreter and not on the card's machine)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jvr, "_lib", None)
    mp.setattr(jvr, "_lib_tried", True)
    mp.setattr(pvr, "_native_lib", lambda: None)
    yield
    mp.undo()


def _run_dir(tmp_path, overrides, flax_params=None, sd=None):
    """A run directory: ``config.json`` of the port's config with
    ``overrides`` and the port's checkpoint of the weights at STEP."""
    run = tmp_path / "run"
    (run / "ckpt" / str(STEP)).mkdir(parents=True)
    TrainConfig().apply_overrides(overrides).save(str(run / "config.json"))
    sd = sd if sd is not None else params_from_jax(flax_params)
    torch.save({"step": STEP, "model": sd},
               str(run / "ckpt" / str(STEP) / "state.pt"))
    return str(run)


def _fake_checkpointer(monkeypatch, params, tree=False):
    """The JAX package's ``Checkpointer`` restoring ``params`` at STEP."""
    import avion_tpu.core.checkpoint as jc

    class Fake:
        def __init__(self, *a, **k):
            pass

        def restore(self, template):
            if tree:
                return {"params": params}, {}
            return SimpleNamespace(step=STEP, params=params), {}

        def latest_step(self):
            return STEP

        def close(self):
            pass

    monkeypatch.setattr(jc, "Checkpointer", Fake)


def _perturbed(params, seed=3, scale=0.05):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + scale * rs.standard_normal(np.shape(x)).astype(np.float32), params)


CLIP_CFG = ["model.name=CLIP_TINY", "model.use_flash_attn=false",
            "model.project_embed_dim=32",
            "data.clip_length=2", "data.crop_size=32"]


def _jax_clip_params():
    from avion_tpu.models import create_model

    jm = create_model("CLIP_TINY", num_frames=2, use_flash_attn=False)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 2, 32, 32, 3)),
                     jnp.zeros((1, 77), jnp.int32))["params"]
    return _perturbed(params)


def _within_one(ours, theirs, n, keys):
    for k in keys:
        # the metrics are rounded to 4 places
        assert abs(ours[k] - theirs[k]) <= 1.0 / n + 1e-4, (k, ours, theirs)


def test_zero_shot_sweep_matches_jax(tmp_path, monkeypatch):
    root = str(tmp_path / "data")
    pt.make_class_dataset(root, 3, 2, w=64, h=48)
    params = _jax_clip_params()
    run = _run_dir(tmp_path, CLIP_CFG, params)
    _fake_checkpointer(monkeypatch, params)
    theirs = jt.zero_shot_sweep(root, run, model_name="CLIP_TINY", batch=4,
                                n_classes=3)
    ours = pt.zero_shot_sweep(root, run, batch=4, n_classes=3, device="cpu")
    assert ours["ckpt_step"] == theirs["ckpt_step"] == STEP
    assert ours["heldout_clips"] == theirs["heldout_clips"] == 12
    _within_one(ours, theirs, 12, ("zeroshot_top1", "zeroshot_top5"))
    assert 0.0 <= ours["init_zeroshot_top1"] <= 1.0


def test_mae_eval_matches_jax(tmp_path, monkeypatch):
    from avion_tpu.models import create_model

    root = str(tmp_path / "data")
    pt.make_mae_dataset(root, 2, 1, n_frames=40, w=64, h=48)
    cfg = ["model.name=VIDEOMAE_TINY", "model.use_flash_attn=false",
           "data.clip_length=4", "data.clip_stride=4", "data.mask_ratio=0.5"]
    jm = create_model("VIDEOMAE_TINY", num_frames=4, mask_ratio=0.5)
    mask = np.zeros((1, jm.num_patches), bool)
    mask[:, jm.n_visible:] = True
    params = _perturbed(jm.init(jax.random.PRNGKey(5),
                                jnp.zeros((1, 4, 32, 32, 3)),
                                jnp.asarray(mask))["params"])
    run = _run_dir(tmp_path, cfg, params)
    _fake_checkpointer(monkeypatch, params)
    theirs = jt.mae_eval(root, run, batch=3, n_videos=2)
    ours = pt.mae_eval(root, run, batch=3, n_videos=2, device="cpu")
    assert ours["ckpt_step"] == theirs["ckpt_step"] == STEP
    assert ours["heldout_clips"] == theirs["heldout_clips"] == 4
    np.testing.assert_allclose(ours["mse_final"], theirs["mse_final"],
                               rtol=1e-4, atol=1e-4)
    assert ours["mse_init"] > 0


def test_cls_eval_matches_jax(tmp_path, monkeypatch):
    from avion_tpu.core.config import TrainConfig as JaxTrainConfig
    from avion_tpu.train.finetune_cls import build_classifier

    root = str(tmp_path / "data")
    pt.make_cls_dataset(root, 6, 2, w=64, h=48)
    cfg = ["model.name=CLIP_TINY", "model.use_flash_attn=false",
           "model.image_size=32", "model.patch_size=16",
           "model.vision_width=64", "model.vision_layers=2",
           "model.vision_heads=2", "data.clip_length=2",
           "data.batch_size=4"]
    jm = build_classifier(JaxTrainConfig().apply_overrides(cfg), 6)
    params = _perturbed(jm.init(jax.random.PRNGKey(5),
                                jnp.zeros((1, 2, 32, 32, 3)))["params"],
                        scale=0.2)
    run = _run_dir(tmp_path, cfg, params)
    _fake_checkpointer(monkeypatch, params)
    theirs = jt.cls_eval(root, run, batch=5, n_classes=6)
    ours = pt.cls_eval(root, run, batch=5, n_classes=6, device="cpu")
    for k in ("ckpt_step", "heldout_clips", "topk_k", "chance"):
        assert ours[k] == theirs[k], k
    _within_one(ours, theirs, ours["heldout_clips"],
                ("top1", "topk", "verb_top1", "noun_top1"))


def test_mir_eval_matches_jax(tmp_path, monkeypatch):
    root = str(tmp_path / "data")
    pt.make_mir_dataset(root, 3, 2, w=64, h=48, heldout_per_class=2)
    params = _jax_clip_params()
    run = _run_dir(tmp_path, CLIP_CFG, params)
    _fake_checkpointer(monkeypatch, params)
    theirs = jt.mir_eval(root, run, batch=4)
    ours = pt.mir_eval(root, run, batch=4, device="cpu")
    assert ours["ckpt_step"] == theirs["ckpt_step"] == STEP
    assert ours["heldout_clips"] == theirs["heldout_clips"] == 6
    assert ours["trained"].keys() == theirs["trained"].keys()
    for k, v in theirs["trained"].items():
        np.testing.assert_allclose(ours["trained"][k], v, atol=2e-2,
                                   err_msg=k)
    assert ours["init"].keys() == ours["trained"].keys()


def test_nlq_eval_matches_jax(tmp_path, monkeypatch):
    from avion_tpu.egonlq.vslnet import VSLNet

    root = str(tmp_path / "data")
    pt.make_nlq_dataset(root, 3, 4, val_per_concept=3)
    d = jt._NLQ_DIMS
    jm = VSLNet(dim=d["dim"], num_heads=d["num_heads"],
                max_pos_len=d["max_pos_len"],
                video_feature_dim=d["video_feature_dim"],
                query_feature_dim=d["query_feature_dim"],
                use_cq_attention=True)
    b = d["max_pos_len"]
    params = _perturbed(jm.init(
        jax.random.PRNGKey(5), jnp.zeros((1, b, d["video_feature_dim"])),
        jnp.ones((1, b)), jnp.zeros((1, 1, d["query_feature_dim"])),
        jnp.ones((1, 1)))["params"], scale=0.2)
    run = _run_dir(tmp_path, [], params)
    os.remove(osp.join(run, "config.json"))
    _fake_checkpointer(monkeypatch, params, tree=True)
    theirs = jt.nlq_eval(root, run, batch=4)
    ours = pt.nlq_eval(root, run, batch=4, device="cpu")
    assert ours["ckpt_step"] == theirs["ckpt_step"] == STEP
    assert ours["val_queries"] == theirs["val_queries"] == 9
    assert ours["trained"].keys() == theirs["trained"].keys()
    for k, v in theirs["trained"].items():
        tol = 0.5 if k == "mIoU" else 100.0 / 9 + 1e-6
        assert abs(ours["trained"][k] - v) <= tol, (k, ours, theirs)
