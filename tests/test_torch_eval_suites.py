"""The five zero-shot suites through ``build_suites`` and ``validate_all`` of
both packages, on the layouts ``chip_smoke.write_eval_fixtures`` writes
(tiny: 64x48 at 10 fps) and ``CLIP_TINY`` weights carried across by
``params_from_jax``, in f32 on the CPU with cv2 decoding on both sides.

Embeddings and text-classifier weights agree within 2e-5 (the f32 forward
tolerance of tests/test_flash_attention.py); every metric within 1e-6.
The metrics depend only on orderings, so each test first asserts that the
port's similarities carry no near-tie (a gap above 1e-4 wherever an
ordering decides a metric) that a 2e-5 difference could flip."""

import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from avion_tpu.data import video_reader as jvr
from avion_tpu.eval import runners as jrunners
from avion_tpu.eval.validate import build_suites as jax_build_suites
from avion_tpu.models.registry import create_model as jax_create_model
from avion_tpu_torch.core.config import DataConfig
from avion_tpu_torch.data import video_reader as pvr
from avion_tpu_torch.eval import runners
from avion_tpu_torch.eval.validate import build_suites
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.train.finetune_cls import load_actions

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

TINY = dict(w=64, h=48, fps=10, chunk_s=2, clip_s=2, mir_clips=6,
            egtea_clips=4, charades_videos=4, charades_classes=5,
            mcq_items=4)
SUITES = ["ek100_mir", "ek100_cls", "egtea", "charades_ego", "egomcq"]
EMB_TOL = 2e-5
METRIC_TOL = 1e-6
GAP = 1e-4


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return chip_smoke.write_eval_fixtures(
        str(tmp_path_factory.mktemp("eval")), seed=0, **TINY)


@pytest.fixture(scope="module")
def models():
    jm = jax_create_model("CLIP_TINY", num_frames=2)
    # a seed whose similarities on this layout keep every deciding gap
    # above GAP (asserted in each suite's test)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 2, 32, 32, 3)),
                     jnp.zeros((1, 77), jnp.int32))["params"]
    pm = create_model("CLIP_TINY", num_frames=2)
    pm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jm, params, pm


@pytest.fixture(autouse=True)
def cv2_both(monkeypatch):
    monkeypatch.setattr(jvr, "_lib", None)
    monkeypatch.setattr(jvr, "_lib_tried", True)
    monkeypatch.setattr(pvr, "_native_lib", lambda: None)


def _recording(base):
    class Recording(base):
        """Keeps every embedding it returns, by modality, in call order."""

        def encode_images(self, videos):
            out = super().encode_images(videos)
            self.seen.setdefault("image", []).append(out)
            return out

        def encode_texts(self, texts):
            out = super().encode_texts(texts)
            self.seen.setdefault("text", []).append(out)
            return out

    return Recording


def _encoders(models):
    jm, params, pm = models
    jenc = _recording(jrunners.CLIPEncoders)(jm, params, batch=4)
    penc = _recording(runners.CLIPEncoders)(pm, batch=4, weight_dtype="f32")
    jenc.seen, penc.seen = {}, {}
    return jenc, penc


def _cfg(layout):
    return DataConfig(**layout["data"], clip_length=2, crop_size=32,
                      val_batch_size=4, num_workers=0)


def _sorted_gaps(x, axis):
    return np.diff(np.sort(x, axis=axis), axis=axis)


def _record_orderings(monkeypatch):
    """Wrap the port's metric functions to check, on their inputs, the
    gaps at which an ordering decides the metric."""
    gaps = []

    def full(fn, axes):  # the whole ranking counts (mAP, nDCG)
        def wrapped(scores, *args):
            gaps.extend(_sorted_gaps(scores, a).min() for a in axes
                        if scores.shape[a] > 1)
            return fn(scores, *args)
        return wrapped

    def topk(fn):  # only the boundary after each k counts
        def wrapped(scores, labels, ks=(1,)):
            s = -np.sort(-scores, axis=1)
            gaps.extend((s[:, k - 1] - s[:, k]).min() for k in ks
                        if k < s.shape[1])
            return fn(scores, labels, ks)
        return wrapped

    def argmax(fn):
        def wrapped(scores, *args):
            s = -np.sort(-scores, axis=1)
            gaps.append((s[:, 0] - s[:, 1]).min())
            return fn(scores, *args)
        return wrapped

    monkeypatch.setattr(runners, "get_map", full(runners.get_map, (0, 1)))
    monkeypatch.setattr(runners, "get_ndcg", full(runners.get_ndcg, (0, 1)))
    monkeypatch.setattr(runners, "charades_map",
                        full(runners.charades_map, (0,)))
    monkeypatch.setattr(runners, "topk_accuracy",
                        topk(runners.topk_accuracy))
    monkeypatch.setattr(runners, "egomcq_accuracy",
                        argmax(runners.egomcq_accuracy))
    return gaps


@pytest.mark.parametrize("suite", SUITES)
def test_suite_matches_jax(layout, models, monkeypatch, suite):
    cfg, env = _cfg(layout), layout["env"]
    jenc, penc = _encoders(models)
    jsuites = jax_build_suites(jenc, cfg, env)
    psuites = build_suites(cfg, env)
    assert list(psuites) == list(jsuites) == SUITES
    gaps = _record_orderings(monkeypatch)
    got = runners.validate_all(penc, {suite: psuites[suite]}, strict=True)
    want = jrunners.validate_all(jenc, {suite: jsuites[suite]}, strict=True)

    for kind in ("image", "text"):
        a = np.concatenate(penc.seen[kind])
        b = np.concatenate(jenc.seen[kind])
        assert a.shape == b.shape and np.isfinite(a).all(), kind
        np.testing.assert_allclose(a, b, rtol=0, atol=EMB_TOL, err_msg=kind)
    assert gaps and min(gaps) > GAP, gaps
    assert got.keys() == want.keys() and got, (got, want)
    assert all(np.isfinite(v) for v in got.values()), got
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=METRIC_TOL, err_msg=key)
    stats = penc.suite_stats[suite]
    assert stats["image_rows"] == np.concatenate(penc.seen["image"]).shape[0]
    assert stats["wall_s"] >= stats["data_wait_s"] > 0


def _labels(layout, suite):
    env = layout["env"]
    if suite == "ek100_cls":
        return load_actions(env["EK100_ACTIONS_CSV"])[0]
    from avion_tpu_torch.data.metadata import generate_label_map

    if suite == "egtea":
        return generate_label_map("egtea", {"action_idx": osp.join(
            env["EGTEA_META_DIR"], "action_idx.txt")})
    return generate_label_map("charades_ego", {"classes_txt": osp.join(
        env["CHARADES_META_DIR"], "Charades_v1_classes.txt")})


@pytest.mark.parametrize("suite", ["ek100_cls", "egtea", "charades_ego"])
def test_text_classifier_matches_jax(layout, models, suite):
    """One sweep over every prompt against the JAX package's label-by-label
    encoding."""
    labels = _labels(layout, suite)
    jenc, penc = _encoders(models)
    got = runners.build_text_classifier(penc, labels)
    want = jrunners.build_text_classifier(jenc, labels)
    assert got.shape == want.shape == (len(labels), 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)
    assert penc.text_calls == -(-2 * len(labels) // 4)


def test_inference_copy_leaves_the_model_as_it_was(layout, models):
    """``run_validation`` encodes a bf16 copy: the model it is handed
    keeps its mode, its f32 weights and their values."""
    from avion_tpu_torch.eval.validate import run_validation

    model = create_model("CLIP_TINY", num_frames=2, dtype=torch.bfloat16)
    model.load_state_dict(models[2].state_dict())
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = _cfg(layout)
    res = run_validation(model, cfg, {})
    assert set(res) == {f"test_ek100_mir_{k}" for k in (
        "vis_map", "txt_map", "avg_map", "vis_ndcg", "txt_ndcg", "avg_ndcg")}
    assert all(np.isfinite(v) for v in res.values())
    assert model.training and all(m.training for m in model.modules())
    after = model.state_dict()
    for k, v in before.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k
    assert run_validation(model, DataConfig(), {}) == {}
