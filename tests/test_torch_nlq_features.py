"""The port's NLQ feature extraction (``avion_tpu_torch.egonlq.features``,
``extract_features``) against ``avion_tpu.egonlq`` on the CPU, on the same
tiny f32 CLIP (the JAX one with ``use_flash=False``, its weights carried by
``params_from_jax``): ``strip_projection``, the windowed video features
(projected, not normalized: ``embed_dim`` wide) and the normalized query
features within 1e-5, ``extract_to_dir``'s ``.npz`` files, and
``extract_features.main`` on a ``.pt`` of those weights, with its refusal
without CUDA.  Both sides decode with cv2 (``backend="cv2"``), so they see
the same frames whether or not the native decoder is built."""

import functools
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.data import video_reader as jvr
from avion_tpu.egonlq import features as jfeat
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu_torch.data import video_reader as pvr
from avion_tpu_torch.egonlq import extract_features, features
from avion_tpu_torch.models.clip import CLIP
from avion_tpu_torch.models.pt_import import params_from_jax

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
DIMS = dict(embed_dim=16, image_size=32, patch_size=16, num_frames=2,
            vision_width=32, vision_layers=1, vision_heads=2,
            context_length=77, vocab_size=49408, text_width=16,
            text_heads=2, text_layers=1)
FX = dict(clip_length=2, window_sec=1.0, crop_size=32, batch=2)


@pytest.fixture(autouse=True)
def cv2_decode(monkeypatch):
    monkeypatch.setattr(jfeat, "VideoReader",
                        functools.partial(jvr.VideoReader, backend="cv2"))
    monkeypatch.setattr(features, "VideoReader",
                        functools.partial(pvr.VideoReader, backend="cv2"))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """(JAX CLIP, its params, the port's state dict of the same weights)."""
    jm = JaxCLIP(**DIMS, use_flash=False, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 2, 32, 32, 3)),
                              jnp.zeros((1, 77), jnp.int32))["params"]
    return jm, params, params_from_jax(params)


def _port(sd):
    m = CLIP(**DIMS, dtype=torch.float32)
    m.load_state_dict(sd, strict=True)
    return m


@pytest.fixture(scope="module")
def nlq_video(tmp_path_factory):
    """A 3.5 s video at 10 fps (4 windows of 1 s, the last one short: the
    last batch of 2 is full; at batch 3 it is padded) and 3 queries."""
    pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("nlq_video"))
    return root, chip_smoke.write_nlq_fixture(root, seconds=3.5, w=48, h=40,
                                              fps=10, queries=3)


def test_strip_projection(clips):
    _, _, sd = clips
    m = _port(sd)
    vis = features.strip_projection(m)
    assert vis is m.visual
    assert not any("projection" in k for k in vis.state_dict())
    out = vis(torch.zeros(1, 2, 32, 32, 3))
    assert out.shape == (1, 32)  # width features, not embed_dim


@pytest.mark.parametrize("batch", [2, 3])
def test_video_and_text_features_match_jax(clips, nlq_video, batch):
    jm, params, sd = clips
    root, _ = nlq_video
    path = osp.join(root, "nlqvid0.mp4")
    fx = features.FeatureExtractor(_port(sd), **{**FX, "batch": batch})
    ref = jfeat.FeatureExtractor(jm, params, **{**FX, "batch": batch})
    got = fx.video_features(path)
    want = ref.video_features(path)
    assert got.shape == (4, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # projected, not normalized
    assert not np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-3)
    queries = ["where is the cup", "who did I talk to after lunch?"]
    t = fx.text_features(queries)
    np.testing.assert_allclose(t, ref.text_features(queries), **TOL)
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-5)
    assert fx.stats["windows"] == 4 and fx.stats["queries"] == 2


def test_extract_to_dir_matches_jax(clips, nlq_video, tmp_path):
    jm, params, sd = clips
    root, ann = nlq_video
    from avion_tpu.egonlq.nlq_dataset import parse_nlq_annotations

    samples = parse_nlq_annotations(ann)
    features.FeatureExtractor(_port(sd), **FX).extract_to_dir(
        samples, root, str(tmp_path / "ours"))
    jfeat.FeatureExtractor(jm, params, **FX).extract_to_dir(
        samples, root, str(tmp_path / "ref"))
    for i in range(len(samples)):
        a = np.load(tmp_path / "ours" / f"feat_{i}.npz")
        b = np.load(tmp_path / "ref" / f"feat_{i}.npz")
        assert sorted(a.files) == ["text", "video"]
        assert a["video"].shape == (4, 16) and a["text"].shape == (16,)
        for k in ("video", "text"):
            np.testing.assert_allclose(a[k], b[k], **TOL)


def _main_args(ckpt, root, ann, out):
    return ["--ckpt", ckpt, "--model", "CLIP_TINY", "--annotations", ann,
            "--video-root", root, "--out", out, "--clip-length", "2",
            "--window-sec", "1.0", "--batch", "2"]


def test_extract_features_main_on_the_cpu(clips, nlq_video, tmp_path):
    """``main`` loads a ``.pt`` into ``CLIP_TINY`` (f32) and writes what
    the extractor writes on the same weights."""
    root, ann = nlq_video
    m = CLIP(**{**DIMS, "embed_dim": 32, "vision_width": 64,
                "vision_layers": 2, "text_width": 32, "text_layers": 2},
             dtype=torch.float32)
    m.init_weights(torch.Generator().manual_seed(3))
    ckpt = str(tmp_path / "tiny.pt")
    torch.save({"state_dict": m.state_dict()}, ckpt)
    out = str(tmp_path / "feats")
    stats = extract_features.main(_main_args(ckpt, root, ann, out)
                                  + ["--device", "cpu"])
    assert stats["windows"] == 4 and stats["queries"] == 3
    from avion_tpu_torch.egonlq.nlq_dataset import parse_nlq_annotations

    fx = features.FeatureExtractor(m, **FX)
    video = fx.video_features(osp.join(root, "nlqvid0.mp4"))
    for i, s in enumerate(parse_nlq_annotations(ann)):
        z = np.load(osp.join(out, f"feat_{i}.npz"))
        np.testing.assert_allclose(z["video"], video, **TOL)
        np.testing.assert_allclose(z["text"],
                                   fx.text_features([s["query"]])[0], **TOL)


def test_extract_features_needs_cuda_unless_told_the_cpu(nlq_video, tmp_path,
                                                         monkeypatch):
    root, ann = nlq_video
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "feats")
    with pytest.raises(RuntimeError, match="--device cpu"):
        extract_features.main(_main_args("missing.pt", root, ann, out))
    assert not osp.exists(out)


def test_legacy_needs_a_tokenizer_dir(nlq_video, tmp_path):
    root, ann = nlq_video
    with pytest.raises(SystemExit):
        extract_features.main(_main_args("x.pth", root, ann,
                                          str(tmp_path / "o")) + ["--legacy"])
