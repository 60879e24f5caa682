"""The port's EgoVLP legacy extractor (``avion_tpu_torch.egonlq.egovlp``)
against ``avion_tpu.egonlq.egovlp`` on the CPU, in f32: one released-layout
state dict (``tests/test_egovlp.py``'s writer: fusion, pooler and training
heads included) fed to both importers; FrozenInTime's video and text
features (with padding) within 1e-5, the temporal embedding's zero fill
and cut, ``params_from_jax`` of the JAX tree against the port's import,
``text_features_from_ids``, ``extract_to_dir`` with the RoBERTa tokenizer,
and ``extract_features --legacy`` end to end against the JAX CLI's files,
with its refusal without CUDA."""

import functools
import importlib.util
import json
import os
import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch

from avion_tpu.data import video_reader as jvr
from avion_tpu.egonlq import egovlp as jeg
from avion_tpu.egonlq import features as jfeat
from avion_tpu_torch.data import video_reader as pvr
from avion_tpu_torch.data.roberta_tokenizer import RobertaTokenizer
from avion_tpu_torch.egonlq import egovlp, extract_features, features
from avion_tpu_torch.models.pt_import import params_from_jax

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "_jax_egovlp_test", osp.join(ROOT, "tests", "test_egovlp.py"))
ref_test = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_test)

TOL = dict(atol=1e-5, rtol=1e-5)
FRAMES, IMG, W, VOCAB = ref_test.FRAMES, ref_test.IMG, ref_test.W, \
    ref_test.VOCAB


@pytest.fixture(scope="module")
def released():
    """(the released-layout state dict, the JAX model and params, the
    port's model), heads 1 (width 32 / 64, the loaders' rule)."""
    sd = ref_test._make_state(np.random.RandomState(0))
    params = jeg.import_egovlp_state(sd, num_frames=FRAMES,
                                     layers=ref_test.LAYERS,
                                     text_layers=ref_test.TEXT_LAYERS)
    jm = jeg.FrozenInTime(num_frames=FRAMES, image_size=IMG, width=W,
                          heads=1, layers=ref_test.LAYERS,
                          text_layers=ref_test.TEXT_LAYERS,
                          projection_dim=ref_test.PROJ, vocab_size=VOCAB,
                          max_positions=ref_test.MAXPOS)
    pm = egovlp.load_egovlp_checkpoint(sd, num_frames=FRAMES)
    return sd, jm, params, pm


def test_import_reads_the_released_layout(released):
    sd, _, params, pm = released
    assert pm.video_model.width == W and len(pm.video_model.blocks) == 2
    assert pm.vid_proj[4].out_features == ref_test.PROJ
    state = egovlp.import_egovlp_state(sd, num_frames=FRAMES)
    assert not any(k.startswith(("mlm_score", "itm_score", "cross_modal"))
                   or "qkv_text_i2t" in k or "alpha_" in k or "pooler" in k
                   for k in state)
    assert set(state) == set(pm.state_dict())
    # the flax tree carried across is the same state dict
    carried = params_from_jax(params)
    assert set(carried) == set(state)
    for k, v in state.items():
        torch.testing.assert_close(carried[k], v, rtol=0, atol=0, msg=k)
    module_sd = {"module." + k: v for k, v in sd.items()}
    again = egovlp.import_egovlp_state(module_sd, num_frames=FRAMES)
    assert all(torch.equal(again[k], v) for k, v in state.items())


def test_video_features_match_jax(released):
    _, jm, params, pm = released
    video = np.random.RandomState(1).randn(
        2, FRAMES, IMG, IMG, 3).astype(np.float32)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v,
                                         method=jm.compute_video))(params,
                                                                   video)
    with torch.no_grad():
        got = pm.compute_video(torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_text_features_with_padding_match_jax(released):
    _, jm, params, pm = released
    rs = np.random.RandomState(2)
    ids = rs.randint(2, VOCAB, (3, 10)).astype(np.int32)
    ids[0, 6:] = 1
    ids[2, 3:] = 1
    mask = (ids != 1).astype(np.int32)
    want = jax.jit(lambda p, i, m: jm.apply({"params": p}, i, m,
                                            method=jm.compute_text))(
        params, ids, mask)
    with torch.no_grad():
        got = pm.compute_text(torch.from_numpy(ids).long(),
                              torch.from_numpy(mask).long())
        no_mask = pm.compute_text(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(no_mask, got)  # mask from the pad id


@pytest.mark.parametrize("frames", [1, 2, 4])
def test_temporal_embedding_fill_and_cut(released, frames):
    sd = released[0]
    got = egovlp.import_egovlp_state(sd, num_frames=frames)
    want = jeg.import_egovlp_state(sd, num_frames=frames,
                                   layers=ref_test.LAYERS,
                                   text_layers=ref_test.TEXT_LAYERS)
    np.testing.assert_array_equal(got["video_model.temporal_embed"][0],
                                  want["video_model"]["temporal_embed"])
    m = egovlp.load_egovlp_checkpoint(sd, num_frames=frames)
    assert m.video_model.temporal_embed.shape == (1, frames, W)


def test_text_features_from_ids_match_jax(released):
    _, jm, params, pm = released
    ids = np.random.RandomState(3).randint(2, VOCAB, (2, 8)).astype(np.int32)
    ids[1, 5:] = 1
    want = jeg.EgoVLPFeatureExtractor(jm, params, clip_length=FRAMES,
                                      crop_size=IMG,
                                      batch=4).text_features_from_ids(ids)
    got = egovlp.EgoVLPFeatureExtractor(pm, clip_length=FRAMES,
                                        crop_size=IMG,
                                        batch=4).text_features_from_ids(ids)
    assert got.shape == (2, ref_test.PROJ) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def _tok_dir(root):
    """A made-up RoBERTa tokenizer directory whose ids stay below the
    tiny text tower's vocabulary (uncovered bytes fall to <unk>)."""
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}
    for ch in "abcdefghiklmnoprstuwyĠ?":
        vocab[ch] = len(vocab)
    merges = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("Ġ", "w")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    assert len(vocab) <= VOCAB
    d = osp.join(root, "tok")
    os.makedirs(d, exist_ok=True)
    with open(osp.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(osp.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return d


@pytest.fixture(scope="module")
def legacy_fixture(tmp_path_factory, released):
    """A 3 s video at 10 fps at 48x40, 3 short queries (the tiny text
    tower has 24 positions), the released layout as a ``.pth`` and a
    tokenizer directory."""
    pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("egovlp"))
    ann = chip_smoke.write_nlq_fixture(root, seconds=3, w=48, h=40, fps=10,
                                       queries=3)
    with open(ann) as f:
        data = json.load(f)
    queries = data["videos"][0]["clips"][0]["annotations"][0][
        "language_queries"]
    for q, text in zip(queries, ("the cup?", "where is it", "who")):
        q["query"] = text
    with open(ann, "w") as f:
        json.dump(data, f)
    ckpt = osp.join(root, "egovlp.pth")
    torch.save({"state_dict": released[0]}, ckpt)
    return root, ann, ckpt, _tok_dir(root)


@pytest.fixture(autouse=True)
def cv2_decode(monkeypatch):
    monkeypatch.setattr(jfeat, "VideoReader",
                        functools.partial(jvr.VideoReader, backend="cv2"))
    monkeypatch.setattr(features, "VideoReader",
                        functools.partial(pvr.VideoReader, backend="cv2"))


def _cli(ckpt, root, ann, tok, out):
    return ["--legacy", "--ckpt", ckpt, "--tokenizer-dir", tok,
            "--annotations", ann, "--video-root", root, "--out", out,
            "--clip-length", str(FRAMES), "--window-sec", "1.0",
            "--batch", "2"]


def test_legacy_cli_matches_jax(legacy_fixture, tmp_path):
    """``--legacy`` from raw text: the released ``.pth`` with its inferred
    geometry, the in-repo RoBERTa BPE, the windowed sweep; every file
    against the JAX CLI's."""
    from avion_tpu.egonlq.extract_features import main as jax_main

    root, ann, ckpt, tok = legacy_fixture
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    stats = extract_features.main(_cli(ckpt, root, ann, tok, ours)
                                  + ["--device", "cpu"])
    jax_main(_cli(ckpt, root, ann, tok, ref))
    assert stats["windows"] == 3 and stats["queries"] == 3
    for i in range(3):
        a, b = (np.load(osp.join(d, f"feat_{i}.npz")) for d in (ours, ref))
        assert a["video"].shape == (3, ref_test.PROJ)
        assert a["text"].shape == (ref_test.PROJ,)
        for k in ("video", "text"):
            np.testing.assert_allclose(a[k], b[k], **TOL)


def test_extractor_tokenizes_raw_text_as_jax(released, legacy_fixture):
    _, jm, params, pm = released
    tok = legacy_fixture[3]
    from avion_tpu.data.roberta_tokenizer import \
        RobertaTokenizer as JaxTokenizer

    queries = ["where is the cup?", "what did I wash", ""]
    got = egovlp.EgoVLPFeatureExtractor(
        pm, tokenizer=RobertaTokenizer.from_dir(tok), clip_length=FRAMES,
        crop_size=IMG).text_features(queries)
    want = jeg.EgoVLPFeatureExtractor(
        jm, params, tokenizer=JaxTokenizer.from_dir(tok), clip_length=FRAMES,
        crop_size=IMG).text_features(queries)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="tokenizer"):
        egovlp.EgoVLPFeatureExtractor(pm).text_features(queries)


def test_legacy_cli_needs_cuda_unless_told_the_cpu(legacy_fixture, tmp_path,
                                                   monkeypatch):
    root, ann, ckpt, tok = legacy_fixture
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "feats")
    with pytest.raises(RuntimeError, match="--device cpu"):
        extract_features.main(_cli(ckpt, root, ann, tok, out))
    assert not osp.exists(out)
