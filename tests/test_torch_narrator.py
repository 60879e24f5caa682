"""The port's VCLM narrator against ``avion_tpu.models.narrator`` on the CPU,
on the same weights (a tiny VCLM, the dims of ``tests/test_narrator.py``,
f32, every parameter perturbed so the gates are open): logits (1e-4),
``caption_loss`` (1e-6), the nucleus filter's kept set, ``decode_one``
(1e-4), cached and uncached generation token for token at ``temperature
1e-6`` (the filter keeps one token, so the draws do not matter), one SGD
step's gradients (5e-4), the weight-decay mask and layer ids of every
parameter against optax's; ``train_narrator.main`` on a 64x48
``chip_smoke.write_ego4d_fixture`` layout with a resume that takes no
step, and its refusal without CUDA; ``narrate_video`` /
``narrate_dataset`` rows against JAX's with a deterministic captioner;
``vclm_captioner`` end to end; the tokenizer's ``decode`` against JAX's.
The JAX side runs jitted."""

import json
import os
import os.path as osp
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.models import narrator as jn
from avion_tpu.models.gpt2_gated import make_decode_cache as jax_cache
from avion_tpu.optim import factory as jax_factory
from avion_tpu.train.train_narrator import make_narrator_step as jax_step
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.models import narrator as pn
from avion_tpu_torch.models.gpt2_gated import make_decode_cache
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.models.registry import create_model, register_model
from avion_tpu_torch.optim import factory
from avion_tpu_torch.train import train_narrator
from torch_native_decode import backend, native_decode_lib  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

TINY = dict(vocab_size=64, context_length=12, width=32, layers=2, heads=2,
            cross_every=1, image_size=32, patch_size=16, num_frames=2,
            vision_width=32, vision_layers=1, vision_heads=2)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)


def perturbed(params, seed=0, scale=0.05):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + scale * rs.standard_normal(np.shape(x)).astype(np.float32), params)


@pytest.fixture(scope="module")
def tiny():
    jm = jn.VCLM(**TINY, use_flash=False, dtype=jnp.float32)
    rs = np.random.RandomState(1)
    video = rs.standard_normal((2, 2, 32, 32, 3)).astype(np.float32)
    tokens = rs.randint(1, 64, (2, 12)).astype(np.int32)
    tokens[0, 8:] = 0  # padding targets
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), video, tokens)["params"]
    params = perturbed(params)
    pm = pn.VCLM(**TINY, dtype=torch.float32)
    pm.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, pm.eval(), video, tokens


def test_logits_and_caption_loss_match_jax(tiny):
    jm, params, pm, video, tokens = tiny
    ref = np.array(jax.jit(jm.apply)({"params": params}, video, tokens))
    with torch.no_grad():
        got = pm(torch.from_numpy(video), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), ref, **LOGIT_TOL)
    loss = pn.caption_loss(torch.from_numpy(ref), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss),
                               float(jn.caption_loss(ref, tokens)),
                               atol=1e-6, rtol=1e-6)
    # the gates are open: the video changes the logits
    with torch.no_grad():
        moved = pm(torch.from_numpy(video) + 1.0, torch.from_numpy(tokens))
    assert (moved - got).abs().max() > 1e-3


@pytest.mark.parametrize("top_p,temperature", [(0.95, 0.7), (0.5, 1.0),
                                               (0.95, 1e-6)])
def test_nucleus_filter_keeps_the_jax_set(monkeypatch, top_p, temperature):
    logits = np.random.RandomState(2).standard_normal((4, 64)).astype(
        np.float32) * 3
    # JAX's filtered logits: its categorical draw replaced by the identity
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, x, axis=-1: x)
    ref = np.asarray(jn.nucleus_sample_step(jax.random.PRNGKey(0), logits,
                                            top_p, temperature))
    got = pn.nucleus_filter(torch.from_numpy(logits), top_p,
                            temperature).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    if temperature < 1e-3:
        assert (np.isfinite(got).sum(-1) == 1).all()
    g = torch.Generator().manual_seed(0)
    draws = pn.nucleus_sample_step(g, torch.from_numpy(logits), top_p,
                                   temperature).numpy()
    assert np.isfinite(got[np.arange(4), draws]).all()


def test_decode_one_matches_jax(tiny):
    jm, params, pm, video, tokens = tiny
    toks = tokens[:, :7]
    visual = jax.jit(lambda p, v: jm.apply({"params": p}, v,
                                           method=jm.encode_video))(params,
                                                                    video)
    cross = jm.apply({"params": params}, visual, method=jm.precompute_cross)
    kv = jax_cache(jm.layers, 2, 7, jm.width, jnp.float32)
    one = jax.jit(lambda p, t, i, kv, c: jm.apply(
        {"params": p}, t, i, kv, c, method=jm.decode_one))
    with torch.no_grad():
        pv = pm.encode_video(torch.from_numpy(video))
        pcross = pm.precompute_cross(pv)
        pkv = make_decode_cache(pm.layers, 2, 7, pm.width)
        full = pm.decode(torch.from_numpy(toks), pv).numpy()
        for i in range(7):
            ref, kv = one(params, toks[:, i:i + 1], i, kv, cross)
            got, pkv = pm.decode_one(torch.from_numpy(toks[:, i:i + 1]), i,
                                     pkv, pcross)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       err_msg=f"step {i}", **LOGIT_TOL)
            np.testing.assert_allclose(got.numpy(), full[:, i], **LOGIT_TOL)


@pytest.mark.parametrize("use_cache", [True, False], ids=["cached",
                                                          "uncached"])
def test_generation_is_token_equal_at_temperature_1e_6(tiny, use_cache):
    jm, params, pm, video, _ = tiny
    kw = dict(max_len=9, sot=62, eot=63, temperature=1e-6,
              use_cache=use_cache)
    ref = np.asarray(jax.jit(jn.make_generator(jm, **kw))(
        params, video, jax.random.PRNGKey(3)))
    got = pn.make_generator(pm, **kw)(torch.from_numpy(video),
                                      torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got[:, 0] == 62).all()


def _sgd_opt():
    return dict(optimizer="sgd", lr=0.1, momentum=0.9, wd=0.0,
                warmup_epochs=0.0, epochs=1, grad_clip_norm=None)


def test_step_gradients_match_jax(tiny):
    """One SGD step (the first update is the gradient times lr) on both
    sides, from the same weights and batch."""
    jm, params, _, video, tokens = tiny
    tx, _ = jax_factory.build_optimizer(JaxOptimConfig(**_sgd_opt()), params,
                                        4, num_layers=jm.layers)
    state = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                 tx)
    batch = {"video": video, "text": tokens}
    state, metrics = jax.jit(jax_step(jm, tx))(state, batch,
                                               jax.random.PRNGKey(0))
    ref = params_from_jax(jax.device_get(state.params))
    pm = pn.VCLM(**TINY, dtype=torch.float32)
    sd0 = params_from_jax(params)
    pm.load_state_dict(sd0, strict=True)
    opt, _ = factory.build_optimizer(OptimConfig(**_sgd_opt()), pm, 4,
                                     num_layers=pm.layers)
    pstate = TrainState.create(pm, opt)
    pstate, pmetrics = train_narrator.make_narrator_step(pm)(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(pmetrics["loss"]),
                               float(metrics["loss"]), atol=1e-5, rtol=1e-5)
    assert pmetrics["step_ok"] == 1.0 and pstate.step == 1
    got = pm.state_dict()
    for k, want in ref.items():
        g = (sd0[k] - got[k]).numpy() / 0.1
        np.testing.assert_allclose(g, (sd0[k] - want).numpy() / 0.1,
                                   err_msg=k, **GRAD_TOL)


def _leafwise(tree, params):
    """A per-parameter value tree as the port's state dict (each value
    broadcast to its parameter's shape, so the names follow
    ``params_from_jax``)."""
    full = jax.tree_util.tree_map(
        lambda v, p: np.full(np.shape(p), float(v), np.float32), tree,
        params)
    return {k: float(v.reshape(-1)[0]) for k, v in
            params_from_jax(full).items()}


@pytest.mark.parametrize("layer_decay", [0.0, 0.75])
def test_decay_mask_and_layer_ids_match_optax(tiny, layer_decay):
    jm, params, pm, _, _ = tiny
    mask = _leafwise(jax_factory.wd_mask(params), params)
    scales = _leafwise(jax_factory.layer_decay_scales(
        params, jm.layers, 0.75), params)
    named = dict(pm.named_parameters())
    assert named.keys() == mask.keys()
    for name, p in named.items():
        assert factory.wd_mask(name, p) == bool(mask[name]), name
        np.testing.assert_allclose(
            factory.layer_decay_scale(name, pm.layers, 0.75), scales[name],
            err_msg=name)
    assert mask["pos_embed"] == 1.0 and mask["blocks.0.attn_gate"] == 0.0
    opt, _ = factory.build_optimizer(
        OptimConfig(optimizer="adamw", layer_decay=layer_decay), pm, 4,
        num_layers=pm.layers)
    assert sum(len(g["params"]) for g in opt.inner.param_groups) == \
        len(named)


def test_registry_and_pipeline_refusal():
    with torch.device("meta"):
        m = create_model("VCLM_VITB16", vision_heads=6, heads=4)
    assert m.visual.transformer.resblocks[0].attn.heads == 6
    assert m.blocks[0].attn.heads == 4 and m.dtype == torch.bfloat16
    assert [b.cross_attend for b in m.blocks] == [i % 2 == 0
                                                  for i in range(12)]
    # the pipelined decoder keeps the sequential names; cached decoding
    # needs the sequential stack and refuses, with JAX's advice
    with torch.device("meta"):
        p = create_model("VCLM_VITB16", pipeline=True,
                         pipeline_microbatches=4, pipeline_remat=True)
        seq = create_model("VCLM_VITB16")
    assert p.state_dict().keys() == seq.state_dict().keys()
    assert len(p.blocks.units()) == 6 and p.blocks.num_microbatches == 4
    assert p.blocks.remat
    with pytest.raises(RuntimeError, match="sequential block layout"):
        p.precompute_cross(torch.zeros(1, 4, 512, device="meta"))


# -- the entry ----------------------------------------------------------------


@register_model("VCLM_TINY_TEST")
def _tiny_test(num_frames=2, dtype=None, **_):
    return pn.VCLM(vocab_size=49408, context_length=16, width=32, layers=1,
                   heads=2, cross_every=1, image_size=32, patch_size=16,
                   num_frames=num_frames, vision_width=32, vision_layers=1,
                   vision_heads=2, dtype=dtype or torch.float32)


@pytest.fixture(scope="module")
def ego4d(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    del cv2
    root = str(tmp_path_factory.mktemp("ego4d"))
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("DATA_W", 64), ("DATA_H", 48), ("DATA_ROWS", 16)):
            mp.setattr(chip_smoke, name, value)
        meta = chip_smoke.write_ego4d_fixture(root)
    return root, meta


def _entry_args(fx, out, *extra):
    root, meta = fx
    return ["model.name=VCLM_TINY_TEST", f"data.root={root}",
            f"data.train_metadata={meta}", "data.clip_length=2", "data.crop_size=32", "data.batch_size=8",
            "data.num_workers=0", "optim.epochs=1", "optim.lr=1e-3",
            "optim.warmup_epochs=0", f"output_dir={out}", "print_freq=1",
            *extra]


def test_main_trains_on_decoded_video_and_resumes(ego4d, tmp_path):
    out = str(tmp_path / "run")
    args = _entry_args(ego4d, out, "--device", "cpu")
    res = train_narrator.main(args)
    assert res["steps"] == res["step"] == 2
    assert np.isfinite(res["epochs"][0]["loss"])
    assert res["epochs"][0]["step_ok"] == 1.0
    logs = [json.loads(line) for line in open(osp.join(out, "log.jsonl"))]
    assert [r["step"] for r in logs] == [1, 2]
    assert all(np.isfinite(r["train/loss"]) for r in logs)
    assert os.listdir(osp.join(out, "ckpt")) == ["2"]
    cfg = json.load(open(osp.join(out, "config.json")))
    assert cfg["model"]["name"] == "VCLM_TINY_TEST"
    again = train_narrator.main(args)  # restores, nothing left to train
    assert again["steps"] == 0 and again["step"] == 2


def test_main_needs_cuda_unless_told_the_cpu(ego4d, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_narrator.main(_entry_args(ego4d, out))
    assert not osp.exists(out)


def test_main_refuses_sequence_parallel(ego4d, tmp_path):
    """``mesh.sp`` is accepted (its ranks hold replicas, as in JAX;
    ``test_torch_parallel_sp_entries``), but one process cannot hold two of
    them: the mesh refuses before the model is built."""
    with pytest.raises(ValueError, match=r"1 ranks do not divide by .* = 2"):
        train_narrator.main(_entry_args(ego4d, str(tmp_path / "run"),
                                        "mesh.sp=2", "--device", "cpu"))


# -- the tool -----------------------------------------------------------------


def _stub_caption(frames):
    """Deterministic narrations of a clip (its shape and mean)."""
    m = float(np.asarray(frames, np.float64).mean())
    return [f"clip {frames.shape[0]} {frames.shape[1]} mean {m:.3f}",
            "the same words"]


def test_narrate_rows_match_jax(ego4d, tmp_path, backend):
    from avion_tpu.tools import narrator as jax_tool
    from avion_tpu_torch.tools import narrator as tool

    root, _ = ego4d
    paths = [osp.join(root, "vid0.mp4", "0.mp4"),
             osp.join(root, "vid1.mp4", "15.mp4")]
    kw = dict(window_sec=4.0, stride_sec=3.0, clip_length=2, crop_size=32)
    for path in paths:
        assert tool.narrate_video(path, _stub_caption, **kw) == \
            jax_tool.narrate_video(path, _stub_caption, **kw)
    # the dedup merges windows whose first captions overlap
    merged = tool.narrate_video(paths[0], lambda f: ["same"], **kw)
    assert len(merged) == 1 and merged[0][0] == 0.0
    outs = [str(tmp_path / f"{n}.pkl") for n in ("port", "jax")]
    n = tool.narrate_dataset(paths, _stub_caption, outs[0], **kw)
    assert n == jax_tool.narrate_dataset(paths, _stub_caption, outs[1], **kw)
    rows = [pickle.load(open(p, "rb")) for p in outs]
    assert rows[0] == rows[1] and rows[0][0][0] == "0"


def test_vclm_captioner_end_to_end(ego4d, tmp_path):
    from avion_tpu_torch.tools import narrator as tool

    model = _tiny_test().init_weights(torch.Generator().manual_seed(0))
    cap = tool.vclm_captioner(model, num_samples=2, max_len=6)
    root, _ = ego4d
    out = str(tmp_path / "narr.pkl")
    n = tool.narrate_dataset([osp.join(root, "vid0.mp4", "0.mp4")], cap, out,
                             window_sec=5.0, stride_sec=5.0, clip_length=2,
                             crop_size=32, dedup_threshold=1.1)
    rows = pickle.load(open(out, "rb"))
    assert n == len(rows) == 3  # a 15 s chunk
    assert all(len(r[3]) == 2 and all(isinstance(c, str) for c in r[3])
               for r in rows)


def test_hf_captioner_needs_cuda_unless_told_the_cpu(monkeypatch):
    """The device is resolved before ``transformers`` is imported: without
    CUDA the default raises and nothing is loaded."""
    from avion_tpu_torch.tools import narrator as tool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(sys.modules, "transformers", None)  # no import
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.hf_captioner()
    with pytest.raises(ImportError):  # the CPU passes on to the import
        tool.hf_captioner(device="cpu")


def test_tokenizer_decode_matches_jax():
    from avion_tpu.data.tokenizer import _default_tokenizer as jax_tok
    from avion_tpu_torch.data.tokenizer import _default_tokenizer

    tk, jtk = _default_tokenizer(), jax_tok()
    for text in ["#C C opens the drawer", "a person cuts 3 onions!",
                 "naive cafe"]:
        ids = jtk.encode(text)
        assert tk.decode(ids) == jtk.decode(ids)
        assert tk.decode(tk.encode(text)).strip() == jtk.decode(ids).strip()
    ids = list(range(0, 49408, 997)) + [tk.sot_token, tk.eot_token]
    assert tk.decode(ids) == jtk.decode(ids)
