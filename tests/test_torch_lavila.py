"""The port's LaViLa narrator against ``avion_tpu.models.lavila`` on the CPU
(``LAVILA_NARRATOR_TINY``'s dims, f32, through ``params_from_jax``):
``SpaceTimeTransformer``, ``AttentionPool`` (``encode_image``),
``GatedGPT2LMHead`` and the whole narrator's logits (1e-4); GPT-2's cached
``decode_one`` against its teacher-forced logits (1e-4); a released-layout
``.pt`` written here (``tests/test_lavila_narrator.py``'s ``_mk_state``)
loaded with ``strict=True``, equal to JAX's ``import_lavila_narrator_pt``
+ ``merge_into_params``, and a file that misses a block refused; greedy
``generate``, cached and uncached, token for token; the weight-decay mask
and layer ids against optax's; ``lavila_captioner`` with a fake tokenizer
against JAX's at ``temperature 1e-6``; its default tokenizer's refusal
without ``transformers``.  The JAX side runs jitted."""

import importlib.util
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.models.lavila_import import \
    import_lavila_narrator_pt as jax_import
from avion_tpu.models.pt_import import merge_into_params
from avion_tpu.models.registry import create_model as jax_create_model
from avion_tpu.optim import factory as jax_factory
from avion_tpu_torch.models.gpt2_gated import make_decode_cache
from avion_tpu_torch.models.lavila import LavilaNarrator
from avion_tpu_torch.models.lavila_import import (import_lavila_narrator_pt,
                                                  load_lavila_narrator)
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.optim import factory

from test_torch_narrator import _leafwise, perturbed

TESTS = osp.dirname(osp.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "lavila_layout", osp.join(TESTS, "test_lavila_narrator.py"))
layout = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(layout)  # its released-layout writer and dims

TOL = dict(atol=1e-4, rtol=1e-4)
IMG, FRAMES = 32, 2


@pytest.fixture(scope="module")
def tiny():
    jm = jax_create_model("LAVILA_NARRATOR_TINY")
    rs = np.random.RandomState(0)
    video = rs.standard_normal((2, FRAMES, IMG, IMG, 3)).astype(np.float32)
    text = rs.randint(1, 96, (2, 7)).astype(np.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), video, text)["params"]
    params = perturbed(params, seed=1)
    pm = create_model("LAVILA_NARRATOR_TINY")
    pm.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, pm.eval(), video, text


def _apply(jm, params, fn, *args):
    return np.asarray(jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a, method=fn))(params, *args))


def test_towers_and_logits_match_jax(tiny):
    jm, params, pm, video, text = tiny
    with torch.no_grad():
        v = torch.from_numpy(video)
        tokens = pm.visual(v)
        np.testing.assert_allclose(
            tokens.numpy(), _apply(jm, params, lambda m, x: m.visual(x),
                                   video), **TOL)
        img = pm.encode_image(v)
        ref_img = _apply(jm, params, lambda m, x: m.encode_image(x), video)
        np.testing.assert_allclose(img.numpy(), ref_img, **TOL)
        logits = pm.text_decoder(torch.from_numpy(text), img)
        np.testing.assert_allclose(
            logits.numpy(), _apply(jm, params,
                                   lambda m, t, e: m.text_decoder(t, e),
                                   text, ref_img), **TOL)
        out = pm(v, torch.from_numpy(text))
    ref = jax.jit(jm.apply)({"params": params}, video, text)
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(ref["logits"]), **TOL)
    np.testing.assert_array_equal(out["labels"].numpy(), text[:, 1:])


def test_gpt2_cached_decode_matches_teacher_forcing(tiny):
    _, _, pm, _, text = tiny
    dec = pm.text_decoder
    enc = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (2, 8, 32)).astype(np.float32))
    with torch.no_grad():
        full = dec(torch.from_numpy(text), enc)
        cross = dec.precompute_cross(enc)
        kv = make_decode_cache(dec.layers, 2, text.shape[1], dec.width)
        for i in range(text.shape[1]):
            logit, kv = dec.decode_one(torch.from_numpy(text[:, i:i + 1]), i,
                                       kv, cross)
            np.testing.assert_allclose(logit.numpy(), full[:, i].numpy(),
                                       err_msg=f"step {i}", **TOL)


def _small_model():
    return LavilaNarrator(
        image_size=layout.IMG, patch_size=layout.PATCH,
        num_frames=layout.FRAMES, vision_width=layout.VW,
        vision_layers=layout.VL, vision_heads=layout.VH,
        vocab_size=layout.VOCAB, max_positions=64, text_width=layout.TW,
        text_layers=layout.TL, text_heads=layout.TH,
        cross_freq=layout.CROSS_FREQ, num_img_queries=layout.NQ,
        pool_heads=layout.POOL_H, pool_dim_head=layout.POOL_D)


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """A released-layout ``.pt`` (DDP's ``module.`` prefix, gamma-only pool
    norms, the tied LM head and HF's mask buffers) and JAX's params from
    it."""
    sd = layout._mk_state(np.random.RandomState(5))
    on_disk = dict(sd)
    on_disk["text_decoder.lm_head.weight"] = sd[
        "text_decoder.transformer.wte.weight"]
    on_disk["text_decoder.transformer.h.0.attn.bias"] = torch.ones(
        1, 1, 64, 64)
    on_disk["text_decoder.transformer.h.0.attn.masked_bias"] = torch.tensor(
        -1e4)
    path = str(tmp_path_factory.mktemp("lavila") / "narrator.pt")
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in on_disk.items()}}, path)
    jm = layout._model()
    video = np.random.RandomState(6).standard_normal(
        (2, FRAMES, IMG, IMG, 3)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), video,
                     jnp.zeros((2, 6), jnp.int32))["params"]
    params = merge_into_params(params, jax_import(path), strict=True)
    return path, sd, jm, params, video


def test_released_layout_loads_strict_and_matches_jax(released):
    path, _, jm, params, video = released
    pm = _small_model()
    load_lavila_narrator(pm, path)
    want = params_from_jax(params)
    got = pm.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    tokens = np.array([[1, 4, 7, 2, 0, 0], [1, 9, 2, 0, 0, 0]], np.int32)
    ref = jm.apply({"params": params}, video, tokens)["logits"]
    with torch.no_grad():
        out = pm(torch.from_numpy(video), torch.from_numpy(tokens))["logits"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_import_refuses_a_file_that_misses_a_block(released):
    _, sd, _, _, _ = released
    cut = {k: v for k, v in sd.items()
           if not k.startswith("visual.blocks.1.")}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_lavila_narrator(_small_model(), cut)
    no_decoder = {k: v for k, v in sd.items()
                  if not k.startswith("text_decoder.transformer.h.")}
    with pytest.raises(ValueError, match="text_decoder.transformer.h."):
        import_lavila_narrator_pt(no_decoder)


@pytest.mark.parametrize("use_cache", [True, False], ids=["cached",
                                                          "uncached"])
def test_greedy_generate_is_token_equal(released, use_cache):
    path, _, jm, params, video = released
    pm = _small_model()
    load_lavila_narrator(pm, path)
    prompt = np.array([[3, 5], [1, 2]], np.int32)
    ref = np.asarray(jm.apply({"params": params}, video, prompt,
                              method=jm.generate, max_len=10, rng=None,
                              use_cache=use_cache))
    got = pm.generate(torch.from_numpy(video), torch.from_numpy(prompt),
                      max_len=10, use_cache=use_cache)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[:, :2].tolist() == prompt.tolist()


def test_sampling_cutoff_is_lavila_rule():
    """``sum(cum < top_p)`` keeps the token that crosses ``top_p``; the
    rest draw -1e30, never a token outside the set."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    g = torch.Generator().manual_seed(0)
    draws = {int(LavilaNarrator._sample(logits, g, 1.0, 0.7)[0])
             for _ in range(200)}
    assert draws == {0, 1}
    assert int(LavilaNarrator._sample(logits, None, 0.7, 0.95)[0]) == 0


def test_decay_mask_and_layer_ids_match_optax(tiny):
    jm, params, pm, _, _ = tiny
    mask = _leafwise(jax_factory.wd_mask(params), params)
    scales = _leafwise(jax_factory.layer_decay_scales(params, 3, 0.75),
                       params)
    named = dict(pm.named_parameters())
    assert named.keys() == mask.keys()
    for name, p in named.items():
        assert factory.wd_mask(name, p) == bool(mask[name]), name
        np.testing.assert_allclose(factory.layer_decay_scale(name, 3, 0.75),
                                   scales[name], err_msg=name)


class FakeTok:
    eos_token_id = 1

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids)


def test_lavila_captioner_matches_jax(released, tmp_path):
    from avion_tpu.tools.narrator import lavila_captioner as jax_captioner
    from avion_tpu_torch.tools.narrator import lavila_captioner

    path, _, jm, params, video = released
    frames = np.random.RandomState(7).randint(
        0, 256, (FRAMES, IMG, IMG, 3)).astype(np.uint8)
    kw = dict(tokenizer=FakeTok(), num_samples=2, max_len=6,
              temperature=1e-6)
    ref = jax_captioner(model=jm, params=params, **kw)(frames)
    got = lavila_captioner(path, model=_small_model(), **kw)(frames)
    assert got == ref and len(got) == 2
    assert all(isinstance(c, str) for c in got)


def test_default_tokenizer_needs_transformers(released, monkeypatch):
    from avion_tpu_torch.tools import narrator as tool

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tool.lavila_captioner(released[0], model=_small_model())
    with pytest.raises(ValueError, match="checkpoint"):
        tool.lavila_captioner()
