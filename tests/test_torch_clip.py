"""The port's CLIP towers against the flax CLIP on the same weights
(carried across with ``params_from_jax``) and the same inputs, on CPU.
f32 at 1e-4; bf16 compute at 3e-2 (the JAX bf16 forward tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.models.registry import create_model as jax_create_model
from avion_tpu_torch.eval.runners import cast_inference_params
from avion_tpu_torch.models.clip import CLIP
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.models.registry import create_model

# the geometry of the `served` fixture in tests/test_serve.py
SERVED = dict(embed_dim=32, image_size=32, patch_size=16, num_frames=4,
              vision_width=64, vision_layers=2, vision_heads=2,
              context_length=13, vocab_size=49408, text_width=32,
              text_heads=2, text_layers=2)


def _init(model, frames, seed=0):
    """flax init, then every leaf perturbed from a seeded numpy stream so
    biases, LayerNorm and the zero-init temporal table are all live."""
    video = jnp.zeros((1, frames, model.image_size, model.image_size, 3))
    text = jnp.zeros((1, model.context_length), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), video, text)["params"]
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32), params)


def _inputs(model, n, frames, seed=1):
    rs = np.random.RandomState(seed)
    video = rs.standard_normal(
        (n, frames, model.image_size, model.image_size, 3)).astype(np.float32)
    text = rs.randint(1, 49000, (n, model.context_length)).astype(np.int32)
    text[:, 0] = 49406
    text[np.arange(n), rs.randint(2, model.context_length, n)] = 49407
    return video, text


def _jax_embed(model, params, video, text):
    p = {"params": params}
    img = jax.jit(lambda p, v: model.apply(p, v, method=model.encode_image))(
        p, jnp.asarray(video))
    txt = jax.jit(lambda p, t: model.apply(p, t, method=model.encode_text))(
        p, jnp.asarray(text))
    return np.asarray(img, np.float32), np.asarray(txt, np.float32)


def _port_embed(model, video, text):
    with torch.inference_mode():
        img = model.encode_image(torch.from_numpy(video))
        txt = model.encode_text(torch.from_numpy(text).long())
    return img.numpy(), txt.numpy()


@pytest.mark.parametrize("quick_gelu", [True, False])
def test_served_geometry_matches_flax_f32(quick_gelu):
    jm = JaxCLIP(**SERVED, use_quick_gelu=quick_gelu, use_flash=False,
                 dtype=jnp.float32)
    params = _init(jm, 4)
    pm = CLIP(**SERVED, use_quick_gelu=quick_gelu, dtype=torch.float32)
    pm.load_state_dict(params_from_jax(params), strict=True)
    video, text = _inputs(jm, 3, 4)
    ji, jt = _jax_embed(jm, params, video, text)
    pi, pt = _port_embed(pm, video, text)
    np.testing.assert_allclose(pi, ji, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pt, jt, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pm.logit_scale.item(),
                               float(params["logit_scale"]), rtol=1e-6)


def test_fewer_frames_than_the_temporal_table():
    """A 2-frame clip through a 4-frame model reads temporal rows [:2]."""
    jm = JaxCLIP(**SERVED, use_flash=False, dtype=jnp.float32)
    params = _init(jm, 4, seed=3)
    pm = CLIP(**SERVED, dtype=torch.float32)
    pm.load_state_dict(params_from_jax(params), strict=True)
    video, text = _inputs(jm, 2, 2, seed=4)
    ji, _ = _jax_embed(jm, params, video, text)
    pi, _ = _port_embed(pm, video, text)
    np.testing.assert_allclose(pi, ji, atol=1e-4, rtol=1e-4)


def test_clip_tiny_bf16_matches_flax():
    jm = jax_create_model("CLIP_TINY", dtype=jnp.bfloat16)
    params = _init(jm, 2, seed=5)
    pm = create_model("CLIP_TINY", dtype=torch.bfloat16)
    pm.load_state_dict(params_from_jax(params), strict=True)
    cast_inference_params(pm)
    assert pm.visual.conv1.weight.dtype == torch.bfloat16
    assert pm.visual.positional_embedding.dtype == torch.float32
    assert pm.textual.token_embedding.weight.dtype == torch.float32
    assert pm.visual.ln_pre.weight.dtype == torch.float32
    video, text = _inputs(jm, 3, 2, seed=6)
    ji, jt = _jax_embed(jm, params, video, text)
    pi, pt = _port_embed(pm, video, text)
    assert pi.dtype == np.float32
    np.testing.assert_allclose(pi, ji, atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(pt, jt, atol=3e-2, rtol=3e-2)
