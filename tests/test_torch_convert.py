"""Weights between the two packages: ``params_from_jax`` against the file
``export_clip_to_pt`` writes, and the port's ``.pt`` loader against
``avion_tpu.models.pt_import.import_clip_pt`` on the layouts it reads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.models.pt_import import import_clip_pt as jax_import_clip_pt
from avion_tpu.tools.convert_checkpoint import export_clip_to_pt
from avion_tpu_torch.models.clip import CLIP
from avion_tpu_torch.models.pt_import import (import_clip_pt,
                                              load_clip_checkpoint,
                                              params_from_jax)

GEOM = dict(embed_dim=32, image_size=32, patch_size=16, vision_width=64,
            vision_layers=2, vision_heads=2, text_width=32, text_heads=2,
            text_layers=2)


@pytest.fixture(scope="module")
def flax_params():
    model = JaxCLIP(**GEOM, num_frames=4, context_length=13, vocab_size=600,
                    use_flash=False, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 4, 32, 32, 3)),
                                 jnp.zeros((1, 13), jnp.int32))["params"]
    rs = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32), params)


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert tuple(a[k].shape) == tuple(b[k].shape), k
        np.testing.assert_allclose(np.asarray(a[k], np.float32),
                                   np.asarray(b[k], np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_params_from_jax_equals_export_and_loads_strict(flax_params,
                                                        tmp_path):
    path = str(tmp_path / "clip.pt")
    export_clip_to_pt(flax_params, path)
    exported = torch.load(path, map_location="cpu")["state_dict"]
    _assert_same(params_from_jax(flax_params), exported)
    model = CLIP(**GEOM, num_frames=4, context_length=13, vocab_size=600,
                 dtype=torch.float32)
    model.load_state_dict(exported, strict=True)
    load_clip_checkpoint(model, path)
    _assert_same(model.state_dict(), exported)


@pytest.mark.parametrize("num_frames,context_length,vocab_size", [
    (8, 13, 600),    # temporal embedding inflated 4 -> 8
    (3, 13, 600),    # ... and deflated 4 -> 3
    (4, 20, 700),    # context and vocab padded
    (4, 9, 500),     # context and vocab truncated
])
def test_pt_loader_matches_jax_import(flax_params, tmp_path, num_frames,
                                      context_length, vocab_size):
    path = str(tmp_path / "clip.pt")
    export_clip_to_pt(flax_params, path)
    ref = params_from_jax(jax_import_clip_pt(
        path, num_frames=num_frames, context_length=context_length,
        vocab_size=vocab_size))
    got = import_clip_pt(path, num_frames=num_frames,
                         context_length=context_length, vocab_size=vocab_size)
    _assert_same(got, ref)
    model = CLIP(**GEOM, num_frames=num_frames, context_length=context_length,
                 vocab_size=vocab_size, dtype=torch.float32)
    model.load_state_dict(got, strict=True)


def _reference_variant(sd, openai):
    """Rewrite an exported state dict into the unfused ``in_proj`` layout
    (and, with ``openai``, OpenAI CLIP's top-level text tower with
    ``c_fc`` / ``c_proj`` names and a flattened conv1)."""
    out = {}
    for k, v in sd.items():
        k = k.replace("attn.Wqkv.weight", "attn.in_proj_weight")
        k = k.replace("attn.Wqkv.bias", "attn.in_proj_bias")
        if openai:
            k = k.replace("mlp.fc1.", "mlp.c_fc.").replace("mlp.fc2.",
                                                           "mlp.c_proj.")
            if k.startswith("textual."):
                k = k[len("textual."):]
            if k == "visual.conv1.weight":
                v = v.reshape(v.shape[0], -1)
            if k == "image_projection":
                k = "visual.proj"
        out["module." + k] = v
    return out


@pytest.mark.parametrize("openai", [False, True])
def test_pt_loader_reads_reference_layouts(flax_params, tmp_path, openai):
    path = str(tmp_path / "clip.pt")
    export_clip_to_pt(flax_params, path)
    sd = torch.load(path, map_location="cpu")["state_dict"]
    variant = str(tmp_path / "variant.pt")
    torch.save({"state_dict": _reference_variant(sd, openai)}, variant)
    ref = params_from_jax(jax_import_clip_pt(variant, num_frames=4,
                                             context_length=13,
                                             vocab_size=600))
    got = import_clip_pt(variant, num_frames=4, context_length=13,
                         vocab_size=600)
    _assert_same(got, ref)
    _assert_same(got, sd)
