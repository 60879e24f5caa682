"""The contrastive-extras slice's model pieces against the JAX package's on
the CPU, f32, inputs from numpy seeds: SigLIP's loss (dense and chunked,
which on one process is the dense loss) at 1e-6 with the gradients of the
embeddings, the scale and the bias at 2e-5; the ViT-L/14 registry entries'
parameter counts (``jax.eval_shape``, nothing materialised); a ViT-L-width
CLIP cut to 2 layers and 1 frame, LayerScale in a directly built visual
tower (also under remat) and SigLIP's ``logit_bias``, each carried across
by ``params_from_jax``, at the f32 tolerance of
``tests/test_torch_clip.py``; ``import_clip_pt`` on ViT-L's OpenAI layout
against the JAX importer; and the ``logit_bias`` that the JAX package's
``export_clip_to_pt`` drops while the port's checkpoints keep it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.losses.losses import siglip_loss as jax_siglip
from avion_tpu.losses.losses import siglip_loss_chunked as jax_siglip_chunked
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.models.pt_import import import_clip_pt as jax_import_clip_pt
from avion_tpu.models.registry import create_model as jax_create_model
from avion_tpu.models.vit import VisionTransformer as JaxViT
from avion_tpu.tools.convert_checkpoint import export_clip_to_pt
from avion_tpu_torch.core.checkpoint import Checkpointer
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.losses.losses import siglip_loss, siglip_loss_chunked
from avion_tpu_torch.models.clip import CLIP
from avion_tpu_torch.models.pt_import import import_clip_pt, params_from_jax
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.models.vit import VisionTransformer
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.train.common import load_pretrained_params

TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_torch_clip.py's f32 bound
SIGLIP = {"dense": (siglip_loss, jax_siglip),
          "chunked": (siglip_loss_chunked, jax_siglip_chunked)}
# ViT-L/14's widths (avion_tpu/models/registry.py:119-136), cut to 2
# layers a tower; heads of dim 64, as the registry sets them from the width
VITL_2 = dict(embed_dim=768, image_size=224, patch_size=14, num_frames=1,
              vision_width=1024, vision_layers=2, vision_heads=16,
              context_length=77, text_width=768, text_heads=12,
              text_layers=2)


def _perturbed(params, seed, scale=0.05):
    """Noise on the leaves that flax initialises to constants (LayerNorm,
    biases, LayerScale; the matrices are random already)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + (
            scale * rs.standard_normal(np.shape(x)).astype(np.float32)
            if np.ndim(x) <= 1 else 0.0), params)


def _unit(rs, n, d):
    x = rs.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("kind", list(SIGLIP))
def test_siglip_loss_matches_jax(kind):
    port_fn, jax_fn = SIGLIP[kind]
    rs = np.random.RandomState(3)
    img, txt = _unit(rs, 6, 8), _unit(rs, 6, 8)
    txt[1] = img[1]  # one pair the model already gets right
    scale, bias = np.float32(7.5), np.float32(-2.5)

    def jloss(i, t, s, b):
        return jax_fn(i, t, s, b)["loss"]

    ref = jax_fn(img, txt, scale, bias)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(img, txt, scale, bias)
    args = [torch.tensor(a, requires_grad=True)
            for a in (img, txt, scale, bias)]
    got = port_fn(*args)
    got["loss"].backward()
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]),
                               rtol=1e-6, atol=1e-6)
    assert got["clip_acc"].item() == float(ref["clip_acc"])
    for name, a, g in zip(("image", "text", "scale", "bias"), args, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("name", ["CLIP_VITL14", "CLIP_VITL14_H128",
                                  "CLIP_VITL14_336PX"])
def test_vitl_entries_have_the_jax_parameter_counts(name):
    jm = jax_create_model(name, num_frames=4, use_flash_attn=False,
                          dtype=jnp.float32)
    size = jm.image_size
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 4, size, size, 3), jnp.float32),
        jax.ShapeDtypeStruct((1, 77), jnp.int32))["params"]
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        shapes))
    with torch.device("meta"):
        model = create_model(name, num_frames=4)
    assert sum(p.numel() for p in model.parameters()) == want
    # the heads the kernels get: dim 64, or 128 for the _H128 twin
    attn = model.visual.transformer.resblocks[0].attn
    assert attn.Wqkv.in_features // attn.heads == (128 if "H128" in name
                                                   else 64)
    assert model.visual.positional_embedding.shape[0] - 1 == \
        (size // 14) ** 2


def test_vitl_width_clip_matches_jax():
    jm = JaxCLIP(**VITL_2, use_flash=False, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 1, 224, 224, 3)),
                              jnp.zeros((1, 77), jnp.int32))["params"]
    params = _perturbed(params, 1, scale=0.01)
    rs = np.random.RandomState(2)
    video = rs.standard_normal((2, 1, 224, 224, 3)).astype(np.float32)
    text = rs.randint(1, 49000, (2, 77)).astype(np.int32)
    text[:, 9] = 49407
    ref = jax.jit(jm.apply)({"params": params}, video, text)
    model = CLIP(**VITL_2, dtype=torch.float32)
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(video), torch.from_numpy(text).long())
    for key in ("image_embed", "text_embed"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **TOL)


def test_layerscale_matches_jax_and_recomputes_under_remat():
    kw = dict(image_size=32, patch_size=16, num_frames=2, width=64,
              layers=2, heads=2)
    jm = JaxViT(**kw, output_dim=None, ls_init_value=0.1, use_flash=False,
                dtype=jnp.float32)
    video = np.random.RandomState(4).standard_normal(
        (3, 2, 32, 32, 3)).astype(np.float32)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                         video)["params"], 5)
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, video))
    sd = {k[len("visual."):]: v
          for k, v in params_from_jax({"visual": params}).items()}
    assert sum(k.endswith(("ls_1.gamma", "ls_2.gamma")) for k in sd) == 4
    outs, grads = [], []
    for remat in (False, True):
        vit = VisionTransformer(**kw, dtype=torch.float32, remat=remat,
                                ls_init_value=0.1)
        vit.load_state_dict(sd, strict=True)
        out = vit(torch.from_numpy(video))
        out.square().sum().backward()
        outs.append(out.detach().numpy())
        grads.append({n: p.grad for n, p in vit.named_parameters()})
    np.testing.assert_allclose(outs[0], ref, **TOL)
    np.testing.assert_array_equal(outs[1], outs[0])
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-6, atol=1e-7)
    fresh = VisionTransformer(**kw, dtype=torch.float32, ls_init_value=0.1)
    assert torch.equal(fresh.transformer.resblocks[1].ls_2.gamma,
                       torch.full((64,), 0.1))


def _siglip_pair(bias: float):
    """A tiny JAX CLIP with the SigLIP head, its bias set to ``bias``."""
    kw = dict(embed_dim=16, image_size=32, patch_size=16, num_frames=2,
              vision_width=32, vision_layers=1, vision_heads=2,
              context_length=8, vocab_size=64, text_width=16, text_heads=2,
              text_layers=1)
    jm = JaxCLIP(**kw, use_flash=False, dtype=jnp.float32,
                 use_logit_bias=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 2, 32, 32, 3)),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    assert float(params["logit_bias"]) == -10.0
    params["logit_bias"] = np.float32(bias)
    return kw, params


def test_logit_bias_through_params_from_jax():
    kw, params = _siglip_pair(-3.25)
    model = CLIP(**kw, dtype=torch.float32, use_logit_bias=True)
    model.load_state_dict(params_from_jax(params), strict=True)
    video = torch.zeros(1, 2, 32, 32, 3)
    out = model(video, torch.zeros(1, 8, dtype=torch.long))
    assert out["logit_bias"].item() == -3.25
    fresh = CLIP(**kw, dtype=torch.float32, use_logit_bias=True).init_weights(
        torch.Generator().manual_seed(0))
    assert fresh.logit_bias.item() == -10.0
    with pytest.raises(KeyError, match="unknown parameter"):
        params_from_jax({**params, "logit_gate": np.float32(1.0)})


def test_export_drops_logit_bias_and_the_port_keeps_it(tmp_path):
    """The JAX package's ``export_clip_to_pt`` writes ``logit_scale`` and no
    ``logit_bias``, so a SigLIP model comes back from its ``.pt`` with the
    bias at its initial -10.  The port's checkpoint directory keeps the
    bias, and ``import_clip_pt`` carries it from a ``.pt`` that has it."""
    kw, params = _siglip_pair(-3.25)
    exported = str(tmp_path / "jax_export.pt")
    export_clip_to_pt(params, exported)
    assert "logit_bias" not in torch.load(exported,
                                          weights_only=False)["state_dict"]

    def fresh():
        return CLIP(**kw, dtype=torch.float32, use_logit_bias=True
                    ).init_weights(torch.Generator().manual_seed(7))

    lost = load_pretrained_params(exported, fresh(), num_frames=2,
                                  context_length=8, vocab_size=64)
    assert lost.logit_bias.item() == -10.0

    model = fresh()
    model.load_state_dict(params_from_jax(params), strict=True)
    opt, _ = build_optimizer(OptimConfig(), model, 4)
    Checkpointer(str(tmp_path / "ckpt")).save(3, TrainState(3, model, opt))
    kept = load_pretrained_params(str(tmp_path), fresh())
    assert kept.logit_bias.item() == -3.25
    port_pt = str(tmp_path / "port.pt")
    torch.save({"state_dict": model.state_dict()}, port_pt)
    assert import_clip_pt(port_pt, num_frames=2, context_length=8,
                          vocab_size=64)["logit_bias"].item() == -3.25


def _openai_vitl_state(rs, blocks=2, vocab=1000):
    """OpenAI's ViT-L/14 layout (``in_proj``, ``c_fc`` / ``c_proj``, the
    text tower at the top level, ``visual.proj``), ``blocks`` blocks a
    tower and a ``vocab``-row token table, plus a ``logit_bias``."""
    def t(*shape):
        return torch.from_numpy(
            (0.02 * rs.standard_normal(shape)).astype(np.float32))

    def block(pre, w):
        return {f"{pre}.ln_1.weight": t(w), f"{pre}.ln_1.bias": t(w),
                f"{pre}.attn.in_proj_weight": t(3 * w, w),
                f"{pre}.attn.in_proj_bias": t(3 * w),
                f"{pre}.attn.out_proj.weight": t(w, w),
                f"{pre}.attn.out_proj.bias": t(w),
                f"{pre}.ln_2.weight": t(w), f"{pre}.ln_2.bias": t(w),
                f"{pre}.mlp.c_fc.weight": t(4 * w, w),
                f"{pre}.mlp.c_fc.bias": t(4 * w),
                f"{pre}.mlp.c_proj.weight": t(w, 4 * w),
                f"{pre}.mlp.c_proj.bias": t(w)}

    sd = {"visual.conv1.weight": t(1024, 3, 14, 14),
          "visual.class_embedding": t(1024),
          "visual.positional_embedding": t(257, 1024),
          "visual.ln_pre.weight": t(1024), "visual.ln_pre.bias": t(1024),
          "visual.ln_post.weight": t(1024), "visual.ln_post.bias": t(1024),
          "visual.proj": t(1024, 768), "token_embedding.weight": t(vocab, 768),
          "positional_embedding": t(77, 768), "ln_final.weight": t(768),
          "ln_final.bias": t(768), "text_projection": t(768, 768),
          "logit_scale": torch.tensor(4.6), "logit_bias": torch.tensor(-6.5)}
    for i in range(blocks):
        sd.update(block(f"visual.transformer.resblocks.{i}", 1024))
        sd.update(block(f"transformer.resblocks.{i}", 768))
    return sd


def test_import_clip_pt_reads_the_vitl_openai_layout():
    state = _openai_vitl_state(np.random.RandomState(6))
    geometry = dict(num_frames=4, context_length=77, vocab_size=1000)
    got = import_clip_pt(state, **geometry)
    want = params_from_jax(jax_import_clip_pt(
        {k: v.numpy() for k, v in state.items() if k != "logit_bias"},
        **geometry))
    assert set(got) == set(want) | {"logit_bias"}
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert got["logit_bias"].item() == -6.5
    model = CLIP(**dict(VITL_2, num_frames=4), vocab_size=1000,
                 dtype=torch.float32, use_logit_bias=True)
    missing, unexpected = model.load_state_dict(got, strict=False)
    assert missing == ["visual.temporal_embedding"] and not unexpected
