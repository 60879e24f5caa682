"""The finetune slice's models and step against the JAX package's on the
CPU, f32, on the same weights (carried across with ``params_from_jax``) and
the same seeded inputs: the visual tower's pooling (``cls``, ``gap``,
``none``) and a CLIP that pools ``gap`` or ``none`` at 2e-5;
``VideoClassifier``'s logits at 2e-5, and its DropPath and dropout; ``extract_visual_params`` and the classifier's load of a
reference-layout ``.pt``, with the raises on a file without a visual block
and on a directory that holds no checkpoint of the port; one
``make_mir_finetune_step`` (loss at 1e-5, the update's gradients at 5e-4
through SGD), and its draws following (seed, step)."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.models.clip import VideoClassifier as JaxVideoClassifier
from avion_tpu.models.layers import quick_gelu as jax_quick_gelu
from avion_tpu.models.pt_import import import_clip_pt as jax_import_clip_pt
from avion_tpu.models.vit import VisionTransformer as JaxVisionTransformer
from avion_tpu.optim.factory import build_optimizer as jax_build_optimizer
from avion_tpu.train.common import \
    extract_visual_params as jax_extract_visual_params
from avion_tpu.train.steps import make_mir_finetune_step as jax_mir_step
from avion_tpu_torch.core.config import OptimConfig, TrainConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.models.clip import CLIP, VideoClassifier
from avion_tpu_torch.models.layers import quick_gelu
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.models.vit import VisionTransformer
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.train.common import extract_visual_params
from avion_tpu_torch.train.finetune_cls import (build_classifier,
                                                load_visual_tower)
from avion_tpu_torch.train.steps import make_mir_finetune_step

TOWER = dict(image_size=32, patch_size=16, num_frames=4, width=64, layers=2,
             heads=2)
SERVED = dict(embed_dim=32, image_size=32, patch_size=16, num_frames=4,
              vision_width=64, vision_layers=2, vision_heads=2,
              context_length=13, vocab_size=49408, text_width=32,
              text_heads=2, text_layers=2)
FWD_TOL = dict(rtol=2e-5, atol=2e-5)


def _perturbed(params, seed=0):
    """Every leaf moved from a seeded numpy stream, so that biases,
    LayerNorm and the zero-init temporal table are all live."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32), params)


def _video(n, frames=4, seed=1):
    return np.random.RandomState(seed).standard_normal(
        (n, frames, 32, 32, 3)).astype(np.float32)


def _jax_tower(pooling):
    return JaxVisionTransformer(**TOWER, output_dim=None,
                                act=jax_quick_gelu, dtype=jnp.float32,
                                use_flash=False, pooling=pooling)


def _port_tower(pooling):
    return VisionTransformer(**TOWER, act=quick_gelu, dtype=torch.float32,
                             pooling=pooling)


@pytest.mark.parametrize("pooling", ["cls", "gap", "none"])
def test_tower_pooling_matches_jax(pooling):
    jm = _jax_tower(pooling)
    video = _video(3)
    params = _perturbed(jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 4, 32, 32, 3)))["params"])
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(video)))
    tower = _port_tower(pooling)
    sd = params_from_jax({"visual": params})
    tower.load_state_dict(extract_visual_params(sd), strict=True)
    with torch.no_grad():
        got = tower(torch.from_numpy(video)).numpy()
    assert got.shape == ref.shape == ((3, 17, 64) if pooling == "none"
                                      else (3, 64))
    np.testing.assert_allclose(got, ref, **FWD_TOL)


@pytest.mark.parametrize("pooling", ["gap", "none"])
def test_clip_pooling_matches_jax(pooling):
    """``none`` gives the normalized tokens without the projection, which
    the flax tower then never creates."""
    jm = JaxCLIP(**SERVED, pooling=pooling, use_flash=False,
                 dtype=jnp.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 4, 32, 32, 3)),
                                jnp.zeros((1, 13), jnp.int32))["params"])
    video = _video(3)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(video),
                              method=jm.encode_image))
    model = CLIP(**SERVED, dtype=torch.float32, pooling=pooling)
    missing = model.load_state_dict(params_from_jax(params),
                                    strict=False).missing_keys
    assert missing == ([] if pooling == "gap" else ["image_projection"])
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(video)).numpy()
    assert got.shape == ((3, 32) if pooling == "gap" else (3, 17, 64))
    np.testing.assert_allclose(got, ref, **FWD_TOL)


def _jax_classifier(dropout=0.3):
    jm = JaxVideoClassifier(_jax_tower("cls"), num_classes=5,
                            dropout=dropout)
    params = _perturbed(jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 4, 32, 32, 3)))["params"])
    return jm, params


def _port_classifier(dropout=0.3):
    return VideoClassifier(_port_tower("cls"), num_classes=5,
                           dropout=dropout)


def test_video_classifier_matches_jax():
    jm, params = _jax_classifier()
    video = _video(4)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(video)))
    model = _port_classifier()
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(video))
        # dropout only when training, from the forward's generator
        gen = torch.Generator().manual_seed(0)
        train = model(torch.from_numpy(video), deterministic=False,
                      generator=gen)
    assert got.dtype == torch.float32 and got.shape == (4, 5)
    np.testing.assert_allclose(got.numpy(), ref, **FWD_TOL)
    assert not torch.allclose(train, got)


def test_classifier_drop_path_follows_the_config_and_the_generator():
    """``model.drop_path_rate`` reaches the tower (the JAX entry's
    ``build_classifier`` passes it): training forwards draw their masks
    from the generator, the same seed gives the same logits, remat
    included, and the deterministic forward has none."""
    cfg = TrainConfig().apply_overrides(
        ["model.image_size=32", "model.vision_width=64",
         "model.vision_layers=2", "model.vision_heads=2",
         "data.clip_length=4", "model.drop_path_rate=0.5",
         "model.use_grad_checkpointing=true"])
    model = build_classifier(cfg, 5, torch.float32).to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    assert model.visual.transformer.drop_rates == [0.0, 0.5]
    video = torch.from_numpy(_video(8))

    def train(seed):
        return model(video, deterministic=False,
                     generator=torch.Generator().manual_seed(seed))

    a, b = train(1), train(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    a.sum().backward()  # through remat, with the same masks
    assert model.visual.conv1.weight.grad is not None
    assert not torch.allclose(train(1), train(2))
    with torch.no_grad():
        torch.testing.assert_close(model(video), model(video), rtol=0,
                                   atol=0)


def test_classifier_init_and_build():
    cfg = TrainConfig().apply_overrides(
        ["model.image_size=32", "model.vision_width=64",
         "model.vision_layers=2", "model.vision_heads=2",
         "data.clip_length=4", "model.classifier_dropout=0.5"])
    model = build_classifier(cfg, 7, torch.float32).to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    w = model.fc_cls.weight
    assert w.shape == (7, 64) and w.abs().max() <= 0.04
    assert abs(w.std().item() - 0.0176) < 0.004  # 0.02 cut at 2 std
    assert torch.count_nonzero(model.fc_cls.bias) == 0
    assert model.dropout == 0.5 and model.dtype == torch.float32
    again = build_classifier(cfg, 7, torch.float32).to_empty(device="cpu")
    again.init_weights(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))


@pytest.fixture(scope="module")
def clip_pt(tmp_path_factory):
    """A flax CLIP's weights in the reference layout at 2 frames (what
    ``export_clip_to_pt`` writes), and the flax tree."""
    jm = JaxCLIP(**dict(SERVED, num_frames=2), use_flash=False,
                 dtype=jnp.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(3),
                                jnp.zeros((1, 2, 32, 32, 3)),
                                jnp.zeros((1, 13), jnp.int32))["params"])
    path = str(tmp_path_factory.mktemp("pt") / "clip.pt")
    torch.save({"state_dict": params_from_jax(params)}, path)
    return path, params


def test_extract_visual_params_matches_jax(clip_pt):
    _, params = clip_pt
    ref = params_from_jax({"vision": jax_extract_visual_params(params)})
    got = extract_visual_params(params_from_jax(params))
    assert set(got) == {k[len("visual."):] for k in ref}
    assert not any("projection" in k or "proj" == k for k in got)
    for k, v in got.items():
        assert torch.equal(v, ref["visual." + k]), k


def test_classifier_loads_the_visual_tower_of_a_pt(clip_pt):
    """The port's classifier takes the tower of a 2-frame file inflated to
    4 frames, as the JAX entry's ``import_clip_pt`` and
    ``extract_visual_params`` give it; ``fc_cls`` keeps its init."""
    path, _ = clip_pt
    ref = params_from_jax({"vision": jax_extract_visual_params(
        jax_import_clip_pt(path, num_frames=4))})
    model = _port_classifier()
    model.init_weights(torch.Generator().manual_seed(0))
    fc = model.fc_cls.weight.detach().clone()
    load_visual_tower(model, path, num_frames=4)
    got = model.visual.state_dict()
    assert set(got) == {k[len("visual."):] for k in ref}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref["visual." + k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert got["temporal_embedding"].shape == (4, 64)
    assert torch.equal(model.fc_cls.weight, fc)


def test_classifier_load_raises_without_a_visual_block(clip_pt, tmp_path):
    path, _ = clip_pt
    sd = torch.load(path, weights_only=True)["state_dict"]
    text_only = str(tmp_path / "text_only.pt")
    torch.save({k: v for k, v in sd.items() if not k.startswith("visual.")},
               text_only)
    videomae = str(tmp_path / "videomae.pt")
    torch.save({"blocks.0.norm1.weight": torch.ones(4)}, videomae)
    model = _port_classifier()
    with pytest.raises(ValueError, match="no CLIP visual block"):
        load_visual_tower(model, text_only, num_frames=4)
    with pytest.raises(ValueError, match="VideoMAE finetune layout"):
        load_visual_tower(model, videomae, num_frames=4)
    os.makedirs(tmp_path / "orbax" / "3")
    with pytest.raises(ValueError, match="export_clip_to_pt"):
        load_visual_tower(model, str(tmp_path / "orbax"), num_frames=4)


OPT = dict(optimizer="sgd", lr=0.1, warmup_epochs=0.0, epochs=1, wd=0.05,
           momentum=0.9)


def _mir_batch(n=6, seed=1):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, 49000, (n, 13)).astype(np.int32)
    text[np.arange(n), rs.randint(2, 13, n)] = 49407
    return {"video": _video(n, seed=seed), "text": text}


@pytest.fixture(scope="module")
def mir_setup():
    """The flax CLIP's weights, and one JAX MIR step from them on
    ``_mir_batch()``: its metrics and its parameters after."""
    jm = JaxCLIP(**SERVED, use_flash=False, dtype=jnp.float32)
    params = _perturbed(jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 4, 32, 32, 3)),
                                jnp.zeros((1, 13), jnp.int32))["params"])
    tx, _ = jax_build_optimizer(JaxOptimConfig(**OPT), params, 4)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  tx)
    jstate, jmetrics = jax.jit(jax_mir_step(jm, tx))(
        jstate, {k: jnp.asarray(v) for k, v in _mir_batch().items()},
        jax.random.PRNGKey(0))
    return params, jmetrics, params_from_jax(jax.device_get(jstate.params))


def _port_mir(params, seed=1, **kwargs):
    model = CLIP(**SERVED, dtype=torch.float32, **kwargs)
    model.load_state_dict(params_from_jax(params), strict=True)
    opt, _ = build_optimizer(OptimConfig(**OPT), model, 4)
    return TrainState.create(model, opt), make_mir_finetune_step(model,
                                                                 seed=seed)


@pytest.mark.parametrize("remat", [False, True])
def test_mir_step_matches_jax(mir_setup, remat):
    """SGD's first update is ``p - lr (g + wd p)`` on the decayed
    parameters and ``p - lr g`` on the rest: the gradient each side used
    is read back from it."""
    params, jmetrics, ref = mir_setup
    batch = _mir_batch()
    state, step = _port_mir(params, remat=remat)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert metrics["step_ok"] == 1.0 and state.step == 1
    for key in ("loss", "max_margin_loss"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    got = state.model.state_dict()
    assert set(ref) == set(got)
    lr = OPT["lr"]
    for k in got:
        np.testing.assert_allclose(
            ((before[k] - got[k]) / lr).numpy(),
            ((before[k] - ref[k]) / lr).numpy(), rtol=5e-4, atol=5e-4,
            err_msg=k)
    # no clamp: logit_scale takes no gradient from this loss and stays
    assert math.isclose(got["logit_scale"].item(),
                        before["logit_scale"].item())


def test_mir_step_draws_follow_seed_and_step(mir_setup):
    """Patch dropout draws from (seed, step): two states from the same
    weights take the same step bit for bit; another seed draws another
    mask."""
    params = mir_setup[0]
    batch = {k: torch.from_numpy(v) for k, v in _mir_batch().items()}
    losses = []
    for seed in (1, 1, 2):
        state, step = _port_mir(params, seed=seed, patch_dropout=0.5)
        state.step = 5
        state, metrics = step(state, batch)
        losses.append((float(metrics["loss"]), state.model.state_dict()))
    (l1, sd1), (l2, sd2), (l3, _) = losses
    assert l1 == l2 and all(torch.equal(sd1[k], sd2[k]) for k in sd1)
    assert l3 != l1
