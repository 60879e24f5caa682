"""The port's VideoMAE training pieces on the CPU against the JAX package's:
the losses (values and gradients), one pretraining step and two finetune
steps with an EMA (mask and labels given), layer decay and the weight-decay
mask name by name, one update against optax, the mixup apply on JAX's own
draws, the device tube masks, and the skip of a non-finite step."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.data.transforms import tube_mask_batch
from avion_tpu.losses import losses as jl
from avion_tpu.optim import factory as jf
from avion_tpu.train import augment_device as jad
from avion_tpu.train import steps as jax_steps
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.data.transforms import tube_mask_device
from avion_tpu_torch.losses.losses import (soft_target_cross_entropy,
                                           videomae_loss)
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.optim.factory import build_optimizer, layer_decay_scale
from avion_tpu_torch.optim.factory import wd_mask as port_wd_mask
from avion_tpu_torch.train import augment_device as ad
from avion_tpu_torch.train.steps import (make_cls_train_step,
                                         make_videomae_train_step, step_seed)
from test_torch_videomae_model import finetune_pair, pretrain_pair

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_train_step.py's
OPT = dict(lr=1e-3, lr_start=1e-4, warmup_epochs=0.5, epochs=1, wd=0.05,
           grad_clip_norm=1.0, layer_decay=0.75)


def _uint8_video(seed, batch=4):
    return np.random.RandomState(seed).randint(0, 256, (batch, 4, 32, 32, 3),
                                               np.uint8)


def _by_name(tree, like):
    """A JAX tree of per-leaf values as the port's names -> tensors."""
    return params_from_jax(jax.tree_util.tree_map(
        lambda p, v: np.full(np.shape(p), v, np.float32), like, tree))


def _assert_params(model, jparams, **tol):
    want = params_from_jax(jax.device_get(jparams))
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


@pytest.fixture
def f32_prep(monkeypatch):
    """The JAX steps normalize uint8 clips into bf16 whatever the model's
    dtype; the f32 comparisons give them f32, as the port does for an f32
    model."""
    monkeypatch.setattr(jax_steps, "prep_video", functools.partial(
        jax_steps.prep_video, dtype=jnp.float32))


def test_videomae_loss_and_grad_match_jax():
    rs = np.random.RandomState(0)
    video = rs.randn(3, 4, 32, 32, 3).astype(np.float32)
    idx = np.stack([rs.permutation(8)[:4] for _ in range(3)])
    pred = rs.randn(3, 4, 1536).astype(np.float32)
    for norm in (True, False):
        def jloss(p):
            return jl.videomae_loss(p, jnp.asarray(video), jnp.asarray(idx),
                                    16, 2, norm)["loss"]

        jv, jg = jax.value_and_grad(jloss)(jnp.asarray(pred))
        p = torch.from_numpy(pred).requires_grad_()
        loss = videomae_loss(p, torch.from_numpy(video), torch.from_numpy(idx),
                             16, 2, norm)["loss"]
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-5)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg),
                                   rtol=5e-4, atol=5e-4)


def test_soft_target_cross_entropy_and_grad_match_jax():
    rs = np.random.RandomState(1)
    logits = rs.randn(6, 10).astype(np.float32) * 3
    targets = rs.dirichlet(np.ones(10), 6).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda x: jl.soft_target_cross_entropy(
        x, jnp.asarray(targets)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss = soft_target_cross_entropy(x, torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=5e-4,
                               atol=5e-4)


def test_videomae_step_matches_jax(f32_prep):
    jm, params, pm = pretrain_pair()
    rs = np.random.RandomState(3)
    batch = {"video": _uint8_video(2),
             "mask": tube_mask_batch(rs, 4, 2, 2, 2, 0.5)}
    tx, _ = jf.build_optimizer(JaxOptimConfig(**OPT), params, 4,
                               num_layers=2)
    jstate, jmetrics = jax.jit(jax_steps.make_videomae_train_step(jm, tx))(
        JaxTrainState.create(params, tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    opt, _ = build_optimizer(OptimConfig(**OPT), pm, 4, num_layers=2)
    state, metrics = make_videomae_train_step(pm)(
        TrainState.create(pm, opt),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 1 and metrics["step_ok"] == 1.0
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), **TOL)
    _assert_params(pm, jstate.params, **TOL)


def test_cls_steps_with_ema_match_jax(f32_prep):
    """Two steps: int labels with label smoothing, then soft targets."""
    jm, params, pm = finetune_pair(drop_path_rate=0.0)
    labels = np.array([0, 3, 1, 4], np.int32)
    soft = np.random.RandomState(4).dirichlet(np.ones(5), 4).astype(
        np.float32)
    batches = [{"video": _uint8_video(5), "label": labels},
               {"video": _uint8_video(6), "label": soft}]
    tx, _ = jf.build_optimizer(JaxOptimConfig(**OPT), params, 4,
                               num_layers=2)
    jstep = jax.jit(jax_steps.make_cls_train_step(
        jm, tx, label_smoothing=0.1, ema_decay=0.9))
    jstate = JaxTrainState.create(params, tx, use_ema=True)
    opt, _ = build_optimizer(OptimConfig(**OPT), pm, 4, num_layers=2)
    state = TrainState.create(pm, opt, use_ema=True)
    step = make_cls_train_step(pm, label_smoothing=0.1, ema_decay=0.9)
    for b in batches:
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in b.items()},
                                 jax.random.PRNGKey(0))
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        for key in ("loss", "acc1"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(jmetrics[key]), err_msg=key,
                                       **TOL)
    _assert_params(pm, jstate.params, **TOL)
    want = params_from_jax(jax.device_get(jstate.ema_params))
    for k, v in want.items():
        np.testing.assert_allclose(state.ema[k].numpy(), v.numpy(),
                                   err_msg=k, **TOL)
    assert not torch.equal(state.ema["head.weight"], pm.head.weight)


def test_non_finite_step_keeps_params_moments_count_and_ema():
    _, _, pm = finetune_pair(drop_path_rate=0.0)
    opt, _ = build_optimizer(OptimConfig(**OPT), pm, 4, num_layers=2)
    state = TrainState.create(pm, opt, use_ema=True)
    step = make_cls_train_step(pm, ema_decay=0.9)
    label = torch.tensor([0, 1, 2, 3])
    state, _ = step(state, {"video": torch.from_numpy(_uint8_video(7)),
                            "label": label})
    before = {k: v.clone() for k, v in state.state_dict()["model"].items()}
    ema = {k: v.clone() for k, v in state.ema.items()}
    moments = [s["exp_avg"].clone() for s in opt.inner.state.values()]
    bad = torch.full((4, 4, 32, 32, 3), float("nan"))
    state, metrics = step(state, {"video": bad, "label": label})
    assert metrics["step_ok"] == 0.0 and state.step == 2 and opt.count == 1
    for k, v in state.state_dict()["model"].items():
        assert torch.equal(v, before[k]), k
    for k, v in state.ema.items():
        assert torch.equal(v, ema[k]), k
    for m, s in zip(moments, opt.inner.state.values()):
        assert torch.equal(m, s["exp_avg"])


@pytest.mark.parametrize("pair", [pretrain_pair, finetune_pair],
                         ids=["pretrain", "finetune"])
def test_layer_decay_and_wd_mask_match_jax_name_by_name(pair):
    _, params, pm = pair()
    scales = _by_name(jf.layer_decay_scales(params, 2, 0.75), params)
    decays = _by_name(jf.wd_mask(params), params)
    named = dict(pm.named_parameters())
    assert scales.keys() == named.keys()
    for name, p in named.items():
        assert layer_decay_scale(name, 2, 0.75) == pytest.approx(
            scales[name].flatten()[0].item()), name
        assert port_wd_mask(name, p) == bool(decays[name].flatten()[0]), name
    assert layer_decay_scale("patch_embed.weight", 2, 0.75) == 0.75 ** 3
    assert layer_decay_scale("encoder.resblocks.1.mlp.fc1.weight", 2,
                             0.75) == 0.75


def test_one_layer_decayed_update_matches_optax():
    _, params, pm = finetune_pair()
    rs = np.random.RandomState(8)
    grads = jax.tree_util.tree_map(
        lambda p: rs.randn(*np.shape(p)).astype(np.float32), params)
    tx, _ = jf.build_optimizer(JaxOptimConfig(**OPT), params, 4,
                               num_layers=2)
    updates, _ = tx.update(grads, tx.init(params), params)
    jparams = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    opt, _ = build_optimizer(OptimConfig(**OPT), pm, 4, num_layers=2)
    for name, g in params_from_jax(grads).items():
        dict(pm.named_parameters())[name].grad = g
    opt.update()
    _assert_params(pm, jparams, rtol=1e-5, atol=1e-6)


def _jax_draws(key, b, h, w, mixup_alpha, cutmix_alpha, switch_prob, prob,
               mode, minmax):
    """The random part of ``avion_tpu.train.augment_device.mixup_cutmix``
    at its keys, broadcast per sample."""
    k_apply, k_switch, k_lam, k_box = jax.random.split(key, 4)
    n = b if mode in ("pair", "elem") else 1
    have = cutmix_alpha > 0 or minmax is not None
    use = jnp.logical_and(have,
                          jax.random.uniform(k_switch, (n,)) < switch_prob)
    if mixup_alpha > 0:
        lam = jad._beta(k_lam, mixup_alpha, (n,))
    else:
        lam = jnp.ones((n,), jnp.float32)
        use = jnp.broadcast_to(jnp.asarray(have), (n,))
    if minmax is None and cutmix_alpha > 0:
        lam_cut = jad._beta(jax.random.fold_in(k_lam, 2), cutmix_alpha, (n,))
    else:
        lam_cut = jnp.ones((n,), jnp.float32)
    apply = jax.random.uniform(k_apply, (n,)) < prob
    if mode == "pair":
        lam, lam_cut = jad._pair_mirror(lam), jad._pair_mirror(lam_cut)
        use, apply = jad._pair_mirror(use), jad._pair_mirror(apply)
    box, _ = jad._cut_boxes(k_box, jnp.broadcast_to(lam_cut, (b,)), minmax,
                            h, w)
    if mode == "pair":
        box = jad._pair_mirror(box)
    elif mode == "batch":
        box = jnp.broadcast_to(box[:1], box.shape)
    return [torch.from_numpy(np.array(jnp.broadcast_to(x, (b,) + x.shape[1:])))
            for x in (lam, box, use, apply)]


# JAX's pair mode cannot run: its _pair_mirror of the [B, H, W] boxes
# broadcasts a [B] condition against the last axis and raises (ROADMAP,
# gaps in the JAX package); the port's pair draws are held below
MIX_CASES = {
    "batch": dict(mode="batch"), "elem": dict(mode="elem", prob=0.6),
    "minmax": dict(mode="elem", cutmix_minmax=(0.2, 0.7)),
    "mixup_only": dict(mode="elem", cutmix_alpha=0.0),
    "cutmix_only": dict(mode="batch", mixup_alpha=0.0),
}
DRAW_CASES = dict(MIX_CASES, pair=dict(mode="pair"),
                  pair_cutmix_only=dict(mode="pair", mixup_alpha=0.0))


def test_jax_pair_mode_raises():
    with pytest.raises(ValueError, match="broadcast"):
        jad.mixup_cutmix(jax.random.PRNGKey(0), jnp.zeros((6, 2, 16, 24, 3)),
                         jnp.zeros(6, jnp.int32), 7, mode="pair")


@pytest.mark.parametrize("case", list(MIX_CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mixup_apply_matches_jax_on_its_draws(case, dtype):
    kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5, prob=1.0,
              mode="batch", cutmix_minmax=None)
    kw.update(MIX_CASES[case])
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rs = np.random.RandomState(9)
    video = rs.randn(6, 2, 16, 24, 3).astype(np.float32)
    labels = rs.randint(0, 7, 6).astype(np.int32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        jv, js = jad.mixup_cutmix(key, jnp.asarray(video, jdt),
                                  jnp.asarray(labels), 7, smoothing=0.1, **kw)
        draws = _jax_draws(key, 6, 16, 24, kw["mixup_alpha"],
                           kw["cutmix_alpha"], kw["switch_prob"], kw["prob"],
                           kw["mode"], kw["cutmix_minmax"])
        v, s = ad.apply_mix(torch.from_numpy(video).to(tdt),
                            torch.from_numpy(labels), 7, 0.1, *draws)
        np.testing.assert_allclose(v.float().numpy(),
                                   np.asarray(jv, np.float32), rtol=0,
                                   atol=0 if dtype == "f32" else 1e-2)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", list(DRAW_CASES))
def test_mixup_draws_follow_the_mode(case):
    kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5, prob=1.0)
    kw.update(DRAW_CASES[case])
    gen = torch.Generator().manual_seed(0)
    lam, box, use, apply = ad.draw_mix(gen, 6, 16, 24, **kw)
    assert lam.shape == use.shape == apply.shape == (6,)
    assert box.shape == (6, 16, 24) and box.dtype == torch.bool
    assert ((lam > 0) & (lam <= 1)).all()
    if kw["mode"] == "batch":
        assert (box == box[:1]).all() and (lam == lam[0]).all()
    if kw["mode"] == "pair":
        for x in (lam, box, use, apply):
            assert torch.equal(x, x.flip(0))
    v, s = ad.mixup_cutmix(torch.Generator().manual_seed(0),
                           torch.randn(6, 2, 16, 24, 3),
                           torch.arange(6) % 5, 5, **kw)
    torch.testing.assert_close(s.sum(-1), torch.ones(6))


def test_tube_mask_device_counts_tiles_and_follows_the_seed():
    def draw(seed):
        return tube_mask_device(torch.Generator().manual_seed(seed), 5, 8,
                                14, 14, 0.9)

    m = draw(0)
    assert m.shape == (5, 8 * 196) and m.dtype == torch.bool
    frames = m.view(5, 8, 196)
    assert (frames.sum(-1) == int(0.9 * 196)).all()
    assert (frames == frames[:, :1]).all()
    assert torch.equal(draw(0), m) and not torch.equal(draw(1), m)


@pytest.mark.parametrize("regen", [False, True])
def test_echoed_batch_draws_new_masks_only_with_regen_mask(regen):
    """The step's masks: the batch's own, or with ``regen_mask`` drawn from
    (seed, step), so the two repeats of an echoed batch differ."""
    _, _, pm = pretrain_pair()
    seen = []
    pm.register_forward_pre_hook(lambda m, args: seen.append(args[1].clone()))
    opt, _ = build_optimizer(OptimConfig(**OPT), pm, 4)
    state = TrainState.create(pm, opt)
    mask = torch.from_numpy(tube_mask_batch(np.random.RandomState(0), 4, 2,
                                            2, 2, 0.5))
    batch = {"video": torch.from_numpy(_uint8_video(1)), "mask": mask}
    step = make_videomae_train_step(pm, regen_mask=regen)
    for _ in range(2):
        state, metrics = step(state, batch)
        assert metrics["step_ok"] == 1.0
    if not regen:
        assert torch.equal(seen[0], mask) and torch.equal(seen[1], mask)
        return
    assert not torch.equal(seen[0], seen[1])
    for k, m in enumerate(seen):
        want = tube_mask_device(torch.Generator().manual_seed(
            step_seed(1, k)), 4, 2, 2, 2, 0.5)
        assert torch.equal(m, want)
        assert (m.view(4, 2, 4).sum(-1) == 2).all()
