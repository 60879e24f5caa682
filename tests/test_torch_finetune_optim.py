"""The finetune slice's loss and optimizers against the JAX package's on
the CPU, f32: ``max_margin_ranking_loss`` at 1e-6, and SGD, Lion and AdamW
with a scheduled weight decay (``wd_end``), each with gradient clipping and
layer decay, over five updates against the optax chain of
``build_optimizer`` at 1e-6 (relative, and absolute on parameters of unit
scale: torch's AdamW decays the parameter before it subtracts the Adam
step, optax adds the decay to the step, which rounds differently where a
parameter has crossed zero); then each optimizer's state through a save
and a restore."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.losses.losses import \
    max_margin_ranking_loss as jax_max_margin
from avion_tpu.optim.factory import build_optimizer as jax_build_optimizer
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.losses.losses import max_margin_ranking_loss
from avion_tpu_torch.optim.factory import (Optimizer, build_schedule,
                                           build_wd_schedule)

NITER = 4  # 8 updates in the 2 epochs; the five steps stop inside them
LAYERS = 2
COMMON = dict(lr_start=1e-4, warmup_epochs=0.5, epochs=2, grad_clip_norm=1.0,
              layer_decay=0.75)
CASES = {
    "sgd": dict(optimizer="sgd", lr=0.05, lr_end=1e-3, wd=0.01,
                momentum=0.9),
    "sgd_wd_end": dict(optimizer="sgd", lr=0.05, lr_end=1e-3, wd=0.01,
                       wd_end=0.1, momentum=0.9),
    "lion": dict(optimizer="lion", lr=1e-3, lr_end=1e-5, wd=0.5,
                 betas=(0.9, 0.99)),
    "lion_wd_end": dict(optimizer="lion", lr=1e-3, lr_end=1e-5, wd=0.5,
                        wd_end=0.05, betas=(0.9, 0.99)),
    "adamw_wd_end": dict(optimizer="adamw", lr=1e-2, lr_end=1e-4, wd=0.05,
                         wd_end=0.4),
}


@pytest.mark.parametrize("fix_norm", [True, False])
def test_max_margin_ranking_loss_matches_jax(fix_norm):
    rs = np.random.RandomState(0)
    img = rs.standard_normal((6, 8)).astype(np.float32) * 3
    txt = rs.standard_normal((6, 8)).astype(np.float32)
    txt[2] = img[2]  # a positive pair inside the margin
    ref = jax_max_margin(jnp.asarray(img), jnp.asarray(txt),
                         fix_norm=fix_norm)
    got = max_margin_ranking_loss(torch.from_numpy(img),
                                  torch.from_numpy(txt), fix_norm=fix_norm)
    for key in ("loss", "max_margin_loss"):
        np.testing.assert_allclose(got[key].item(), float(ref[key]),
                                   rtol=1e-6, atol=1e-7)


def _init():
    """Leaves at every layer-decay depth, decayed or not; the class
    embedding's gradient is always 0 (Lion's sign of 0 is 0)."""
    rs = np.random.RandomState(0)
    shapes = {"visual.conv1.weight": (8, 3, 2, 2),
              "visual.class_embedding": (8,),
              "visual.positional_embedding": (5, 8),
              "visual.transformer.resblocks.0.mlp.fc1.weight": (16, 8),
              "visual.transformer.resblocks.0.mlp.fc1.bias": (16,),
              "visual.transformer.resblocks.1.attn.Wqkv.weight": (24, 8),
              "visual.ln_post.weight": (8,),
              "fc_cls.weight": (5, 8), "fc_cls.bias": (5,)}
    return {k: rs.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _grads(init, n=5, seed=1):
    rs = np.random.RandomState(seed)
    out = []
    for s in (3.0, 0.05, 1.0, 0.01, 10.0)[:n]:  # around the clip norm
        g = {k: (s * rs.standard_normal(v.shape)).astype(np.float32)
             for k, v in init.items()}
        g["visual.class_embedding"][:] = 0.0
        out.append(g)
    return out


def _jax_path(name):
    """The flax path of a port name (``resblocks.i`` is ``resblocks_i``)."""
    return name.replace("resblocks.", "resblocks_").split(".")


def _tree(named):
    tree = {}
    for name, v in named.items():
        *path, leaf = _jax_path(name)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _leaf(tree, name):
    for part in _jax_path(name):
        tree = tree[part]
    return np.asarray(tree)


def _port(init, cfg):
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = Optimizer(params.items(), cfg, build_schedule(cfg, NITER), LAYERS,
                    build_wd_schedule(cfg, NITER))
    return params, opt


def _port_step(params, opt, grads):
    for k, p in params.items():
        p.grad = torch.from_numpy(grads[k].copy())
    opt.update(opt.global_norm())


@pytest.mark.parametrize("case", list(CASES))
def test_five_updates_match_optax(case):
    init = _init()
    cfg = OptimConfig(**COMMON, **CASES[case])
    params, opt = _port(init, cfg)
    tx, _ = jax_build_optimizer(JaxOptimConfig(**COMMON, **CASES[case]),
                                _tree(init), NITER, num_layers=LAYERS)
    j_params = _tree(init)
    j_state = tx.init(j_params)
    for g in _grads(init):
        _port_step(params, opt, g)
        updates, j_state = tx.update(_tree(g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       _leaf(j_params, k), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{case} {k}")
    assert opt.count == 5
    if cfg.wd_end is not None:  # the decayed groups hold the last wd used
        want = build_wd_schedule(cfg, NITER)(4)
        assert {g["weight_decay"] for g in opt.inner.param_groups
                if g["decays"]} == {want}
    np.testing.assert_array_equal(
        params["visual.class_embedding"].detach().numpy(),
        init["visual.class_embedding"])


@pytest.mark.parametrize("name", ["sgd", "lion", "adamw_wd_end"])
def test_state_survives_a_restore(name):
    """Three updates, the state dict through torch.save, a new optimizer
    over parameters restored to the same values: two more updates on each
    give the same parameters bit for bit."""
    import io

    init = _init()
    cfg = OptimConfig(**COMMON, **CASES[name])
    grads = _grads(init)
    params, opt = _port(init, cfg)
    for g in grads[:3]:
        _port_step(params, opt, g)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    params2, opt2 = _port({k: p.detach().numpy() for k, p in params.items()},
                          cfg)
    opt2.load_state_dict(torch.load(buf, weights_only=True))
    assert opt2.count == 3 and set(opt2.state_dict()) == {cfg.optimizer,
                                                          "count"}
    for g in grads[3:]:
        _port_step(params, opt, g)
        _port_step(params2, opt2, g)
    for k in params:
        assert torch.equal(params[k], params2[k]), k
