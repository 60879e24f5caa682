"""The port's schedule, weight-decay mask and optimizer against the JAX
package's (optax), f32: the schedule at every step, the mask under the
port's names for every CLIP parameter, and five clipped AdamW updates
at 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.optim.factory import build_optimizer as jax_build_optimizer
from avion_tpu.optim.factory import wd_mask as jax_wd_mask
from avion_tpu.optim.schedules import cosine_schedule as jax_cosine
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.optim.factory import Optimizer, build_schedule, wd_mask
from avion_tpu_torch.optim.schedules import cosine_schedule

OPT = dict(lr=1e-2, lr_start=1e-3, lr_end=1e-4, warmup_epochs=0.5, epochs=2,
           wd=0.05, grad_clip_norm=1.0)
NITER = 4  # 2 warmup updates, 8 in all


@pytest.mark.parametrize("args", [(4e-5, 1e-5, 5, 7, 1.0, 1e-6),
                                  (1e-3, 0.0, 2.5, 4, 0.0, 0.0),
                                  (3e-4, 1e-6, 1, 10, 0.3, 1e-5)])
def test_cosine_schedule_matches_jax(args):
    got, ref = cosine_schedule(*args), jax_cosine(*args)
    total = int(args[2] * args[3])
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-12)


def test_wd_mask_matches_jax_under_port_names():
    """Every flax CLIP leaf, filled with its own index, carried across by
    ``params_from_jax``: the port's name for it gets the JAX decision."""
    model = JaxCLIP(embed_dim=16, image_size=32, patch_size=16, num_frames=2,
                    vision_width=32, vision_layers=2, vision_heads=2,
                    context_length=8, vocab_size=64, text_width=16,
                    text_heads=2, text_layers=2, use_flash=False,
                    dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32)
                  for i, x in enumerate(leaves)])
    decide = jax.tree_util.tree_leaves(jax_wd_mask(params))
    port = params_from_jax(tagged)
    assert len(port) == len(leaves)
    decayed = 0
    for name, t in port.items():
        i = int(t.reshape(-1)[0]) if t.numel() else None
        assert wd_mask(name, t) == bool(decide[i]), name
        decayed += wd_mask(name, t)
    assert decayed == 2 * 4 * 2 + 1 + 2  # dense kernels, conv1, projections


def _tree(named):
    tree = {}
    for name, v in named.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def test_five_adamw_steps_match_optax():
    rs = np.random.RandomState(0)
    init = {"visual.fc.weight": rs.standard_normal((8, 4)),
            "visual.fc.bias": rs.standard_normal(4),
            "visual.ln_pre.weight": rs.standard_normal(4),
            "visual.positional_embedding": rs.standard_normal((5, 4)),
            "image_projection": rs.standard_normal((4, 3)),
            "logit_scale": np.float32(2.6)}
    init = {k: np.asarray(v, np.float32) for k, v in init.items()}
    # gradient sizes on both sides of the clip norm
    grads = [{k: np.asarray(s * rs.standard_normal(np.shape(v)), np.float32)
              for k, v in init.items()} for s in (3.0, 0.05, 1.0, 0.01, 10.0)]

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    cfg = OptimConfig(**OPT)
    opt = Optimizer(params.items(), cfg, build_schedule(cfg, NITER))
    tx, _ = jax_build_optimizer(JaxOptimConfig(**OPT), _tree(init), NITER)
    j_params = _tree(init)
    j_state = tx.init(j_params)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.global_norm()
        np.testing.assert_allclose(
            norm.item(), float(optax.global_norm(_tree(g))), rtol=1e-6)
        opt.update(norm)
        updates, j_state = tx.update(_tree(g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in params.items():
            ref = j_params
            for part in k.split("."):
                ref = ref[part]
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert opt.count == 5


def test_unported_options_raise():
    for bad, match in ((dict(state_dtype="float16"), "state_dtype"),
                       (dict(update_freq=2, accum="chunked"), "accum")):
        with pytest.raises(ValueError, match=match):
            Optimizer([], OptimConfig(**bad), lambda step: 0.0)
    with pytest.raises(ValueError, match="unknown optimizer"):
        Optimizer([], OptimConfig(optimizer="adagrad"), lambda step: 0.0)
    for ported in (dict(update_freq=2), dict(state_dtype="bfloat16")):
        Optimizer([], OptimConfig(**ported), lambda step: 0.0)


def test_fix_lr_and_state_roundtrip():
    cfg = OptimConfig(fix_lr=True, lr=0.5)
    assert build_schedule(cfg, 10)(123) == 0.5
    p = torch.nn.Parameter(torch.ones(3, 3))
    opt = Optimizer([("w", p)], cfg, build_schedule(cfg, 10))
    p.grad = torch.ones(3, 3)
    opt.update()
    again = Optimizer([("w", p)], cfg, build_schedule(cfg, 10))
    again.load_state_dict(opt.state_dict())
    assert again.count == 1
    assert torch.equal(again.inner.state[p]["exp_avg"],
                       opt.inner.state[p]["exp_avg"])
