"""The port's mixture-of-experts MLP (``avion_tpu_torch.ops.moe``) against
the JAX package's (``avion_tpu.ops.moe``), case for case with
``tests/test_moe.py``: the dispatch / combine masks and the aux loss on the
same router logits, the capacity rule, the grouped and ungrouped layer,
the layer and its gradients (router, experts, input) on the same weights,
the router's stats, a block with ``moe_mlp``, and CLIP_TINY's train step
with the router losses and metrics; then the layer over gloo ranks
(``tests/torch_dist.run_ranks``): ``data`` = 2 and 4 with routing groups
that straddle two ranks' rows and a padded tail group, ``data=2 x ep=2``
with the experts cut over ``ep`` (the router's, the experts' and a block's
non-MoE gradients against the JAX layer's), and the ``ep`` ranks played in
one process.  f32; the forward at 2e-5, gradients at 5e-4 (the north
star's tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.models import create_model as jax_create_model
from avion_tpu.models.layers import Block as JaxBlock
from avion_tpu.ops import moe as jmoe
from avion_tpu.train.steps import make_clip_train_step as jax_make_step
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.models.layers import Block
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.ops import moe as pmoe
from avion_tpu_torch.optim.factory import build_optimizer
from avion_tpu_torch.train.steps import make_clip_train_step

import torch_parallel_workers as workers
from torch_dist import run_ranks

FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _port_masks(logits, top_k, capacity):
    d, c, aux, stats = pmoe.moe_dispatch_masks(_t(logits), top_k, capacity)
    return d.numpy(), c.numpy(), float(aux), {k: v.numpy()
                                              for k, v in stats.items()}


def _jax_masks(logits, top_k, capacity):
    d, c, aux, stats = jmoe.moe_dispatch_masks(jnp.asarray(logits), top_k,
                                               capacity)
    return np.asarray(d), np.asarray(c), float(aux), {
        k: np.asarray(v) for k, v in stats.items()}


def _same_masks(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **FWD)
    np.testing.assert_allclose(got[2], want[2], **FWD)
    for k in want[3]:
        np.testing.assert_allclose(got[3][k], want[3][k], err_msg=k, **FWD)


def test_dispatch_masks_exact_routing():
    logits = np.random.RandomState(0).standard_normal((2, 16, 4)).astype(
        np.float32)
    got = _port_masks(logits, 2, 16)
    _same_masks(got, _jax_masks(logits, 2, 16))
    # each token occupies exactly one slot in each of its 2 experts
    assert (got[0].sum(axis=(2, 3)) == 2).all()
    assert got[0].sum(axis=1).max() <= 1.0  # no slot is double-booked


def test_dispatch_capacity_drops_overflow():
    logits = np.stack([np.full(12, 10.0), np.zeros(12), np.zeros(12),
                       np.zeros(12)], axis=1)[None].astype(np.float32)
    got = _port_masks(logits, 1, 4)
    _same_masks(got, _jax_masks(logits, 1, 4))
    assert got[0][0, :, 0].sum() == 4.0 and got[0][0, :, 1:].sum() == 0.0


@pytest.mark.parametrize("group,experts,top_k,cf", [
    (256, 8, 2, 1.25), (256, 8, 1, 1.25), (16, 4, 2, 8.0), (5, 4, 2, 8.0),
    (40, 4, 2, 0.5), (3, 16, 1, 1.0)])
def test_capacity_scales_with_top_k_and_group(group, experts, top_k, cf):
    assert pmoe._capacity(group, experts, top_k, cf) == jmoe._capacity(
        group, experts, top_k, cf)


def _moe_sd(params):
    """A flax ``MoEMlp`` tree in the port's names: the router's kernel
    transposed, the expert leaves as they are."""
    sd = {"router.weight": _t(params["router"]["kernel"]).T.contiguous(),
          "router.bias": _t(params["router"]["bias"])}
    for k in ("expert_fc1", "expert_fc1_bias", "expert_fc2",
              "expert_fc2_bias"):
        sd[k] = _t(params[k])
    return sd


def _jax_moe(**kw):
    return jmoe.MoEMlp(dtype=jnp.float32, **kw)


def _port_moe(params, **kw):
    kw = dict(kw)
    if "hidden_mult" not in kw:
        kw["hidden_mult"] = 4.0
    m = pmoe.MoEMlp(dtype=torch.float32, **kw)
    m.load_state_dict(_moe_sd(params), strict=True)
    return m


def test_moe_mlp_grouped_matches_ungrouped():
    """With ample capacity the routing is per token: groups of 256 and of
    5 (the 16 tokens' tail group padded) give the same output, the port's
    as JAX's."""
    x = np.random.RandomState(4).standard_normal((2, 8, 32)).astype(
        np.float32)
    kw = dict(width=32, experts=4, hidden_mult=2.0, top_k=2,
              capacity_factor=8.0)
    big = _jax_moe(group_size=256, **kw)
    params = big.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    outs = []
    for group in (256, 5):
        ref = _jax_moe(group_size=group, **kw).apply({"params": params}, x)
        got = _port_moe(params, group_size=group, **kw)(_t(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   **FWD)
        outs.append(got.detach().numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=1e-5)


def _loss_fn_jax(model, x, c):
    def loss(params, xx):
        y, v = model.apply({"params": params}, xx,
                           mutable=["losses", "moe_zloss", "metrics"])
        aux = v["losses"]["moe_aux"][0]
        z = v["moe_zloss"]["z"][0]
        return jnp.sum(y * c) + 0.01 * aux + 1e-3 * z, (y, aux, z)
    return loss


def test_moe_mlp_matches_per_token_reference():
    """The layer at capacity factor 0.5 on 18 tokens in groups of 8 (the
    tail group padded, some assignments dropped): output, aux and z
    losses, stats, and the gradients of every parameter and of the input
    under ``sum(y * c) + 0.01 aux + 1e-3 z``."""
    rs = np.random.RandomState(1)
    x = rs.standard_normal((2, 9, 32)).astype(np.float32)
    c = rs.standard_normal((2, 9, 32)).astype(np.float32)
    kw = dict(width=32, experts=4, hidden_mult=2.0, top_k=2, group_size=8,
              capacity_factor=0.5)
    jm = _jax_moe(**kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    (_, (y, aux, z)), (g_p, g_x) = jax.value_and_grad(
        _loss_fn_jax(jm, x, c), argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))
    _, v = jm.apply({"params": params}, x, mutable=["metrics"])
    pm = _port_moe(params, **kw)
    xt = _t(x).requires_grad_()
    out = pm(xt)
    ((out * _t(c)).sum() + 0.01 * pm.aux + 1e-3 * pm.zloss).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **FWD)
    np.testing.assert_allclose(float(pm.aux.detach()), float(aux), **FWD)
    np.testing.assert_allclose(float(pm.zloss.detach()), float(z), **FWD)
    np.testing.assert_allclose(pm.load.numpy(), np.asarray(
        v["metrics"]["moe_expert_load"][0]), **FWD)
    np.testing.assert_allclose(float(pm.overflow), float(
        v["metrics"]["moe_overflow"][0]), **FWD)
    assert float(pm.overflow) > 0  # capacity drops some assignments
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **GRAD)
    want = _moe_sd(g_p)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   err_msg=n, **GRAD)


def test_router_observability_stats():
    """A balanced router: no overflow, the load sums to 1; a collapsed
    one: everything on expert 0, 8 of 12 dropped; as JAX's."""
    balanced = np.random.RandomState(1).standard_normal((1, 16, 4)).astype(
        np.float32)
    got = _port_masks(balanced, 2, 16)
    _same_masks(got, _jax_masks(balanced, 2, 16))
    assert abs(got[3]["expert_load"].sum() - 1.0) < 1e-6
    assert got[3]["overflow"] == 0.0
    collapsed = np.stack([np.full(12, 10.0), np.zeros(12), np.zeros(12),
                          np.zeros(12)], axis=1)[None].astype(np.float32)
    got = _port_masks(collapsed, 1, 4)
    _same_masks(got, _jax_masks(collapsed, 1, 4))
    assert got[3]["expert_load"][0] == 1.0
    np.testing.assert_allclose(got[3]["overflow"], 8.0 / 12.0, atol=1e-6)


def _block_sd(params):
    """A flax ``Block`` tree (with ``moe_mlp``) in the port's names."""
    tree = {"visual": {"transformer": {"resblocks_0": params}}}
    prefix = "visual.transformer.resblocks.0."
    return {k[len(prefix):]: v for k, v in params_from_jax(tree).items()}


BLOCK = dict(width=64, heads=2, moe_experts=4)


@pytest.fixture(scope="module")
def moe_block():
    rs = np.random.RandomState(3)
    x = rs.standard_normal((2, 16, 64)).astype(np.float32)
    jb = JaxBlock(**BLOCK, use_flash=False, dtype=jnp.float32)
    params = jax.device_get(jb.init(jax.random.PRNGKey(0),
                                    jnp.asarray(x))["params"])
    return jb, params, x


def test_block_with_moe_mlp(moe_block):
    """``moe_experts`` swaps the block's MLP for ``moe_mlp`` (no ``mlp``):
    the port's block against JAX's, output and every gradient."""
    jb, params, x = moe_block
    assert "moe_mlp" in params and "mlp" not in params
    c = np.random.RandomState(4).standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        y, v = jb.apply({"params": p}, xx, mutable=["losses", "moe_zloss",
                                                    "metrics"])
        aux = sum(jax.tree_util.tree_leaves(v["losses"]))
        return jnp.sum(y * c) + 0.01 * aux, y
    (_, y), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(params,
                                                          jnp.asarray(x))
    pb = Block(**BLOCK, dtype=torch.float32)
    pb.load_state_dict(_block_sd(params), strict=True)
    assert hasattr(pb, "moe_mlp") and not hasattr(pb, "mlp")
    xt = _t(x).requires_grad_()
    out = pb(xt)
    ((out * _t(c)).sum() + 0.01 * pb.moe_mlp.aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **GRAD)
    want = _block_sd(g_p)
    for n, p in pb.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   err_msg=n, **GRAD)


def test_moe_train_step_logs_router_metrics():
    """CLIP_TINY with 4 experts a block, one step with the z-loss weighted
    in: the port's ``loss``, ``moe_aux``, ``moe_zloss``, ``moe_load_max``,
    ``moe_load_min`` and ``moe_overflow`` are JAX's, and so are the
    parameters after SGD's update."""
    jm = jax_create_model("CLIP_TINY", moe_experts=4, use_flash_attn=False)
    rs = np.random.RandomState(5)
    video = rs.standard_normal((4, 2, 32, 32, 3)).astype(np.float32)
    text = rs.randint(1, 1000, (4, 77)).astype(np.int32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.asarray(video[:2]),
                                    jnp.asarray(text[:2]))["params"])
    tx = optax.sgd(1e-3)
    step = jax.jit(jax_make_step(jm, tx, moe_zloss_weight=1e-3))
    state, ref = step(JaxTrainState.create(params, tx),
                      {"video": jnp.asarray(video), "text": text},
                      jax.random.PRNGKey(1))
    pm = create_model("CLIP_TINY", moe_experts=4)
    pm.load_state_dict(params_from_jax(params), strict=True)
    opt, _ = build_optimizer(OptimConfig(optimizer="sgd", lr=1e-3,
                                         momentum=0.0, wd=0.0, fix_lr=True),
                             pm, 4)
    pstate = TrainState.create(pm, opt)
    _, got = make_clip_train_step(pm, moe_zloss_weight=1e-3)(
        pstate, {"video": _t(video), "text": torch.from_numpy(text)})
    for k in ("loss", "moe_aux", "moe_zloss", "moe_load_max",
              "moe_load_min", "moe_overflow"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), err_msg=k,
                                   **FWD)
    assert float(got["moe_load_max"]) >= float(got["moe_load_min"]) >= 0.0
    want = params_from_jax(jax.device_get(state.params))
    for n, p in pm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), err_msg=n,
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ep", [2, 4])
def test_run_experts_local_matches_whole(ep):
    """The ``ep`` ranks played in one process (each rank's E / ep experts
    on its slice of the dispatched tokens) against the whole layer: the
    same output, stats and gradients."""
    torch.manual_seed(0)
    m = pmoe.MoEMlp(32, experts=8, hidden_mult=2.0, group_size=8,
                    dtype=torch.float32).init_weights(
                        torch.Generator().manual_seed(0))
    x = torch.randn(2, 9, 32)
    outs = []
    for fn in (m, lambda xx: pmoe.run_experts_local(m, xx, ep)):
        m.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        y = fn(xi)
        (y.sum() + m.aux).backward()
        outs.append((y.detach(), xi.grad, m.load.clone(),
                     {n: p.grad.clone() for n, p in m.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0])
    torch.testing.assert_close(outs[1][1], outs[0][1])
    torch.testing.assert_close(outs[1][2], outs[0][2])
    for n in outs[0][3]:
        torch.testing.assert_close(outs[1][3][n], outs[0][3][n], msg=n)
    with pytest.raises(ValueError, match="does not divide"):
        pmoe.run_experts_local(m, x, 3)


@pytest.fixture(scope="module")
def moe_layer():
    """JAX's layer with groups of 8 on 4 x 9 tokens (the global 36 padded
    to 40): its output, losses and gradients under ``sum(y * c) + 0.01
    aux``."""
    rs = np.random.RandomState(7)
    x = rs.standard_normal((4, 9, 32)).astype(np.float32)
    c = rs.standard_normal((4, 9, 32)).astype(np.float32)
    kw = dict(width=32, experts=4, hidden_mult=2.0, group_size=8)
    jm = _jax_moe(**kw)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]

    def loss(p, xx):
        y, v = jm.apply({"params": p}, xx, mutable=["losses", "metrics"])
        aux = v["losses"]["moe_aux"][0]
        return jnp.sum(y * c) + 0.01 * aux, (y, aux, v["metrics"])
    (_, (y, aux, metrics)), (g_p, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return (kw, x, c, {k: v.numpy() for k, v in _moe_sd(params).items()},
            {"out": np.asarray(y), "aux": float(aux),
             "overflow": float(metrics["moe_overflow"][0]),
             "load": np.asarray(metrics["moe_expert_load"][0]),
             "grads": {k: v.numpy() for k, v in _moe_sd(g_p).items()},
             "dx": np.asarray(g_x)})


@pytest.mark.parametrize("data,ep", [(2, 1), (4, 1), (2, 2)],
                         ids=["data2", "data4", "data2-ep2"])
def test_moe_mlp_trains_on_ep_mesh(moe_layer, data, ep):
    """The layer over ``data x ep`` gloo ranks against JAX's on the global
    batch: at data = 2 rank 1's rows start at token 18, inside group 2 (16
    to 24); at data = 4 every rank boundary but 0 falls inside a group;
    the last rank pads the tail group.  At ``ep`` = 2 each rank holds 2 of
    the 4 experts.  Output, aux loss, stats, and the router's, the
    experts' (gathered) and the input's gradients."""
    kw, x, c, sd, ref = moe_layer
    ranks = run_ranks(workers.moe_layer, data * ep, "mlp",
                      {k: torch.from_numpy(v) for k, v in sd.items()}, x, c,
                      data, ep, kw)
    per = x.shape[0] // data
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["out"], ref["out"], **FWD)
        np.testing.assert_allclose(r["aux"], ref["aux"], **FWD)
        np.testing.assert_allclose(r["overflow"], ref["overflow"], **FWD)
        np.testing.assert_allclose(r["load"], ref["load"], **FWD)
        b = rank // ep
        np.testing.assert_allclose(r["dx"], ref["dx"][b * per:(b + 1) * per],
                                   **GRAD)
        for n, g in ref["grads"].items():
            np.testing.assert_allclose(r["grads"][n], g, err_msg=n, **GRAD)
        assert r["held"]["expert_fc1"][0] == 4 // ep
        assert r["held"]["router.weight"] == (4, 32)


def test_block_ep_gradients_against_jax(moe_block):
    """A block with ``moe_mlp`` over data=2 x ep=2 gloo ranks: the router's,
    ``expert_fc1``'s (each rank holds 2 of 4 experts) and the attention's
    ``Wqkv`` gradients are JAX's on the global batch (every leaf JAX
    replicates over ``ep`` gets the same gradient on each ``ep`` rank)."""
    jb, params, x = moe_block
    c = np.random.RandomState(4).standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        y, v = jb.apply({"params": p}, xx, mutable=["losses", "moe_zloss",
                                                    "metrics"])
        aux = sum(jax.tree_util.tree_leaves(v["losses"]))
        return jnp.sum(y * c) + 0.01 * aux, y
    (_, y), g_p = jax.value_and_grad(loss, has_aux=True)(params,
                                                         jnp.asarray(x))
    want = _block_sd(g_p)
    ranks = run_ranks(workers.moe_layer, 4, "block", _block_sd(params), x,
                      c, 2, 2, BLOCK)
    for r in ranks:
        np.testing.assert_allclose(r["out"], np.asarray(y), **FWD)
        for n in ("moe_mlp.router.weight", "moe_mlp.expert_fc1",
                  "attn.Wqkv.weight", "ln_1.weight"):
            np.testing.assert_allclose(r["grads"][n], want[n].numpy(),
                                       err_msg=n, **GRAD)
        assert r["held"]["moe_mlp.expert_fc1"][0] == 2
