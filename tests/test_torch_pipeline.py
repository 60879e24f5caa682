"""The port's GPipe tower (``avion_tpu_torch.parallel.pipeline``) against
the JAX package's (``avion_tpu.parallel.pipeline``), case for case with
``tests/test_pipeline_parallel.py``: the pipelined stack of 4 blocks
(width 64, 2 heads, f32) over gloo ranks (``tests/torch_dist.run_ranks``)
at pp = 4, at pp = 2 with 1, 2 and 4 microbatches, causal, with remat, at
data=2 x pp=2 and fsdp=2 x pp=2 (the stage leaves held by their stage
alone), against the JAX pipeline on a virtual mesh of the conftest's
devices, on the same weights (``params_from_jax`` unstacks JAX's ``[L,
...]`` tree); the stacked <-> sequential converters against JAX's; the
stages played in one process.  Forward at 2e-5, gradients at 5e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.parallel import make_mesh as jax_make_mesh
from avion_tpu.parallel import pipeline as jpipe
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.parallel import pipeline as ppipe

import torch_parallel_workers as workers
from torch_dist import run_ranks

WIDTH, LAYERS, HEADS = 64, 4, 2
KW = dict(width=WIDTH, layers=LAYERS, heads=HEADS)
FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)


def _port(tree):
    """A JAX pipelined stack's stacked tree (params or gradients) in the
    port's names (``resblocks.{i}...``)."""
    pre = "visual.transformer."
    sd = params_from_jax({"visual": {"transformer": jax.device_get(tree)}})
    return {k[len(pre):]: v for k, v in sd.items()}


def _jax_run(params, x, c, *, m=2, pp=4, causal=False, remat=False):
    """The JAX pipeline over data x pp devices: output, and the gradients
    of ``sum(out * c)`` (stacked) and of x."""
    mesh = jax_make_mesh(data=8 // pp, pp=pp)
    model = jpipe.PipelinedTransformer(
        **KW, use_flash=False, dtype=jnp.float32, num_microbatches=m,
        mesh=mesh, causal=causal, remat=remat)

    def loss(p, xx):
        out = model.apply({"params": p}, xx)
        return jnp.sum(out * c), out
    (_, out), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return np.asarray(out), _port(g_p), np.asarray(g_x)


@pytest.fixture(scope="module")
def stack():
    """A JAX pipelined stack's params (init at pp=4), a batch of 8 x 16
    tokens and a cotangent."""
    rs = np.random.RandomState(3)
    x = rs.standard_normal((8, 16, WIDTH)).astype(np.float32)
    c = rs.standard_normal((8, 16, WIDTH)).astype(np.float32)
    mesh = jax_make_mesh(data=2, pp=4)
    model = jpipe.PipelinedTransformer(**KW, use_flash=False,
                                       dtype=jnp.float32,
                                       num_microbatches=2, mesh=mesh)
    with jax.set_mesh(mesh):
        params = jax.device_get(model.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x))["params"])
    rs = np.random.RandomState(4)  # biases and norms away from 0 / 1
    params = jax.tree_util.tree_map(
        lambda v: v + 0.05 * rs.standard_normal(v.shape).astype(v.dtype),
        params)
    return params, x, c


def _ranks(stack, data=1, fsdp=1, pp=2, m=2, remat=False, causal=False):
    params, x, c = stack
    kw = dict(KW, causal=causal)
    return run_ranks(workers.pipe_stack, data * fsdp * pp, "tower",
                     _port(params), x, c, data, fsdp, pp, m, remat, kw)


def _check(ranks, ref, data=1, fsdp=1, grads=True):
    out, g_p, g_x = ref
    per = out.shape[0] // (data * fsdp)
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["out"], out, **FWD)
        if not grads:
            continue
        b = rank // (len(ranks) // (data * fsdp))
        np.testing.assert_allclose(r["dx"], g_x[b * per:(b + 1) * per],
                                   **GRAD)
        assert r["grads"].keys() == g_p.keys()
        for n, g in g_p.items():
            np.testing.assert_allclose(r["grads"][n], g.numpy(), err_msg=n,
                                       **GRAD)


def test_pipeline_matches_sequential_forward(stack):
    """pp = 4 (one block a stage), 2 microbatches: output and gradients."""
    params, x, c = stack
    _check(_ranks(stack, pp=4), _jax_run(params, x, c))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_pipeline_microbatch_counts(stack, m):
    params, x, c = stack
    _check(_ranks(stack, pp=2, m=m), _jax_run(params, x, c, m=m, pp=2),
           grads=False)


def test_pipeline_gradients_match_sequential(stack):
    """data=2 x pp=2: each batch group pipelines its rows; every gradient
    (gathered over the stages) and the input's against JAX's."""
    params, x, c = stack
    _check(_ranks(stack, data=2, pp=2), _jax_run(params, x, c, pp=2),
           data=2)


def test_pipeline_init_and_param_roundtrip(stack):
    """The port's stacked <-> sequential converters against JAX's (exact),
    and the JAX stacked tree carried by ``params_from_jax`` into the
    port's pipelined stack and its sequential ``Transformer`` alike."""
    from avion_tpu_torch.models.layers import Transformer

    params, x, _ = stack
    seq = jpipe.unstack_block_params(params)
    mine = ppipe.unstack_block_params(params)
    assert jax.tree_util.tree_structure(seq) == \
        jax.tree_util.tree_structure(mine)
    for a, b in zip(jax.tree_util.tree_leaves(seq),
                    jax.tree_util.tree_leaves(mine)):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = ppipe.stack_block_params(mine, LAYERS)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
    sd = _port(params)
    pipe = ppipe.PipelinedTransformer(**KW, dtype=torch.float32)
    pipe.load_state_dict(sd, strict=True)
    tower = Transformer(**KW, dtype=torch.float32)
    tower.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(x)
    torch.testing.assert_close(pipe(xt), tower(xt))


def test_pipeline_params_shard_over_pp(stack):
    """fsdp=2 x pp=2: a stage's leaves are held by its ``pp`` rank alone
    (the other stage's as empty placeholders), FSDP2 shards them over
    ``fsdp``; gradients against JAX's."""
    params, x, c = stack
    ranks = _ranks(stack, fsdp=2, pp=2)
    _check(ranks, _jax_run(params, x, c, pp=2), fsdp=2)
    for rank, r in enumerate(ranks):
        stage = rank % 2
        for i in range(LAYERS):
            shape = r["held"][f"resblocks.{i}.attn.Wqkv.weight"]
            assert shape == ((3 * WIDTH, WIDTH) if i // 2 == stage
                             else (0, WIDTH)), (rank, i, shape)


def test_pipeline_causal_stack(stack):
    params, x, c = stack
    _check(_ranks(stack, pp=2, causal=True),
           _jax_run(params, x, c, pp=2, causal=True))


def test_pipeline_remat_matches_exact(stack):
    """``remat`` (each block under ``save_attn``) is a memory knob: the
    same output and gradients as JAX's remat pipeline."""
    params, x, c = stack
    _check(_ranks(stack, pp=2, remat=True),
           _jax_run(params, x, c, pp=2, remat=True))


@pytest.mark.parametrize("pp", [1, 2, 4])
def test_run_stages_local_matches_sequential(stack, pp):
    """The stages played in one process (the card's check) against the
    stack run in sequence: output and every gradient; 3 stages of 4 blocks
    refused."""
    params, x, c = stack
    pipe = ppipe.PipelinedTransformer(**KW, dtype=torch.float32,
                                      num_microbatches=2)
    pipe.load_state_dict(_port(params), strict=True)
    outs = []
    for fn in (pipe, lambda xx: ppipe.run_stages_local(pipe, xx, pp)):
        pipe.zero_grad(set_to_none=True)
        out = fn(torch.from_numpy(x))
        (out * torch.from_numpy(c)).sum().backward()
        outs.append((out.detach(), {n: p.grad.clone()
                                    for n, p in pipe.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], **FWD)
    for n, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][n], g, msg=n, **GRAD)
    with pytest.raises(ValueError, match="not divisible by pp=3"):
        ppipe.run_stages_local(pipe, torch.from_numpy(x), 3)
