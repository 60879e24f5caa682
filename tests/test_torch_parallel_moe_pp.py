"""CLIP's step with a mixture-of-experts tower over ``ep`` and with a
pipelined tower over ``pp`` (gloo ranks, ``tests/torch_dist.run_ranks``)
against the JAX step on a virtual mesh of the same shape, with CLIP_TINY
in f32 and the same weights (``params_from_jax``) and global batch
(``tests/test_torch_parallel_train``'s harness and tolerances): MoE at
data=2 x ep=2 (the routing group of 72 tokens straddles the two batch
groups' rows; the router's and every non-expert leaf's gradient alike on
the ``ep`` ranks) and its cached accumulation (each microbatch's aux
loss 1 / M of the objective); the pipelined tower at data=2 x pp=2 and
fsdp=2 x pp=2 (the patch embedding's and a stage's gradients).  A
checkpoint written over ``pp`` or ``ep`` with sharded state restores at
world 1 bit for bit (the one-process layout), and one written at world 1
restores over them (each rank its stage's leaves, or its experts).  The
entries that build neither model keep replicas over ``pp`` and ``ep``, as
JAX's devices of those axes: their steps against JAX's."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from optax import ScaleByAdamState

from avion_tpu.core.config import OptimConfig as JaxOptimConfig
from avion_tpu.core.train_state import TrainState as JaxTrainState
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.optim.factory import build_optimizer as jax_build_optimizer
from avion_tpu.parallel import make_mesh as jax_make_mesh
from avion_tpu.parallel.sharding import make_global_batch, shard_params
from avion_tpu.train import steps as jax_steps
from avion_tpu_torch.core.checkpoint import Checkpointer
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.optim.factory import build_optimizer

import torch_parallel_workers as workers
from test_torch_parallel_sp_entries import _cases
from test_torch_parallel_finetune import (OPT as FT_OPT,  # noqa: F401
                                          cls_params, compare_step,
                                          jax_mesh_step)
from test_torch_parallel_train import (CLIP_TINY, GRAD_TOL, LOSS_TOL,
                                       NOISE_GRAD, OPT, PARAM_TOL, _batch)
from torch_dist import run_ranks

MOE = {"moe_experts": 4}
PIPE = {"pipeline": True}


def _jax_params(model_kw, seed=0):
    jm = JaxCLIP(**CLIP_TINY, use_flash=False, dtype=jnp.float32,
                 pipeline_microbatches=2, **model_kw)
    mesh = jax_make_mesh(data=4, pp=2) if model_kw.get("pipeline") else None
    args = (jax.random.PRNGKey(seed), jnp.zeros((2, 2, 32, 32, 3)),
            jnp.zeros((2, 77), jnp.int32))
    if mesh is None:
        params = jm.init(*args)["params"]
    else:
        with jax.set_mesh(mesh):
            params = jm.init(*args)["params"]
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32),
        jax.device_get(params))
    return jm, params


@pytest.fixture(scope="module")
def moe_clip():
    return _jax_params(MOE)


@pytest.fixture(scope="module")
def pipe_clip():
    return _jax_params(PIPE)


def _clip_params(request, model_kw):
    return request.getfixturevalue("pipe_clip" if model_kw.get("pipeline")
                                   else "moe_clip")[1]


def _jax_step(jm, params, batch, *, data=1, fsdp=1, pp=1, ep=1,
              update_freq=1):
    """The JAX step jitted over a (data, fsdp, pp, ep) mesh of the
    conftest's devices on the global batch: (metrics, the updated
    parameters, the step's clipped gradients), in the port's names."""
    n = data * fsdp * pp * ep
    mesh = jax_make_mesh(data=data, fsdp=fsdp, pp=pp, ep=ep,
                         devices=jax.devices()[:n])
    tx, _ = jax_build_optimizer(JaxOptimConfig(**OPT), params, workers.NITER)
    with jax.set_mesh(mesh):
        state = JaxTrainState.create(
            shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh),
            tx)
        if update_freq > 1:
            step = jax.jit(jax_steps.make_clip_accum_train_step(
                jm, tx, update_freq))
            gb = make_global_batch(mesh, {
                k: v.reshape(update_freq, -1, *v.shape[1:])
                for k, v in batch.items()}, batch_dim=1)
        else:
            step = jax.jit(jax_steps.make_clip_train_step(jm, tx))
            gb = make_global_batch(mesh, batch)
        state, metrics = step(state, gb, jax.random.PRNGKey(0))
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, ScaleByAdamState))
        if isinstance(s, ScaleByAdamState)]
    b1 = JaxOptimConfig(**OPT).betas[0]
    port = lambda tree: {k: v.numpy() for k, v in params_from_jax(  # noqa
        jax.device_get(tree)).items()}
    return ({k: float(v) for k, v in metrics.items()}, port(state.params),
            {k: g / (1 - b1) for k, g in port(adam.mu).items()})


def _compare(ranks, ref_metrics, ref_params, ref_grads):
    """``test_torch_parallel_train``'s comparison: loss and ``clip_acc`` at
    2e-5, ``grad_norm`` and every gradient at 5e-5, the updated parameters
    at 1e-5, except where the reference step's gradient is at f32 rounding
    (below 1e-6; the pipeline's microbatches and the routing groups sum in
    another order than one pass): AdamW's first update is g / (|g| + eps),
    so those entries follow the rounding and are held to the learning
    rate."""
    for r in ranks:
        for key in ("loss", "clip_acc"):
            np.testing.assert_allclose(r["metrics"][key], ref_metrics[key],
                                       err_msg=key, **LOSS_TOL)
        np.testing.assert_allclose(r["metrics"]["grad_norm"],
                                   ref_metrics["grad_norm"], **GRAD_TOL)
        assert r["metrics"]["step_ok"] == 1.0
    got, grads = ranks[0]["params"], ranks[0]["grads"]
    assert got.keys() == ref_params.keys() == grads.keys()
    for k, ref in ref_params.items():
        np.testing.assert_allclose(grads[k], ref_grads[k],
                                   err_msg=f"grad {k}", **GRAD_TOL)
        noise = np.abs(ref_grads[k]) < NOISE_GRAD
        np.testing.assert_allclose(got[k][~noise], ref[~noise], err_msg=k,
                                   **PARAM_TOL)
        np.testing.assert_allclose(got[k][noise], ref[noise], err_msg=k,
                                   atol=OPT["lr"], rtol=0)


def _check_moe_metrics(ranks, ref):
    for r in ranks:
        for key in ("moe_aux", "moe_load_max", "moe_load_min",
                    "moe_overflow"):
            np.testing.assert_allclose(r["metrics"][key], ref[key],
                                       err_msg=key, **LOSS_TOL)


def test_moe_step_at_data_2_ep_2_matches_jax_mesh(moe_clip):
    """data=2 x ep=2: each rank holds 2 of the 4 experts of every block;
    the routing group (8 rows x 9 tokens) straddles the batch groups."""
    jm, params = moe_clip
    batch = _batch()
    ref = _jax_step(jm, params, batch, data=2, ep=2)
    ranks = run_ranks(workers.train_step, 4, params_from_jax(params), OPT,
                      batch, 2, 1, 1, "clip", 1, 1, 1, 1, 2, MOE)
    _compare(ranks, *ref)
    _check_moe_metrics(ranks, ref[0])
    held = "visual.transformer.resblocks.0.moe_mlp.expert_fc1"
    for r in ranks:
        assert r["local"][held].shape[0] == 2
        np.testing.assert_array_equal(
            r["local"]["visual.transformer.resblocks.0.moe_mlp.router.weight"],
            ranks[0]["local"][
                "visual.transformer.resblocks.0.moe_mlp.router.weight"])


def test_moe_cached_accumulation_matches_jax_mesh(moe_clip):
    """The cached accumulation (update_freq 2) at data=2 x ep=2: each
    microbatch's router losses count 1 / M in the objective."""
    jm, params = moe_clip
    batch = _batch()
    ref = _jax_step(jm, params, batch, data=2, ep=2, update_freq=2)
    ranks = run_ranks(workers.train_step, 4, params_from_jax(params), OPT,
                      {k: v.reshape(2, -1, *v.shape[1:])
                       for k, v in batch.items()}, 2, 1, 2, "clip", 1, 1, 1,
                      1, 2, MOE)
    _compare(ranks, *ref)
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["moe_aux"],
                                   ref[0]["moe_aux"], **LOSS_TOL)


@pytest.mark.parametrize("data,fsdp", [(2, 1), (1, 2)],
                         ids=["data2-pp2", "fsdp2-pp2"])
def test_pipeline_step_matches_jax_mesh(pipe_clip, data, fsdp):
    """The pipelined visual tower (2 blocks, one a stage, 2 microbatches):
    every gradient, the patch embedding's and a stage leaf's among them,
    and the updated parameters against JAX's; a stage's leaves are held by
    its rank alone."""
    jm, params = pipe_clip
    batch = _batch()
    ref = _jax_step(jm, params, batch, data=data, fsdp=fsdp, pp=2)
    ranks = run_ranks(workers.train_step, 4, params_from_jax(params), OPT,
                      batch, data, fsdp, 1, "clip", 1, 1, 1, 2, 1, PIPE)
    _compare(ranks, *ref)
    stage_leaf = "visual.transformer.resblocks.1.attn.Wqkv.weight"
    for rank, r in enumerate(ranks):
        assert r["local"][stage_leaf].shape[0] == (192 if rank % 2 else 0)
    grads = ranks[0]["grads"]
    assert np.abs(grads["visual.conv1.weight"]).max() > 0
    assert np.abs(grads[stage_leaf]).max() > 0


@pytest.mark.parametrize("model_kw,mesh", [(PIPE, dict(pp=2)),
                                           (MOE, dict(ep=2))],
                         ids=["fsdp2-pp2", "fsdp2-ep2"])
def test_checkpoint_over_pp_and_ep_restores_at_world_1(request, model_kw,
                                                       mesh, tmp_path):
    """A step over fsdp=2 x pp=2 (or ep=2), then a checkpoint in the
    one-process layout: a world-1 state restores it bit for bit,
    parameters, moments and count; a ``params_from_jax`` state loads into
    the same model strictly."""
    sd = params_from_jax(_clip_params(request, model_kw))
    out = str(tmp_path / "ckpt")
    blob, *_ = run_ranks(workers.save_after_step, 4, sd, OPT, _batch(), out,
                         1, mesh.get("pp", 1), mesh.get("ep", 1), model_kw)
    saved = torch.load(io.BytesIO(blob), weights_only=True)
    model = create_model("CLIP_TINY", num_frames=2, **model_kw)
    optimizer, _ = build_optimizer(OptimConfig(**OPT), model, workers.NITER)
    state = TrainState.create(model, optimizer)
    Checkpointer(out).restore(state)
    got = state.state_dict()
    assert state.step == 1
    for k, v in saved["model"].items():
        assert v.shape == sd[k].shape and torch.equal(got["model"][k], v), k
    ours, theirs = got["optimizer"]["adamw"], saved["optimizer"]["adamw"]
    assert ours["state"].keys() == theirs["state"].keys()
    for i, moments in theirs["state"].items():
        for name, v in moments.items():
            assert torch.equal(ours["state"][i][name], v), (i, name)
    model.load_state_dict(sd, strict=True)  # the one-process layout


@pytest.mark.parametrize("model_kw,mesh", [(PIPE, dict(pp=2)),
                                           (MOE, dict(ep=2))],
                         ids=["pp2", "ep2"])
def test_checkpoint_at_world_1_restores_over_pp_and_ep(request, model_kw,
                                                       mesh, tmp_path):
    """A world-1 checkpoint restored over 2 ranks: a stage's leaves whole
    on its rank and empty elsewhere; each rank's experts, dim 0's half;
    every other parameter and moment whole."""
    from avion_tpu_torch.parallel.mesh import make_mesh
    from avion_tpu_torch.parallel.sharding import make_global_batch as mgb
    from avion_tpu_torch.train.steps import make_clip_train_step

    sd = params_from_jax(_clip_params(request, model_kw))
    model = create_model("CLIP_TINY", num_frames=2, **model_kw)
    model.load_state_dict(sd, strict=True)
    optimizer, _ = build_optimizer(OptimConfig(**OPT), model, workers.NITER)
    state = TrainState.create(model, optimizer)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    state, _ = make_clip_train_step(model)(state, mgb(make_mesh(data=1),
                                                      batch))
    out = str(tmp_path / "ckpt")
    Checkpointer(out).save(state.step, state)
    whole = state.state_dict()
    names = dict(zip(optimizer.names, range(len(optimizer.names))))
    for r, got in enumerate(run_ranks(
            workers.restore_parts, 2, sd, OPT, out, 1, mesh.get("pp", 1),
            mesh.get("ep", 1), model_kw)):
        assert got["step"] == 1 and got["held"]
        for n, part in got["params"].items():
            want = whole["model"][n].numpy()
            mu = whole["optimizer"]["adamw"]["state"][names[n]]["exp_avg"]
            mu = mu.numpy()
            if n not in got["held"]:
                np.testing.assert_array_equal(part, want, err_msg=n)
                np.testing.assert_array_equal(got["mu"][n], mu)
            elif "expert" in n:
                half = want.shape[0] // 2
                np.testing.assert_array_equal(
                    part, want[r * half:(r + 1) * half], err_msg=n)
                np.testing.assert_array_equal(
                    got["mu"][n], mu[r * half:(r + 1) * half])
            elif part.ndim and part.shape[0] == 0:  # another stage's
                assert got["mu"][n].shape == part.shape, n
            else:
                np.testing.assert_array_equal(part, want, err_msg=n)
                np.testing.assert_array_equal(got["mu"][n], mu)


@pytest.fixture(scope="module")
def cls_reference(request):
    """The CLS entry's case and its JAX step at data=2 (JAX's numbers do
    not depend on the ``pp`` / ``ep`` axes)."""
    case = _cases(request, "finetune_cls")
    _, params, batch, _, ema, _, make, _ = case
    return case, jax_mesh_step(make, params, batch, 2, 1,
                               use_ema=ema is not None)


@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_entry_keeps_replicas_over_pp_and_ep(cls_reference, axis):
    """An entry whose model is neither pipelined nor MoE (the CLS
    finetune) at data=2 x pp=2 (or ep=2): the ``pp`` / ``ep`` ranks of a
    batch group read its rows and compute the same step, as the JAX
    devices of those axes do."""
    (_, params, batch, kind, ema, smoothing, _, keys), ref = cls_reference
    ref_metrics, ref_params, ref_ema = ref
    sd = params_from_jax(params)
    ranks = run_ranks(workers.entry_step, 4, kind, sd, FT_OPT, batch, 2, 1,
                      ema, smoothing, 1, 1, *((2, 1) if axis == "pp"
                                              else (1, 2)))
    compare_step(ranks, ref_metrics, ref_params, keys, ref_ema)
