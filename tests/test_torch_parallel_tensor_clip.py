"""The CLIP step at ``mesh.tensor=2`` over 4 gloo ranks against the JAX step
on a virtual mesh of the same shape (``tests/test_torch_parallel_train``'s
harness and tolerances: loss and ``clip_acc`` 2e-5, the gradients 5e-5,
the parameters 1e-5 off the f32 noise): data=2 x tensor=2, fsdp=2 x
tensor=2 (FSDP2 over each rank's parts) and sp=2 x tensor=2 (the ring's
hops on H / t heads).  JAX's ``tensor`` sums its losses within 1e-4
relative of the one-device step (``tests/test_tensor_parallel.py``); the
port is held to the tighter bound.  Then two steps at data=2 x tensor=2:
the parameters every rank holds whole are bit-equal on all four ranks,
the parts equal on the ranks of one tensor index.  And ``main`` over
data=2 x tensor=2, resumed by one process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.parallel import make_mesh as jax_make_mesh
from avion_tpu_torch.models.pt_import import params_from_jax

import torch_parallel_workers as workers
from test_torch_parallel_train import (CLIP_TINY, OPT, _batch,  # noqa
                                       _compare, _jax_step, tiny_ego4d)
from torch_dist import run_ranks


@pytest.fixture(scope="module")
def jax_setup():
    model = JaxCLIP(**CLIP_TINY, use_flash=False, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)),
                        jnp.zeros((1, 77), jnp.int32))["params"]
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32), params)
    return model, params


def _held(ranks):
    return {n for n, v in ranks[0]["local"].items()
            if v.shape != ranks[0]["params"][n].shape}


@pytest.mark.parametrize("data,fsdp", [(2, 1), (1, 2)],
                         ids=["data2xtensor2", "fsdp2xtensor2"])
def test_tensor_step_matches_jax_mesh(jax_setup, data, fsdp):
    jm, params = jax_setup
    batch = _batch()
    ref_metrics, ref_params, ref_grads = _jax_step(jm, params, batch, data,
                                                   fsdp, tensor=2)
    ranks = run_ranks(workers.train_step, 4, params_from_jax(params), OPT,
                      batch, data, fsdp, 1, "clip", 1, 2)
    _compare(ranks, ref_metrics, ref_params, ref_grads)
    assert [r["tensor"] for r in ranks] == [0, 1, 0, 1]
    # the visual tower's Wqkv and both towers' MLPs are held in halves
    held = _held(ranks)
    assert "visual.transformer.resblocks.0.attn.Wqkv.weight" in held
    assert "textual.transformer.resblocks.1.mlp.fc2.weight" in held
    assert "visual.transformer.resblocks.0.attn.out_proj.weight" not in held
    for r in ranks:
        assert any(r["sharded"].values()) == (fsdp > 1)


def test_sequence_parallel_tensor_step_matches_jax():
    """sp=2 x tensor=2: each rank 4 of the 8 visual tokens of its batch
    group and 1 of the 2 heads; the ring over the sp ranks of one tensor
    index."""
    jm = JaxCLIP(**CLIP_TINY, use_flash=False, dtype=jnp.float32,
                 pooling="gap", sequence_parallel=True)
    with jax.set_mesh(jax_make_mesh(data=8, fsdp=1, tensor=1)):
        params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((8, 2, 32, 32, 3)),
                                  jnp.zeros((8, 77), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params)
    batch = _batch()
    ref = _jax_step(jm, params, batch, 1, 1, sp=2, tensor=2)
    ranks = run_ranks(workers.train_step, 4, params_from_jax(params), OPT,
                      batch, 1, 1, 1, "clip", 2, 2)
    _compare(ranks, *ref)


def test_two_steps_keep_replicas_bit_equal(jax_setup):
    """After two steps at data=2 x tensor=2, what every rank holds whole
    (norms, biases, embeddings, the projections, the slice-used
    ``out_proj``) is bit-equal on all four ranks; each part is bit-equal
    on the two ranks of its tensor index."""
    _, params = jax_setup
    ranks = run_ranks(workers.train_step, 4, params_from_jax(params), OPT,
                      _batch(), 2, 1, 1, "clip", 1, 2, 2)
    held = _held(ranks)
    assert held and len(held) < len(ranks[0]["local"])
    for name, ref in ranks[0]["local"].items():
        same = [r for r in ranks if name not in held
                or r["tensor"] == ranks[0]["tensor"]]
        for r in same:
            np.testing.assert_array_equal(r["local"][name], ref,
                                          err_msg=name)
    for name in held:
        assert not np.array_equal(ranks[0]["local"][name],
                                  ranks[1]["local"][name]), name
        np.testing.assert_array_equal(ranks[1]["local"][name],
                                      ranks[3]["local"][name], err_msg=name)


def test_main_at_tensor_2_then_resumed_at_world_1(tiny_ego4d, tmp_path):
    """``pretrain_clip.main`` over data=2 x tensor=2 ranks for an epoch;
    its checkpoint holds the one-process layout, and ``main`` alone
    resumes from it for a second epoch."""
    import os.path as osp

    import torch

    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.train import pretrain_clip
    from avion_tpu_torch.train.common import latest_model_state

    root, meta = tiny_ego4d
    out = str(tmp_path / "run")
    args = ["model.name=CLIP_TINY", f"data.root={root}",
            f"data.train_metadata={meta}", "data.chunk_len=2", "data.fps=10",
            "data.clip_length=2", "data.crop_size=32", "data.decode_size=40",
            "data.batch_size=8", "data.num_workers=0", "optim.lr=1e-3",
            "optim.warmup_epochs=0", f"output_dir={out}", "print_freq=1",
            "--device", "cpu"]
    ranks = run_ranks(workers.entry_main, 4, "pretrain_clip",
                      [*args, "optim.epochs=1", "mesh.data=2",
                       "mesh.tensor=2"])
    assert [r["step"] for r in ranks] == [2] * 4
    state = latest_model_state(osp.join(out, "ckpt"))
    # the entry's projection width (model.project_embed_dim, 512)
    model = create_model("CLIP_TINY", num_frames=2, project_embed_dim=512)
    model.load_state_dict(state, strict=True)
    res = pretrain_clip.main([*args, "optim.epochs=2"])
    assert res["step"] == 4 and res["steps"] == 2
    assert not all(torch.equal(state[k], v) for k, v in
                   latest_model_state(osp.join(out, "ckpt")).items())
