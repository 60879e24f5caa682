"""The port's CLIP step over gloo groups against the JAX step on a virtual
mesh of the same shape, with CLIP_TINY in f32 and the same weights
(``params_from_jax``) and global batch: one step at data=2, fsdp=2 (FSDP2)
and data=2 x fsdp=2 (hybrid), data=2 x sp=2 with the sequence-parallel
visual tower, ``loss=siglip`` at data=2, and the cached accumulation step
with ``update_freq=2`` at data=2 and at fsdp=2.  Loss and ``clip_acc`` at
2e-5; ``grad_norm`` and the step's gradients at 5e-5; the updated
parameters at 1e-5, except where JAX's gradient is at f32 noise (below
1e-6) inside the key biases or the token embedding, which are held
within the learning rate.  Then a checkpoint written at world 2 with
sharded state and restored at world 1 bit for bit, SIGTERM to one rank
of ``pretrain_clip.main`` (both ranks checkpoint the same step and exit
0); the eval encoders' rows split over ranks.  (The other entries at
``mesh.sp``: ``test_torch_parallel_sp_entries``.)  Each group runs in spawned
processes with a limit of 60 s (``tests/torch_dist.py``)."""

import io
import json
import os
import os.path as osp
import pickle

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
from avion_tpu.train.steps import (make_clip_accum_train_step as
                                   jax_make_accum_step)
from avion_tpu.train.steps import make_clip_train_step as jax_make_step
from avion_tpu_torch.core.checkpoint import Checkpointer
from avion_tpu_torch.core.config import OptimConfig
from avion_tpu_torch.core.train_state import TrainState
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.optim.factory import build_optimizer

import torch_parallel_workers as workers
from torch_dist import run_ranks

CLIP_TINY = dict(embed_dim=32, image_size=32, patch_size=16, num_frames=2,
                 vision_width=64, vision_layers=2, vision_heads=2,
                 context_length=77, vocab_size=49408, text_width=32,
                 text_heads=2, text_layers=2)
OPT = dict(lr=1e-3, lr_start=1e-4, warmup_epochs=0.5, epochs=1, wd=0.05,
           grad_clip_norm=1.0)
NITER = workers.NITER
LOSS_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
PARAM_TOL = dict(atol=1e-5, rtol=1e-5)
NOISE_GRAD = 1e-6


def _batch(n=8, seed=1):
    rs = np.random.RandomState(seed)
    video = rs.standard_normal((n, 2, 32, 32, 3)).astype(np.float32)
    text = rs.randint(1, 49000, (n, 77)).astype(np.int32)
    text[np.arange(n), rs.randint(2, 77, n)] = 49407
    return {"video": video, "text": text}


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


def _jax_step(jm, params, batch, data, fsdp, update_freq=1, sp=1,
              loss_type="clip", tensor=1):
    mesh = jax_make_mesh(data=data, fsdp=fsdp, tensor=tensor, sp=sp,
                         devices=jax.devices()[:data * fsdp * sp * tensor])
    tx, _ = jax_build_optimizer(JaxOptimConfig(**OPT), params, NITER)
    with jax.set_mesh(mesh):
        state = JaxTrainState.create(
            shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh),
            tx)
        if update_freq > 1:
            step = jax.jit(jax_make_accum_step(jm, tx, update_freq,
                                               loss_type=loss_type))
            host = {k: v.reshape(update_freq, -1, *v.shape[1:])
                    for k, v in batch.items()}
            gb = make_global_batch(mesh, host, batch_dim=1)
        else:
            step = jax.jit(jax_make_step(jm, tx, loss_type=loss_type))
            gb = make_global_batch(mesh, batch)
        state, metrics = step(state, gb, jax.random.PRNGKey(0))
    # the step's clipped gradient, from AdamW's first moment mu = (1 - b1) g
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(s, ScaleByAdamState))
        if isinstance(s, ScaleByAdamState)]
    b1 = JaxOptimConfig(**OPT).betas[0]
    port = lambda tree: {k: v.numpy() for k, v in params_from_jax(  # noqa
        jax.device_get(tree)).items()}
    return ({k: float(v) for k, v in metrics.items()}, port(state.params),
            {k: g / (1 - b1) for k, g in port(adam.mu).items()})


def _noise_allowed(key, shape):
    """Where the step's gradient may sit at f32 rounding: the key third of a
    packed q / k / v bias (its exact gradient is 0, since a key bias shifts
    every score of a query alike) and the token embedding (rows the batch
    touches once)."""
    allowed = np.zeros(shape, bool)
    if key.endswith("attn.Wqkv.bias"):
        w = shape[0] // 3
        allowed[w:2 * w] = True
    elif key == "textual.token_embedding.weight":
        allowed[:] = True
    return allowed


def _compare(ranks, ref_metrics, ref_params, ref_grads):
    for r in ranks:
        for key in ("loss", "clip_acc"):
            np.testing.assert_allclose(r["metrics"][key], ref_metrics[key],
                                       err_msg=key, **LOSS_TOL)
        np.testing.assert_allclose(r["metrics"]["grad_norm"],
                                   ref_metrics["grad_norm"], **GRAD_TOL)
        assert r["metrics"]["step_ok"] == 1.0
    got, grads = ranks[0]["params"], ranks[0]["grads"]
    assert got.keys() == ref_params.keys()
    assert grads.keys() == ref_grads.keys()
    n_noise = 0
    for k, ref in ref_params.items():
        np.testing.assert_allclose(grads[k], ref_grads[k],
                                   err_msg=f"grad {k}", **GRAD_TOL)
        # AdamW's first update is g / (|g| + eps): where the reference
        # step's gradient is at the level of f32 rounding inside the key
        # biases or the token embedding it follows that rounding, and is
        # held to its own bound, the learning rate; every other entry is
        # held to 1e-5, however small its gradient
        noise = (np.abs(ref_grads[k]) < NOISE_GRAD) & _noise_allowed(
            k, ref.shape)
        n_noise += int((noise & (ref_grads[k] != 0)).sum())
        np.testing.assert_allclose(got[k][~noise], ref[~noise], err_msg=k,
                                   **PARAM_TOL)
        np.testing.assert_allclose(got[k][noise], ref[noise], err_msg=k,
                                   atol=OPT["lr"], rtol=0)
    # the key biases alone are 32 entries a layer: the bound is not empty
    assert n_noise >= 32


@pytest.mark.parametrize("data,fsdp", [(2, 1), (1, 2), (2, 2)],
                         ids=["data2", "fsdp2", "data2xfsdp2"])
def test_one_step_over_ranks_matches_jax_mesh(jax_setup, data, fsdp):
    jm, params = jax_setup
    batch = _batch()
    ref_metrics, ref_params, ref_grads = _jax_step(jm, params, batch, data,
                                                   fsdp)
    ranks = run_ranks(workers.train_step, data * fsdp,
                      params_from_jax(params), OPT, batch, data, fsdp, 1)
    _compare(ranks, ref_metrics, ref_params, ref_grads)
    for r in ranks:
        # FSDP2 holds the matrices sharded at rest, moments alike
        assert any(r["sharded"].values()) == (fsdp > 1)
        assert r["moments_sharded"]


@pytest.mark.parametrize("data,fsdp", [(2, 1), (1, 2)],
                         ids=["data2", "fsdp2"])
def test_cached_accumulation_over_ranks_matches_jax(jax_setup, data, fsdp):
    jm, params = jax_setup
    batch = _batch()
    ref_metrics, ref_params, ref_grads = _jax_step(jm, params, batch, data,
                                                   fsdp, update_freq=2)
    host = {k: v.reshape(2, -1, *v.shape[1:]) for k, v in batch.items()}
    ranks = run_ranks(workers.train_step, 2, params_from_jax(params), OPT,
                      host, data, fsdp, 2)
    _compare(ranks, ref_metrics, ref_params, ref_grads)


def test_siglip_step_over_ranks_matches_jax():
    """``loss=siglip`` at data=2: the chunked ring inside the step, the
    learned ``logit_bias`` among the updated parameters."""
    jm = JaxCLIP(**CLIP_TINY, use_flash=False, dtype=jnp.float32,
                 use_logit_bias=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 2, 32, 32, 3)),
                              jnp.zeros((1, 77), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params)
    batch = _batch()
    ref_metrics, ref_params, ref_grads = _jax_step(jm, params, batch, 2, 1,
                                                   loss_type="siglip")
    ranks = run_ranks(workers.train_step, 2, params_from_jax(params), OPT,
                      batch, 2, 1, 1, "siglip")
    assert "logit_bias" in ref_params
    _compare(ranks, ref_metrics, ref_params, ref_grads)


def test_sequence_parallel_step_over_ranks_matches_jax():
    """data=2 x sp=2: each batch group's 4 clips, each rank 4 of the 8
    visual tokens (gap pooling, no CLS token), DDP over the 4 ranks."""
    jm = JaxCLIP(**CLIP_TINY, use_flash=False, dtype=jnp.float32,
                 pooling="gap", sequence_parallel=True)
    with jax.set_mesh(jax_make_mesh(data=8, fsdp=1, tensor=1)):
        params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((8, 2, 32, 32, 3)),
                                  jnp.zeros((8, 77), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params)
    batch = _batch()
    ref_metrics, ref_params, ref_grads = _jax_step(jm, params, batch, 2, 1,
                                                   sp=2)
    ranks = run_ranks(workers.train_step, 4, params_from_jax(params), OPT,
                      batch, 2, 1, 1, "clip", 2)
    _compare(ranks, ref_metrics, ref_params, ref_grads)


def test_eval_encoders_split_rows_over_ranks(jax_setup):
    """5 clips and texts in chunks of 3: each of 2 ranks encodes its block
    of a chunk (the last one padded), the embeddings gathered, as one
    process encodes them (f32, 2e-5)."""
    from avion_tpu_torch.eval.runners import CLIPEncoders
    from avion_tpu_torch.models.registry import create_model

    sd = params_from_jax(jax_setup[1])
    rs = np.random.RandomState(4)
    videos = rs.randint(0, 256, (5, 2, 32, 32, 3)).astype(np.uint8)
    texts = _batch(5)["text"]
    model = create_model("CLIP_TINY", num_frames=2)
    model.load_state_dict(sd, strict=True)
    enc = CLIPEncoders(model, batch=3, weight_dtype="f32")
    want = enc.encode_images(videos), enc.encode_texts(texts)
    for got in run_ranks(workers.encode, 2, sd, videos, texts, 3):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **LOSS_TOL)


def test_checkpoint_saved_at_world_2_restores_at_world_1(jax_setup,
                                                         tmp_path):
    _, params = jax_setup
    sd = params_from_jax(params)
    out = str(tmp_path / "ckpt")
    blob, _ = run_ranks(workers.save_after_step, 2, sd, OPT, _batch(), out)
    saved = torch.load(io.BytesIO(blob), weights_only=True)
    from avion_tpu_torch.models.registry import create_model

    model = create_model("CLIP_TINY", num_frames=2)
    optimizer, _ = build_optimizer(OptimConfig(**OPT), model, NITER)
    state = TrainState.create(model, optimizer)
    restored, extra = Checkpointer(out).restore(state)
    assert restored is state and extra == {"world": 2} and state.step == 1
    got = state.state_dict()
    for k, v in saved["model"].items():
        assert torch.equal(got["model"][k], v), k
    ours, theirs = got["optimizer"]["adamw"], saved["optimizer"]["adamw"]
    assert got["optimizer"]["count"] == saved["optimizer"]["count"] == 1
    assert ours["state"].keys() == theirs["state"].keys()
    for i, moments in theirs["state"].items():
        for name, v in moments.items():
            assert torch.equal(ours["state"][i][name], v), (i, name)
    # the one-process key layout: a params_from_jax state loads strictly
    model.load_state_dict(sd, strict=True)


FPS, CHUNK = 10, 2


@pytest.fixture(scope="module")
def tiny_ego4d(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("ego4d"))
    samples = []
    for v in range(8):
        d = osp.join(root, f"vid{v}.mp4")
        os.makedirs(d)
        for chunk in (0, 2):
            vw = cv2.VideoWriter(osp.join(d, f"{chunk}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), FPS,
                                 (48, 40))
            rs = np.random.RandomState(10 * v + chunk)
            for _ in range(CHUNK * FPS):
                vw.write(rs.randint(0, 256, (40, 48, 3), np.uint8))
            vw.release()
        samples.append((f"vid{v}", 0.3, 3.5, f"does action number {v}"))
    meta = osp.join(root, "meta.pkl")
    with open(meta, "wb") as f:
        pickle.dump(samples * 2, f)  # 16 rows: 2 global batches of 8
    return root, meta


def test_sigterm_to_one_rank_checkpoints_both(tiny_ego4d, tmp_path):
    root, meta = tiny_ego4d
    out = str(tmp_path / "run")
    args = ["model.name=CLIP_TINY", f"data.root={root}",
            f"data.train_metadata={meta}", f"data.chunk_len={CHUNK}",
            f"data.fps={FPS}", "data.clip_length=2", "data.crop_size=32",
            "data.decode_size=40", "data.batch_size=8", "data.num_workers=0",
            "optim.epochs=1", "optim.lr=1e-3", "optim.warmup_epochs=0",
            "mesh.data=2", f"output_dir={out}", "print_freq=1", "--device",
            "cpu"]
    ranks = run_ranks(workers.preempted_main, 2, args)
    # rank 1 alone was signalled after step 1; both stopped before step 2
    assert ranks == [{"step": 1, "steps": 1}] * 2
    ckpt = osp.join(out, "ckpt")
    assert Checkpointer(ckpt).steps() == [1]
    with open(osp.join(ckpt, "1", "extra.json")) as f:
        assert json.load(f)["batch_in_epoch"] == 1
    # one writer: one log, of rank 0's steps
    with open(osp.join(out, "log.jsonl")) as f:
        assert sum("train/loss" in line for line in f) == 1
