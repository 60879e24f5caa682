"""The port's contrastive losses over gloo groups of 2 and 4 ranks against
the JAX package's on the global batch: ``clip_loss`` and ``siglip_loss``
(gathered, a summing backward) and ``siglip_loss_chunked`` (the ring).
Loss and ``clip_acc`` at 2e-5; the gradient of each rank's embeddings
(divided by the group's size, as DDP averages) and of the logit scale and
bias (averaged over the ranks) at 5e-5, the tolerances of
``tests/test_sequence_parallel.py``.  The chunked ring is also held
against JAX's ``siglip_loss_chunked`` on the conftest's 8-device mesh.
Each group runs in spawned processes with a 60 s limit
(``tests/torch_dist.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avion_tpu.losses.losses import clip_loss, siglip_loss, siglip_loss_chunked

import torch_parallel_workers as workers
from torch_dist import run_ranks

B, DIM = 8, 16
LOSS_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
SCALE_PARAM, BIAS = np.float32(np.log(1 / 0.07)), np.float32(-3.0)


def _unit(rs):
    x = rs.standard_normal((B, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    return _unit(rs), _unit(rs)


@pytest.fixture(scope="module")
def port(inputs):
    """Every loss over 2 and over 4 ranks, one group each."""
    img, txt = inputs
    return {w: run_ranks(workers.losses, w, img, txt, SCALE_PARAM, BIAS)
            for w in (2, 4)}


def _jax(name, img, txt):
    def f(i, t, p, b):
        if name == "clip":
            return clip_loss(i, t, jnp.exp(p))
        return siglip_loss(i, t, jnp.exp(p), b)

    (loss, res), grads = jax.value_and_grad(
        lambda *a: (f(*a)["loss"], f(*a)), argnums=(0, 1, 2, 3),
        has_aux=True)(jnp.asarray(img), jnp.asarray(txt),
                      jnp.float32(SCALE_PARAM), jnp.float32(BIAS))
    return float(loss), float(res["clip_acc"]), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["clip", "siglip", "siglip_chunked"])
def test_loss_over_ranks_matches_jax_global_batch(port, inputs, name, world):
    img, txt = inputs
    loss, acc, (d_img, d_txt, d_scale, d_bias) = _jax(
        "clip" if name == "clip" else "siglip", img, txt)
    ranks = [r[name] for r in port[world]]
    per = B // world
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["loss"], loss, **LOSS_TOL)
        np.testing.assert_allclose(r["clip_acc"], acc, **LOSS_TOL)
        rows = slice(rank * per, (rank + 1) * per)
        np.testing.assert_allclose(r["d_img"] / world, d_img[rows],
                                   err_msg=f"d_img rank {rank}", **GRAD_TOL)
        np.testing.assert_allclose(r["d_txt"] / world, d_txt[rows],
                                   err_msg=f"d_txt rank {rank}", **GRAD_TOL)
    np.testing.assert_allclose(np.mean([r["d_scale"] for r in ranks]),
                               d_scale, **GRAD_TOL)
    if name != "clip":
        np.testing.assert_allclose(np.mean([r["d_bias"] for r in ranks]),
                                   d_bias, **GRAD_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_chunked_ring_matches_jax_ring_on_mesh8(port, inputs, mesh8, world):
    img, txt = inputs
    with jax.set_mesh(mesh8):
        ref = siglip_loss_chunked(jnp.asarray(img), jnp.asarray(txt),
                                  jnp.exp(jnp.float32(SCALE_PARAM)),
                                  jnp.float32(BIAS), mesh=mesh8)
    for r in port[world]:
        np.testing.assert_allclose(r["siglip_chunked"]["loss"],
                                   float(ref["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(r["siglip_chunked"]["clip_acc"],
                                   float(ref["clip_acc"]), **LOSS_TOL)
