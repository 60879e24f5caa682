"""The port's losses against the JAX package's, f32 at 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.losses.losses import clip_loss as jax_clip_loss
from avion_tpu.losses.losses import softmax_cross_entropy as jax_ce
from avion_tpu_torch.losses.losses import clip_loss, softmax_cross_entropy

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy(smoothing):
    rs = np.random.RandomState(0)
    logits = (3 * rs.standard_normal((16, 10))).astype(np.float32)
    labels = rs.randint(0, 10, 16)
    got = softmax_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), smoothing)
    ref = jax_ce(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    np.testing.assert_allclose(got.item(), float(ref), **TOL)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_clip_loss(smoothing):
    rs = np.random.RandomState(1)
    img = _unit(rs.standard_normal((8, 32))).astype(np.float32)
    txt = _unit(img + 0.7 * rs.standard_normal((8, 32))).astype(np.float32)
    scale = np.float32(1 / 0.07)
    got = clip_loss(torch.from_numpy(img), torch.from_numpy(txt),
                    torch.tensor(scale), smoothing)
    ref = jax_clip_loss(jnp.asarray(img), jnp.asarray(txt), scale, smoothing)
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]), **TOL)
    np.testing.assert_allclose(got["clip_acc"].item(), float(ref["clip_acc"]),
                               **TOL)


def test_clip_loss_gradient_reaches_scale_and_embeddings():
    img = torch.nn.functional.normalize(torch.randn(4, 8), dim=-1)
    txt = torch.nn.functional.normalize(torch.randn(4, 8), dim=-1)
    img.requires_grad_()
    scale = torch.tensor(10.0, requires_grad=True)
    clip_loss(img, txt, scale)["loss"].backward()
    assert img.grad.abs().sum() > 0 and scale.grad.abs() > 0
