"""The port's head-split ablation (``avion_tpu_torch.tools.
headdim_ablation``) against the JAX tool's: the numpy pieces
(``synth_concepts``, ``noisy_clip``, ``make_batches``) give equal arrays
for the same seeds, and ``run_arm`` trains both arms (width 64, 1 layer,
3 steps, heads 2 and 1) from JAX's initial tree (through
``params_from_jax``) on the same batches to the JAX arm's losses.  Both
arms compute in bf16 (the JAX tool's ``dtype=jnp.bfloat16``, the port's
bf16 CLIP), which round at different places (the port's attention runs in
f32 on the CPU, XLA's in bf16), so each loss is held to 2% relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avion_tpu.data.tokenizer import tokenize
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.tools import headdim_ablation as jh
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.tools import headdim_ablation as th

GEOMETRY = dict(width=64, layers=1, frames=2, size=32, patch=16)
LOSS_RTOL = 2e-2


@pytest.mark.parametrize("overlap", [0.0, 0.4])
def test_concepts_and_batches_equal_jax(overlap):
    want = jh.synth_concepts(np.random.RandomState(3), 5, 2, 32,
                             overlap=overlap)
    got = th.synth_concepts(np.random.RandomState(3), 5, 2, 32,
                            overlap=overlap)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(
        th.noisy_clip(np.random.RandomState(4), want[0][1], 25.0),
        jh.noisy_clip(np.random.RandomState(4), want[0][1], 25.0))
    texts = np.stack([tokenize(c) for c in want[1]]).astype(np.int32)
    for batch in (3, 8):  # without and with replacement
        a = jh.make_batches(7, want[0], texts, 3, batch, 25.0)
        b = th.make_batches(7, want[0], texts, 3, batch, 25.0)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["video"], y["video"])
            np.testing.assert_array_equal(x["text"], y["text"])


@pytest.fixture(scope="module")
def shared():
    """JAX's shared initial tree at the test geometry, the concepts and
    the batch schedule (4 concepts, batch 4, 3 steps)."""
    rng = np.random.RandomState(0)
    protos, captions = jh.synth_concepts(rng, 4, GEOMETRY["frames"],
                                         GEOMETRY["size"])
    texts = np.stack([tokenize(c) for c in captions]).astype(np.int32)
    batches = jh.make_batches(1, protos, texts, 3, 4, 25.0)
    w, layers = GEOMETRY["width"], GEOMETRY["layers"]
    ref = JaxCLIP(embed_dim=w, image_size=GEOMETRY["size"],
                  patch_size=GEOMETRY["patch"],
                  num_frames=GEOMETRY["frames"], vision_width=w,
                  vision_layers=layers, vision_heads=2, text_width=w,
                  text_heads=2, text_layers=layers, use_flash=False,
                  dtype=jnp.bfloat16)
    params = jax.device_get(ref.init(
        jax.random.PRNGKey(0),
        jnp.zeros((2, GEOMETRY["frames"], 32, 32, 3), jnp.float32),
        jnp.zeros((2, 77), jnp.int32))["params"])
    return params, protos, texts, batches


@pytest.mark.parametrize("heads", [2, 1], ids=["d32", "d64"])
def test_run_arm_matches_jax(shared, heads):
    params, protos, texts, batches = shared
    kw = dict(batches=batches, protos=protos, texts=texts,
              heldout_per_concept=2, sigma=25.0, lr=1e-3, **GEOMETRY)
    want = jh.run_arm(heads, init_params=params, use_flash=False, **kw)
    got = th.run_arm(heads, init_state=params_from_jax(params),
                     device="cpu", **kw)
    assert got["heads"] == want["heads"]
    assert got["head_dim"] == want["head_dim"]
    for key in ("first_loss", "final_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                   err_msg=key)
    assert got["losses"][-1] < got["losses"][0]  # the arm trains
    assert 0.0 <= got["heldout_top1"] <= 1.0
