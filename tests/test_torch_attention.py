"""The port's attention (plain path, CPU) against the JAX package: the
Pallas fused-qkv kernel run in interpret mode, and ``xla_attention``.
f32 throughout, atol = rtol = 2e-5 (the JAX f32 forward tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.ops.attention import xla_attention as jax_xla_attention
from avion_tpu.ops.flash_attention import flash_attention_fused_qkv as jax_fused
from avion_tpu_torch.ops.flash_attention import flash_attention_fused_qkv

TOL = dict(atol=2e-5, rtol=2e-5)


def _fused(b, s, h, d, seed):
    """[B, S_pad, 3W] with S_pad the next multiple of 128 (the JAX fused
    entry's contract); pad rows hold large finite garbage."""
    rs = np.random.RandomState(seed)
    s_pad = (s + 127) // 128 * 128
    qkv = np.full((b, s_pad, 3 * h * d), 37.5, np.float32)
    qkv[:, :s] = rs.standard_normal((b, s, 3 * h * d))
    return qkv


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("heads", [2, 3])
@pytest.mark.parametrize("s", [77, 130, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_qkv_matches_pallas_and_xla(causal, s, heads, d):
    qkv = _fused(1, s, heads, d, seed=s + heads + d)
    got = flash_attention_fused_qkv(torch.from_numpy(qkv), heads, s,
                                    causal=causal).numpy()
    assert got.shape == (1, s, heads * d)
    pallas = np.asarray(jax_fused(jnp.asarray(qkv), heads, s, causal=causal,
                                  interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    w = heads * d
    q, k, v = (jnp.asarray(qkv[:, :s, i * w:(i + 1) * w]).reshape(
        1, s, heads, d) for i in range(3))
    ref = np.asarray(jax_xla_attention(q, k, v, causal=causal))
    np.testing.assert_allclose(got, ref.reshape(1, s, w), **TOL)


def test_fused_qkv_keeps_bf16_dtype_on_cpu():
    qkv = torch.from_numpy(_fused(2, 77, 2, 64, seed=0)).to(torch.bfloat16)
    out = flash_attention_fused_qkv(qkv, 2, 77, causal=True)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 77, 128)
    ref = flash_attention_fused_qkv(qkv.float(), 2, 77, causal=True)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2,
                               rtol=3e-2)
