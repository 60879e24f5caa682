"""The port's mixed-precision policy (``avion_tpu_torch.core.policy``)
against the JAX package's (``avion_tpu.core.policy``): each cast of each
policy gives the same dtype and the same values on the same numpy input
(bit for bit: both round float32 to bfloat16 to nearest even), the policy
names resolve alike, and the package re-exports it as JAX's does."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from avion_tpu.core import policy as jp
from avion_tpu_torch.core import policy as tp

CASTS = ("cast_to_compute", "cast_to_param", "cast_to_output")
DTYPES = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}


def _numpy(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


@pytest.mark.parametrize("name", ["DEFAULT_POLICY", "FP32_POLICY"])
@pytest.mark.parametrize("cast", CASTS)
def test_policy_casts_match_jax(name, cast):
    x = np.random.RandomState(0).standard_normal((4, 33)).astype(np.float32)
    x[0, :4] = [1e30, -1e-30, 3.0039062, np.inf]  # overflow, ties, inf
    want = np.asarray(getattr(getattr(jp, name), cast)(x))
    got = getattr(getattr(tp, name), cast)(x)
    assert DTYPES[got.dtype] == want.dtype
    np.testing.assert_array_equal(_numpy(got), want)
    # a tensor in, as the port's callers pass
    np.testing.assert_array_equal(
        _numpy(getattr(getattr(tp, name), cast)(torch.from_numpy(x))), want)


@pytest.mark.parametrize("alias", ["bf16", "BFloat16", "mixed", "fp32",
                                   "float32", "full"])
def test_policy_names_match_jax(alias):
    want, got = jp.get_policy(alias), tp.get_policy(alias)
    for field in ("param_dtype", "compute_dtype", "norm_dtype",
                  "output_dtype"):
        assert DTYPES[getattr(got, field)] == jnp.dtype(getattr(want, field))


def test_unknown_policy_raises_as_jax():
    with pytest.raises(ValueError, match="unknown precision policy"):
        jp.get_policy("fp16")
    with pytest.raises(ValueError, match="unknown precision policy"):
        tp.get_policy("fp16")


def test_core_reexports_the_policy():
    import avion_tpu_torch.core as core

    assert core.Policy is tp.Policy
    assert core.DEFAULT_POLICY is tp.DEFAULT_POLICY
    assert core.DEFAULT_POLICY == tp.Policy()
