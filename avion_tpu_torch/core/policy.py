"""Mixed-precision policy (``avion_tpu.core.policy``).

Compute in bfloat16, which has float32's exponent range, so no loss
scaling is needed (the reference's ``torch.cuda.amp.autocast`` +
``GradScaler``): parameters and optimizer state stay float32, activations
and matmuls are bfloat16, LayerNorm and softmax reduce in float32
(``norm_dtype``).  The casts take tensors or anything ``torch.as_tensor``
takes.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    norm_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.compute_dtype)

    def cast_to_param(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.param_dtype)

    def cast_to_output(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.output_dtype)


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def get_policy(name: str) -> Policy:
    name = name.lower()
    if name in ("bf16", "bfloat16", "mixed"):
        return DEFAULT_POLICY
    if name in ("fp32", "float32", "full"):
        return FP32_POLICY
    raise ValueError(f"unknown precision policy: {name!r}")
