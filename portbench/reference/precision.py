"""The reference's matrix products, in the precision a comparison asks for.

- ``float32``: plain f32 products.  :func:`strict_float32` turns TF32 off
  for products and convolutions, so an f32 product on the card is f32.
- ``fp8``: the control.  Both operands of every product are rounded to
  float8 e4m3 with a per-tensor scale (the tensor's largest magnitude maps
  to 448, e4m3's largest finite value), then multiplied in f32: the step
  below the bf16 products the configuration states.  The rounding is seen
  by the forward only; the backward takes the rounded operands the product
  saved, with the rounding's gradient taken as the identity.
"""

from __future__ import annotations

from typing import Callable

import torch

E4M3_MAX = 448.0


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in f32;
    its gradient passes unchanged."""
    scale = E4M3_MAX / x.detach().abs().amax().clamp_min(1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()


def matmul_for(precision: str) -> Callable:
    if precision == "float32":
        return torch.matmul
    if precision == "fp8":
        return lambda a, b: torch.matmul(round_e4m3(a), round_e4m3(b))
    raise ValueError(f"unknown precision {precision!r}")
