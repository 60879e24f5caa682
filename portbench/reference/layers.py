"""Plain pre-LN transformer blocks over a dict of f32 weights.

Weights are named as in the reference's torch layout (``ln_1``,
``attn.Wqkv``, ``attn.out_proj``, ``mlp.fc1``, ``mlp.fc2``): a dense
weight is ``[out, in]``, the fused projection's rows are ``[q | k | v]``
with each head's ``head_dim`` rows together.  Attention is written out:
scores, mask, softmax, weighted sum, each materialized.  ``mm`` is the
matrix product (``precision.matmul_for``).  LayerNorm's eps is 1e-5 in
every tower, as in the port's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    # OpenAI CLIP's QuickGELU
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu": lambda x: F.gelu(x),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def dense(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str,
          mm: Callable) -> torch.Tensor:
    y = mm(x, w[f"{name}.weight"].t())
    bias = w.get(f"{name}.bias")
    return y if bias is None else y + bias


def layer_norm(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str,
               eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"],
                        w[f"{name}.bias"], eps)


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor], prefix: str,
              heads: int, causal: bool, mm: Callable) -> torch.Tensor:
    b, s, width = x.shape
    d = width // heads
    qkv = dense(x, w, f"{prefix}.Wqkv", mm)
    q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2)
               for t in qkv.split(width, dim=-1))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~keep, -math.inf)
    out = mm(scores.softmax(dim=-1), v)
    return dense(out.transpose(1, 2).reshape(b, s, width), w,
                 f"{prefix}.out_proj", mm)


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], prefix: str,
          heads: int, causal: bool, act: Callable, mm: Callable
          ) -> torch.Tensor:
    x = x + attention(layer_norm(x, w, f"{prefix}.ln_1"), w, f"{prefix}.attn",
                      heads, causal, mm)
    h = act(dense(layer_norm(x, w, f"{prefix}.ln_2"), w, f"{prefix}.mlp.fc1",
                  mm))
    return x + dense(h, w, f"{prefix}.mlp.fc2", mm)


def stack(x: torch.Tensor, w: Dict[str, torch.Tensor], prefix: str,
          layers: int, heads: int, causal: bool, act: Callable, mm: Callable
          ) -> torch.Tensor:
    """``layers`` blocks ``<prefix>.<i>``."""
    for i in range(layers):
        x = block(x, w, f"{prefix}.{i}", heads, causal, act, mm)
    return x


def block_spec(prefix: str, width: int, mlp_ratio: int = 4) -> list:
    """(name, shape, kind, scale) of one block's weights (``weights.make``)."""
    hidden = mlp_ratio * width
    return [
        (f"{prefix}.ln_1.weight", (width,), "one_plus", 0.1),
        (f"{prefix}.ln_1.bias", (width,), "normal", 0.02),
        (f"{prefix}.attn.Wqkv.weight", (3 * width, width), "normal",
         width ** -0.5),
        (f"{prefix}.attn.Wqkv.bias", (3 * width,), "normal", 0.02),
        (f"{prefix}.attn.out_proj.weight", (width, width), "normal",
         width ** -0.5),
        (f"{prefix}.attn.out_proj.bias", (width,), "normal", 0.02),
        (f"{prefix}.ln_2.weight", (width,), "one_plus", 0.1),
        (f"{prefix}.ln_2.bias", (width,), "normal", 0.02),
        (f"{prefix}.mlp.fc1.weight", (hidden, width), "normal", width ** -0.5),
        (f"{prefix}.mlp.fc1.bias", (hidden,), "normal", 0.02),
        (f"{prefix}.mlp.fc2.weight", (width, hidden), "normal",
         hidden ** -0.5),
        (f"{prefix}.mlp.fc2.bias", (width,), "normal", 0.02),
    ]
