"""Model FLOPs and the attention kernels' least time, from shapes alone.

One convention for every cell: a train step costs 3 x its forward's matrix
products (the forward, and the backward's two products per forward
product); a dense layer's forward is 2 x tokens x in x out, an attention
layer's is 4 x B x S^2 x H x D (scores and weighted sum; not halved when
causal), so its step is 12 B H S^2 D.  Rematerialization's second forward
is not counted.  Vector work (norms, activations, softmax, the optimizer)
counts nothing.

The attention kernels' least time (:func:`attention_least_s`) is the
larger of the products at the bf16 peak and the bytes at the HBM rate,
each [B, S, H*D] bf16 tensor read or written once and each [B, H, S] f32
row once: the forward takes q, k, v, writes out and its log-sum-exp (2
products); the backward reads q, k, v, out, dout and the log-sum-exp and
writes dq, dk, dv (5 products).  A causal layer needs half the products.
Peaks: one NVIDIA H100 SXM, its data sheet's dense bf16 rate and HBM3
rate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
TRAIN_FACTOR = 3


def dense_flops(tokens: int, n_in: int, n_out: int) -> int:
    return 2 * tokens * n_in * n_out


def attention_fwd_flops(b: int, s: int, heads: int, head_dim: int) -> int:
    return 4 * b * s * s * heads * head_dim


@dataclass(frozen=True)
class AttentionLayers:
    """``layers`` attention layers of one shape in a step."""

    batch: int
    seq: int
    heads: int
    head_dim: int
    causal: bool
    layers: int


@dataclass
class StepWork:
    """A train step's forward FLOPs and its attention layers."""

    forward_flops: int = 0
    attention: List[AttentionLayers] = field(default_factory=list)

    @property
    def model_flops(self) -> int:
        return TRAIN_FACTOR * self.forward_flops

    def add_dense(self, tokens: int, n_in: int, n_out: int) -> None:
        self.forward_flops += dense_flops(tokens, n_in, n_out)

    def add_tower(self, batch: int, seq: int, width: int, layers: int,
                  heads: int, causal: bool, mlp_ratio: int = 4) -> None:
        """``layers`` pre-LN blocks: qkv, out, fc1 and fc2 over every
        token, and the attention."""
        per_block = dense_flops(batch * seq, width, (3 + 1 + 2 * mlp_ratio)
                                * width)
        self.forward_flops += layers * (per_block + attention_fwd_flops(
            batch, seq, heads, width // heads))
        self.attention.append(AttentionLayers(batch, seq, heads,
                                              width // heads, causal, layers))


def attention_least_s(b: int, s: int, heads: int, head_dim: int,
                      causal: bool, products: int, tensors: int,
                      rows: int) -> Tuple[float, str]:
    """(seconds, ``"operations"`` or ``"bytes"``): ``products`` S x S x D
    products at :data:`PEAK_FLOPS` against ``tensors`` [B, S, H*D] bf16
    tensors and ``rows`` [B, H, S] f32 rows at :data:`PEAK_BYTES_PER_S`."""
    flops = 2 * products * b * heads * s * s * head_dim / (2 if causal else 1)
    nbytes = tensors * b * s * heads * head_dim * 2 + rows * b * heads * s * 4
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_step_least_s(layers: List[AttentionLayers]) -> float:
    """The least time of every attention layer's forward and backward in
    one train step."""
    total = 0.0
    for a in layers:
        fwd, _ = attention_least_s(a.batch, a.seq, a.heads, a.head_dim,
                                   a.causal, products=2, tensors=4, rows=1)
        bwd, _ = attention_least_s(a.batch, a.seq, a.heads, a.head_dim,
                                   a.causal, products=5, tensors=8, rows=1)
        total += a.layers * (fwd + bwd)
    return total
