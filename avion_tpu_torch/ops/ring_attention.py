"""Ring attention over the ``sp`` process group
(``avion_tpu.ops.ring_attention``).

Each rank of the group holds one sequence shard of q, k and v; the k / v
shards rotate around the ring (rank r sends to r + 1 and receives from
r - 1, ``dist.batch_isend_irecv``: NCCL for CUDA tensors, gloo for CPU
ones) while each rank merges its queries' partial attention hop by hop.

- :func:`ring_flash_attention_packed` runs the hand-written kernels on
  every hop through the hop ops of ``ops.flash_attention`` (plain PyTorch
  for CPU tensors).  Forward: hop 0 is the diagonal block, causal in-block
  and without bias; hops 1 .. n-1 take the neighbour's [B, S, 2W] k / v
  buffer and the hop's score bias (:func:`ring_hop_bias`: the mask value
  -1e30 voids a hop of future keys under ``causal``), and the (out, lse)
  pairs merge in f32 (:func:`merge_partial`).  Backward: a second ring on
  the global out and lse; with P = exp2(s - lse_global) each hop's dq, dk,
  dv are exactly that hop's columns of the global softmax gradient, so dq
  sums locally, the f32 dk / dv accumulators ride the ring with k / v and
  one last rotation brings them home.  Every hop is launched, masked ones
  too, as the JAX ring does.
- :func:`sequence_parallel_attention`: the same on [B, S_local, H, D]
  shards.

The ring bodies are generators that yield what they send and receive what
the previous rank sent: :func:`run_ring` steps one body per process over a
process group, :func:`run_ring_local` steps the bodies of all n shards in
one process in turn (``chip_smoke.py`` holds that against attention over
the whole sequence on one card).
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from avion_tpu_torch.ops import flash_attention as fa

DEFAULT_MASK_VALUE = -1e30


def group_rank_size(group) -> tuple:
    """(rank in ``group``, its size); (0, 1) without a group."""
    if group is None or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def rotate(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each tensor to the next rank of ``group``'s ring and receive the
    previous rank's, in one batch of point-to-point operations."""
    rank, n = group_rank_size(group)
    if n == 1:
        return list(tensors)
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    sent = [t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in sent]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in sent]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def run_ring(body: Iterator, group):
    """Step one ring body (a generator) over ``group``: what it yields goes
    to the next rank, what the previous rank yielded comes back; returns
    the body's return value."""
    try:
        sent = next(body)
        while True:
            sent = body.send(rotate(sent, group))
    except StopIteration as stop:
        return stop.value


def run_ring_local(bodies: List[Iterator]) -> list:
    """Step the ring bodies of all n shards in one process, hop by hop:
    shard i receives what shard i - 1 yielded.  Returns their results."""
    n = len(bodies)
    if n == 1:  # no hop to exchange
        return [run_ring(bodies[0], None)]
    results: list = [None] * n
    live = True
    sent = [next(b) for b in bodies]
    while live:
        got = [sent[(i - 1) % n] for i in range(n)]
        for i, b in enumerate(bodies):
            try:
                sent[i] = b.send(got[i])
            except StopIteration as stop:
                results[i] = stop.value
                live = False
    return results


def ring_hop_bias(j: int, i: int, causal: bool) -> float:
    """Score bias of hop ``j`` on ring position ``i``: hop j holds the keys
    of position i - j (mod n), which follow this position's queries exactly
    when j > i; those are voided under ``causal``."""
    return DEFAULT_MASK_VALUE if causal and j > i else 0.0


def merge_partial(o_a: torch.Tensor, lse_a: torch.Tensor, o_b: torch.Tensor,
                  lse_b: torch.Tensor, heads: int) -> tuple:
    """Online merge of two normalized partial outputs [B, S, W] (f32) with
    their log2-domain logsumexps [B, H, S] (``_merge_packed``)."""
    m = torch.maximum(lse_a, lse_b)
    ea, eb = torch.exp2(lse_a - m), torch.exp2(lse_b - m)
    lse = m + torch.log2(ea + eb)
    b, s, w = o_a.shape

    def weighted(o, e):
        wt = (e / (ea + eb)).transpose(1, 2)[..., None]  # [B, S, H, 1]
        return (o.view(b, s, heads, w // heads) * wt).view(b, s, w)

    return weighted(o_a, ea) + weighted(o_b, eb), lse


def ring_forward_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int, causal: bool, sm_scale: float, index: int,
                      n: int):
    """The forward of ring position ``index`` of ``n``: yields the k / v
    buffer it sends, receives the previous position's; returns (out in q's
    dtype, lse [B, H, S] f32)."""
    w = q.shape[-1]
    out, lse = fa.flash_hop_fwd(q, k, v, heads, causal, sm_scale, 0.0)
    if n == 1:
        return out, lse
    out = out.float()
    kv = torch.cat([k, v], dim=-1)  # one [B, S, 2W] buffer a hop
    for j in range(1, n):
        (kv,) = yield (kv,)
        o_j, lse_j = fa.flash_hop_fwd(q, kv[..., :w], kv[..., w:], heads,
                                      False, sm_scale,
                                      ring_hop_bias(j, index, causal))
        out, lse = merge_partial(out, lse, o_j.float(), lse_j, heads)
    return out.to(q.dtype), lse


def ring_backward_body(g: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                       heads: int, causal: bool, sm_scale: float, index: int,
                       n: int):
    """The backward of ring position ``index`` on the global ``out`` and
    ``lse``: yields (k / v buffer, its f32 dk / dv accumulator) and
    receives the previous position's; after the last hop one more rotation
    brings each accumulator home.  Returns (dq, dk, dv) in q's dtype."""
    w = q.shape[-1]
    d = fa.flash_hop_bwd(g, q, k, v, out, lse, heads, causal, sm_scale, 0.0)
    dq, dkv = d[..., :w], d[..., w:].contiguous()  # f32, as every hop's
    kv = torch.cat([k, v], dim=-1)
    for j in range(1, n):
        kv, dkv = yield (kv, dkv)
        d = fa.flash_hop_bwd(g, q, kv[..., :w], kv[..., w:], out, lse, heads,
                             False, sm_scale, ring_hop_bias(j, index, causal))
        dq = dq + d[..., :w]
        dkv = dkv + d[..., w:]
    if n > 1:
        (dkv,) = yield (dkv,)
    return (dq.to(q.dtype), dkv[..., :w].to(k.dtype),
            dkv[..., w:].to(v.dtype))


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, causal, sm_scale, group):
        index, n = group_rank_size(group)
        q, k, v = (x.contiguous() for x in (q, k, v))
        out, lse = run_ring(ring_forward_body(q, k, v, heads, causal,
                                              sm_scale, index, n), group)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (heads, causal, sm_scale, index, n, group)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        heads, causal, sm_scale, index, n, group = ctx.args
        dq, dk, dv = run_ring(ring_backward_body(
            g.contiguous(), q, k, v, out, lse, heads, causal, sm_scale,
            index, n), group)
        return dq, dk, dv, None, None, None, None


def sp_group(group=None):
    """``group``, else the current mesh's ``sp`` group (None without a
    mesh)."""
    if group is not None:
        return group
    from avion_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    return None if mesh is None else mesh.sp_group


def ring_flash_attention_packed(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int, *, group=None,
                                causal: bool = False,
                                sm_scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Ring attention with the flash kernels on every hop, packed
    [B, S_local, H*D] in and out, differentiable in q, k and v.  ``group``
    defaults to the current mesh's ``sp`` group (none: one shard)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    return _RingFlash.apply(q, k, v, heads, causal, float(sm_scale),
                            sp_group(group))


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, group=None,
                                causal: bool = False,
                                sm_scale: Optional[float] = None
                                ) -> torch.Tensor:
    """:func:`ring_flash_attention_packed` on the local [B, S_local, H, D]
    shards of q, k, v over the ``sp`` group (default the current mesh's)."""
    b, s, h, d = q.shape
    o = ring_flash_attention_packed(
        *(x.reshape(b, s, h * d) for x in (q, k, v)), h, group=group,
        causal=causal, sm_scale=sm_scale)
    return o.reshape(b, s, h, d)
