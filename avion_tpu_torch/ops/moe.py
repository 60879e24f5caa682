"""Mixture-of-experts MLP over the ``ep`` mesh axis (``avion_tpu.ops.moe``).

A drop-in for a block's MLP that routes each token to its top-k experts:
GShard's dispatch / combine construction (one-hot capacity buckets, batched
expert products, gated combine), with the JAX module's names, parameters
and numbers.

- Parameters: ``router`` (an f32 ``nn.Linear``), and ``expert_fc1`` [E, W,
  H], ``expert_fc1_bias`` [E, H], ``expert_fc2`` [E, H, W],
  ``expert_fc2_bias`` [E, W], stacked over experts in the flax layout
  (``x @ w``).
- Routing: top-k of an f32 softmax (ties to the lower expert, as
  ``jax.lax.top_k``), the selected gates renormalized.
  Tokens are routed in groups of ``g = min(group_size, T)`` (GShard's
  grouping; the tail group is padded with zero tokens, which route like
  real ones, and their outputs are dropped).  An expert takes at most
  ``_capacity(g, ...)`` tokens of a group; positions come from a cumsum in
  token order, later k-slots seeing the occupancy of earlier ones, and a
  token past capacity falls through the residual.
- Losses: the load-balancing ``aux = sum(density * mean prob) * E`` over
  the top-1 assignment, and the router z-loss ``mean(logsumexp(logits) **
  2)``; stats ``expert_load`` (the kept assignments' share by expert) and
  ``overflow`` (the wanted assignments dropped).  A forward leaves them on
  the module (:attr:`MoEMlp.aux`, ``zloss``, ``load``, ``overflow``), where
  the train step collects them (:func:`moe_outputs`); there is no flax
  ``sow``.

Over ranks (set by ``parallel.sharding.shard_model``):

- ``data`` / ``fsdp``: JAX routes the global batch's tokens, ``[B * S]`` in
  row order, so a group may straddle two ranks' rows.  Each rank places
  its tokens at their global offset in the groups it touches; per k-slot
  the ranks of the batch group all-gather their per-group, per-expert
  counts (``[groups, E]``), from which a rank takes the positions of the
  earlier ranks' tokens of a shared group and every group's occupancy.
  Only the last rank pads the global tail group.  The aux loss, the z-loss
  and the stats are means over the global (padded) tokens, their sums
  all-reduced with a summing backward (each rank's loss is the global one,
  and the gradient average over the ranks is then its gradient).
- ``ep``: as JAX, the tokens are replicated over ``ep`` and only the expert
  dim is cut (``parallel.sharding``: expert leaves dim 0 over ``ep``).
  Router, masks and losses are computed alike on every ``ep`` rank; the
  dispatched ``[E, G, C, W]`` passes Megatron's "f" (identity; the
  backward sums over ``ep``), each rank runs its E / ep experts, and their
  outputs are all-gathered (the backward keeps this rank's block: every
  rank's cotangent is the same) and combined on every rank.  So the
  router's gradient and the aux loss count once on every rank, and no
  ``all_to_all`` is needed for JAX's numbers.

:func:`run_experts_local` plays the ``ep`` ranks in one process.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from avion_tpu_torch.ops.ring_attention import group_rank_size, sp_group
from avion_tpu_torch.parallel.tensor_parallel import _CopyToTensor


def _capacity(group: int, experts: int, top_k: int,
              capacity_factor: float) -> int:
    """Per-expert slots per group: ``top_k * group / experts`` at
    ``capacity_factor`` headroom, at least 4 and a multiple of 4."""
    cap = int(group * top_k * capacity_factor / experts)
    return max(4, ((cap + 3) // 4) * 4)


class _SumOver(torch.autograd.Function):
    """The sum over ``group``; the backward sums the cotangents too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherExperts(torch.autograd.Function):
    """The ``ep`` ranks' expert outputs concatenated along dim 0; the
    backward keeps this rank's block (every rank's cotangent is the
    same, so nothing is summed)."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, 0)[dist.get_rank(ctx.group)].contiguous(), None


class _GatherSequence(torch.autograd.Function):
    """The ``sp`` ranks' token slices concatenated along dim 1 (sequence
    order); the backward sums the gradient over the group and keeps this
    rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, 1)[dist.get_rank(ctx.group)].contiguous(), None


class _Batch:
    """The batch group a MoE layer routes over: its size, this rank's
    index, and the collectives of the routing (identities without a
    group)."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the group of a statistic (no gradient)."""
        if self.size == 1:
            return x
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x

    def sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the group with a summing backward."""
        return x if self.size == 1 else _SumOver.apply(x, self.group)

    def counts(self, counts: torch.Tensor):
        """(the ranks before this one's sum, every rank's sum) of a
        ``[groups, E]`` count."""
        if self.size == 1:
            return torch.zeros_like(counts), counts
        parts = [torch.empty_like(counts) for _ in range(self.size)]
        dist.all_gather(parts, counts.contiguous(), group=self.group)
        stacked = torch.stack(parts)
        return stacked[:self.rank].sum(0), stacked.sum(0)


def _route(logits: torch.Tensor, top_k: int, capacity: int,
           owned: Optional[torch.Tensor], first: int, n_groups: int,
           tokens: int, batch: _Batch):
    """Dispatch and combine masks of the groups ``[first, first + n)`` this
    rank touches: ``logits`` [n, g, E] f32 at the tokens' global places,
    ``owned`` [n, g] (None: all) the places of this rank's tokens,
    ``n_groups`` and ``tokens`` the global group count and padded token
    count.  Returns (dispatch, combine [n, g, E, C], aux, zloss, stats)."""
    n, g, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower expert, as ``jax.lax.top_k`` (the padded
    # tokens' logits are the router's bias alone, often all equal)
    gate_vals, gate_idx = (t[..., :top_k] for t in torch.sort(
        probs, dim=-1, descending=True, stable=True))
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    own = (torch.ones(n, g, 1, device=logits.device) if owned is None
           else owned[..., None].float())

    def place(counts):  # [n, E] at the global groups [first, first + n)
        out = counts.new_zeros(n_groups, e)
        out[first:first + n] = counts
        return out

    dispatch = logits.new_zeros(n, g, e, capacity)
    combine = logits.new_zeros(n, g, e, capacity)
    occ = logits.new_zeros(n_groups, e)  # kept so far, every group
    kept = logits.new_zeros(e)           # this rank's kept assignments
    for s in range(top_k):
        onehot = F.one_hot(gate_idx[..., s], e).float() * own
        before, total = batch.counts(place(onehot.sum(1)))
        pos = (onehot.cumsum(1) - onehot
               + (before + occ)[first:first + n, None])
        keep = onehot * (pos < capacity)
        slot = F.one_hot(pos.clamp(0, capacity - 1).long(), capacity).float()
        sel = keep[..., None] * slot
        dispatch = dispatch + sel
        combine = combine + sel * gate_vals[..., s, None, None]
        occ = occ + torch.minimum(total, capacity - occ)
        kept = kept + keep.sum((0, 1))

    top1 = F.one_hot(gate_idx[..., 0], e).float() * own
    density = batch.sum(top1.sum((0, 1))) / tokens
    density_proxy = batch.sum_grad((probs * own).sum((0, 1))) / tokens
    aux = (density * density_proxy).sum() * e
    lse = torch.logsumexp(logits, dim=-1)
    zloss = batch.sum_grad((lse ** 2 * own[..., 0]).sum()) / tokens
    assigned = batch.sum(kept)
    total_kept = assigned.sum()
    stats = {"expert_load": assigned / total_kept.clamp_min(1.0),
             "overflow": 1.0 - total_kept / float(tokens * top_k),
             "density": density}
    return dispatch, combine, aux, zloss, stats


def moe_dispatch_masks(router_logits: torch.Tensor, top_k: int,
                       capacity: int):
    """``avion_tpu.ops.moe.moe_dispatch_masks`` on one process: (dispatch
    [G, g, E, C] f32, combine [G, g, E, C] f32, aux loss, stats) of
    ``router_logits`` [G, g, E]."""
    n, g, _ = router_logits.shape
    dispatch, combine, aux, _, stats = _route(
        router_logits.float(), top_k, capacity, None, 0, n, n * g, _Batch())
    return dispatch, combine, aux, stats


def lecun_normal_fan_in_(weight: torch.Tensor,
                         generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal`` on a stacked [E, in, out] kernel: its fan-in
    counts the expert dim as a receptive field (``E * in``)."""
    fan_in = weight.numel() // weight.shape[-1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class MoEMlp(nn.Module):
    """Expert-parallel MLP: a drop-in for ``layers.Mlp`` (see the module's
    docstring).  ``ep`` (set by ``parallel.sharding``) is ``(group, rank,
    size)`` when the expert leaves hold this rank's E / ep experts;
    ``batch_group`` the data-parallel group whose global batch routes
    together; with ``sequence_parallel`` the input is this rank's slice
    of the current mesh's ``sp`` group's tokens."""

    def __init__(self, width: int, experts: int = 8,
                 hidden_mult: float = 4.0, top_k: int = 2,
                 capacity_factor: float = 1.25, group_size: int = 256,
                 zloss: bool = True, act: Optional[Callable] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 sequence_parallel: bool = False):
        super().__init__()
        from avion_tpu_torch.models.layers import gelu

        hid = int(width * hidden_mult)
        self.width, self.experts, self.top_k = width, experts, top_k
        self.capacity_factor, self.group_size = capacity_factor, group_size
        self.use_zloss = zloss
        self.act = act if act is not None else gelu
        self.dtype = dtype
        self.router = nn.Linear(width, experts)
        self.expert_fc1 = nn.Parameter(torch.empty(experts, width, hid))
        self.expert_fc1_bias = nn.Parameter(torch.zeros(experts, hid))
        self.expert_fc2 = nn.Parameter(torch.empty(experts, hid, width))
        self.expert_fc2_bias = nn.Parameter(torch.zeros(experts, width))
        self.sequence_parallel = sequence_parallel
        self.ep = None
        self.batch_group = None
        self.aux = self.zloss = self.load = self.overflow = None

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "MoEMlp":
        """The flax initializers: the router and the expert kernels
        lecun-normal (truncated), the biases zeros."""
        from avion_tpu_torch.models.layers import lecun_normal_

        lecun_normal_(self.router.weight, self.width, generator)
        self.router.bias.zero_()
        for w in (self.expert_fc1, self.expert_fc2):
            lecun_normal_fan_in_(w, generator)
        self.expert_fc1_bias.zero_()
        self.expert_fc2_bias.zero_()
        return self

    def route(self, x: torch.Tensor):
        """Routing of ``x`` [b, s, W]: (the tokens at their places ``xs``
        [n, g, W], dispatch, combine, this rank's slice of the flat
        places, aux, zloss, stats)."""
        b, s, w = x.shape
        batch = _Batch(self.batch_group)
        local = b * s
        t = batch.size * local
        g = min(self.group_size, t)
        n_groups = -(-t // g)
        t_pad = n_groups * g
        cap = _capacity(g, self.experts, self.top_k, self.capacity_factor)
        start = batch.rank * local
        # the last rank also holds the global tail group's padding
        end = t_pad if batch.rank == batch.size - 1 else start + local
        first, last = start // g, -(-end // g)
        lead, trail = start - first * g, last * g - end
        xt = x.reshape(local, w)
        pieces = [xt.new_zeros(lead, w), xt, xt.new_zeros(end - start - local
                                                          + trail, w)]
        xs = torch.cat(pieces).reshape(last - first, g, w)
        owned = None
        if lead or trail:
            owned = torch.zeros((last - first) * g, dtype=torch.bool,
                                device=x.device)
            owned[lead:lead + end - start] = True
            owned = owned.reshape(last - first, g)
        logits = F.linear(xs.float(), self.router.weight.float(),
                          self.router.bias.float())
        dispatch, combine, aux, zloss, stats = _route(
            logits, self.top_k, cap, owned, first, n_groups, t_pad, batch)
        return xs, dispatch, combine, slice(lead, lead + local), aux, zloss, \
            stats

    def experts_forward(self, expert_in: torch.Tensor,
                        lo: int = 0, hi: Optional[int] = None
                        ) -> torch.Tensor:
        """Experts ``[lo, hi)`` of the held leaves on their dispatched
        tokens ``expert_in`` [hi - lo, n, C, W] (compute dtype)."""
        dtype = expert_in.dtype
        w1 = self.expert_fc1[lo:hi].to(dtype)
        b1 = self.expert_fc1_bias[lo:hi].to(dtype)
        w2 = self.expert_fc2[lo:hi].to(dtype)
        b2 = self.expert_fc2_bias[lo:hi].to(dtype)
        h = self.act(torch.einsum("encw,ewh->ench", expert_in, w1)
                     + b1[:, None, None, :])
        return torch.einsum("ench,ehw->encw", h, w2) + b2[:, None, None, :]

    def _record(self, aux, zloss, stats) -> None:
        self.aux = aux
        self.zloss = zloss if self.use_zloss else None
        self.load = stats["expert_load"].detach()
        self.overflow = stats["overflow"].detach()

    def combine(self, out: torch.Tensor, combine: torch.Tensor,
                places: slice, shape) -> torch.Tensor:
        y = torch.einsum("encw,ngec->ngw", out.float(), combine)
        return y.reshape(-1, shape[-1])[places].reshape(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = sp_group() if self.sequence_parallel else None
        rank, n = group_rank_size(group)
        if n == 1:
            return self.forward_rows(x)
        s = x.shape[1]
        y = self.forward_rows(_GatherSequence.apply(x, group))
        return y[:, rank * s:(rank + 1) * s]

    def forward_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The layer on whole rows ``x`` [b, S, W] (every token of each)."""
        xs, dispatch, combine, places, aux, zloss, stats = self.route(x)
        self._record(aux, zloss, stats)
        expert_in = torch.einsum("ngw,ngec->encw", xs.float(),
                                 dispatch).to(self.dtype)
        if self.ep is None:
            out = self.experts_forward(expert_in)
        else:
            group, rank, size = self.ep
            per = self.experts // size
            expert_in = _CopyToTensor.apply(expert_in, group)
            out = _GatherExperts.apply(
                self.experts_forward(expert_in[rank * per:(rank + 1) * per]),
                group)
        return self.combine(out, combine, places, x.shape).to(x.dtype)


def moe_outputs(model: torch.nn.Module) -> List[MoEMlp]:
    """The model's MoE layers, in module order (their ``aux``, ``zloss``,
    ``load`` and ``overflow`` are those of the last forward)."""
    return [m for m in model.modules() if isinstance(m, MoEMlp)]


def moe_metrics(model: torch.nn.Module, aux_weight: float,
                zloss_weight: float) -> Optional[dict]:
    """What the JAX train step reads from the ``losses``, ``moe_zloss`` and
    ``metrics`` collections after a forward: ``moe_aux`` (summed over the
    layers) and, with ``zloss_weight`` > 0, ``moe_zloss``; ``objective``
    their weighted sum; ``moe_load_max`` / ``moe_load_min`` (of the mean
    load over the layers) and ``moe_overflow`` (the mean).  None for a
    model without MoE layers."""
    layers = moe_outputs(model)
    if not layers or layers[0].aux is None:
        return None
    out = {"moe_aux": sum(m.aux for m in layers)}
    out["objective"] = aux_weight * out["moe_aux"]
    zs = [m.zloss for m in layers if m.zloss is not None]
    if zs and zloss_weight > 0:
        out["moe_zloss"] = sum(zs)
        out["objective"] = out["objective"] + zloss_weight * out["moe_zloss"]
    load = torch.stack([m.load for m in layers]).mean(0)
    out["moe_load_max"] = load.max()
    out["moe_load_min"] = load.min()
    out["moe_overflow"] = torch.stack([m.overflow for m in layers]).mean()
    return out


def run_experts_local(moe: MoEMlp, x: torch.Tensor, ep: int) -> torch.Tensor:
    """``moe`` (holding all its experts) with its ``ep`` ranks played in
    one process, on one device: the routing once, as on every ``ep`` rank;
    each rank's E / ep experts on their slice of the dispatched tokens;
    the outputs concatenated as the all-gather would and combined.
    Autograd reaches the whole weights.  The counterpart of
    ``tensor_parallel.run_block_local`` for ``mesh.ep``."""
    if moe.experts % ep:
        raise ValueError(f"mesh.ep={ep} does not divide {moe.experts} "
                         f"experts")
    xs, dispatch, combine, places, aux, zloss, stats = moe.route(x)
    moe._record(aux, zloss, stats)
    expert_in = torch.einsum("ngw,ngec->encw", xs.float(),
                             dispatch).to(moe.dtype)
    per = moe.experts // ep
    out = torch.cat([moe.experts_forward(expert_in[r * per:(r + 1) * per],
                                         r * per, (r + 1) * per)
                     for r in range(ep)])
    return moe.combine(out, combine, places, x.shape).to(x.dtype)

