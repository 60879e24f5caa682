"""GPipe pipeline over the ``pp`` mesh axis (``avion_tpu.parallel.pipeline``).

A pipelined layer stack splits its layers into ``pp`` stages of
consecutive units (blocks of the visual tower; cross-attention groups of
the gated decoders, ``parallel.pipeline_gated``) and its local batch into
``M`` contiguous microbatches, and runs GPipe's fill-drain schedule: at
tick t, stage i runs microbatch ``t - i``; its output goes to stage i + 1
(``dist.isend`` / ``irecv`` of the ``pp`` group), and the last stage's
outputs, concatenated, are broadcast to every ``pp`` rank.

- The units are the port's own modules (``models.layers.Block`` here,
  which run the flash kernels), so the numbers are the sequential stack's
  and a checkpoint keeps its names (``transformer.resblocks.{i}``): a
  sequentially trained checkpoint runs pipelined and back with no
  conversion.  :func:`stack_block_params` / :func:`unstack_block_params`
  convert the JAX package's stacked ``[L, ...]`` tree (``params_from_jax``
  uses them).
- :class:`_GPipe` is one ``torch.autograd.Function``: its forward runs the
  ticks, keeping each microbatch's stage graph (its input and output); its
  backward runs the ticks in reverse in lockstep (``dy`` from the next
  stage, ``torch.autograd.grad`` of the stage, ``dx`` to the previous), so
  both directions' messages are matched in one place.  The parameters'
  gradients, summed over the microbatches, come back once through the
  function, so DDP and FSDP2 see each gradient once.  The output's
  backward takes the last stage's own cotangent (every ``pp`` rank's is
  the same); the input's gradient exists on stage 0 and is broadcast to
  every ``pp`` rank.  A side input (the gated decoders' visual tokens) is
  sliced per microbatch, and its gradient is summed over ``pp``.
- ``remat``: each block runs under activation checkpointing with the
  tower's ``save_attn`` policy (JAX's pipeline remat): its graph keeps the
  block's input and the attention forward's outputs.
- Bubble ticks are skipped (JAX computes throwaway values in them), so a
  stage launches its kernels ``M`` times a step, not ``M + pp - 1``.
- Without a ``pp`` group (a stack that :func:`pipeline_parallelize` did
  not cut, e.g. a whole copy for evaluation, or ``pp`` = 1) the units run
  in sequence on the whole batch, as JAX's fallback.

A stage's parameters are held by its ``pp`` rank only
(:func:`pipeline_parallelize`, from ``parallel.sharding.shard_model``):
the others keep empty placeholders, and the model's layout
(``parallel.tensor_parallel.StageLeaf``) gathers them whole for
checkpoints.  :func:`run_stages_local` plays the stages in one process.

Under ``mesh.tensor`` a stage's blocks are whole on every ``tensor`` rank
of it (JAX's ``shard_map`` over ``pp`` holds them whole inside the map;
``parallel.tensor_parallel`` leaves the stack uncut), and the ``pp``
group that exchanges activations is the ranks of one ``tensor``
coordinate.  The tensor ranks of a stage so compute the same gradients,
up to the order in which the combined backward kernel adds dq: the
backward averages the stage's parameter gradients, the input's gradient
and the side input's over the ``tensor`` group once, so the copies stay
bit-equal, and DDP or FSDP2, whose groups hold one ``tensor`` index
(``Mesh.replica_group``), reduce them over the batch ranks alone.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

# flat stacked-leaf names of the JAX pipelined tower -> the sequential
# Block's flax subtree path
_LEAF_PATHS: Dict[str, tuple] = {
    "ln1_scale": ("ln_1", "norm", "scale"),
    "ln1_bias": ("ln_1", "norm", "bias"),
    "qkv_kernel": ("attn", "qkv", "kernel"),
    "qkv_bias": ("attn", "qkv", "bias"),
    "out_kernel": ("attn", "out_proj", "kernel"),
    "out_bias": ("attn", "out_proj", "bias"),
    "ln2_scale": ("ln_2", "norm", "scale"),
    "ln2_bias": ("ln_2", "norm", "bias"),
    "fc1_kernel": ("mlp", "fc1", "kernel"),
    "fc1_bias": ("mlp", "fc1", "bias"),
    "fc2_kernel": ("mlp", "fc2", "kernel"),
    "fc2_bias": ("mlp", "fc2", "bias"),
}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def stack_block_params(transformer_params: Dict, layers: int) -> Dict:
    """A flax ``Transformer``'s ``resblocks_{i}`` tree -> the JAX pipelined
    tower's stacked flat tree (numpy arrays)."""
    return {name: np.stack([np.asarray(_get(
        transformer_params[f"resblocks_{i}"], path)) for i in range(layers)])
        for name, path in _LEAF_PATHS.items()}


def unstack_block_params(stacked: Dict) -> Dict:
    """Inverse of :func:`stack_block_params`."""
    layers = int(np.shape(next(iter(stacked.values())))[0])
    out: Dict[str, Any] = {}
    for i in range(layers):
        blk: Dict[str, Any] = {}
        for name, path in _LEAF_PATHS.items():
            _put(blk, path, np.asarray(stacked[name])[i])
        out[f"resblocks_{i}"] = blk
    return out


# ------------------------------------------------------------- schedule

@dataclass
class _Pipe:
    """This rank's place in its pipeline: the ``pp`` group, its stage, the
    stages' global ranks and the dtype of the activations between
    stages."""

    group: object
    stage: int
    ranks: List[int]
    carry: torch.dtype
    tensor: Optional[object] = None  # the tensor group replicating a stage

    @property
    def size(self) -> int:
        return len(self.ranks)

    def tensor_mean(self, grads: List[Optional[torch.Tensor]]) -> None:
        """Average ``grads`` over the ``tensor`` group in place (one
        flat all-reduce; None entries are skipped, alike on every rank)."""
        held = [g for g in grads if g is not None]
        if self.tensor is None or not held:
            return
        flat = torch.cat([g.reshape(-1) for g in held])
        dist.all_reduce(flat, group=self.tensor)
        flat /= dist.get_world_size(self.tensor)
        for g, new in zip(held, flat.split([g.numel() for g in held])):
            g.copy_(new.view_as(g))


def current_pipe(carry: torch.dtype) -> Optional[_Pipe]:
    """The current mesh's pipeline, or None without one (``pp`` = 1)."""
    from avion_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    if mesh is None or mesh.shape["pp"] == 1 or mesh.pp_group is None:
        return None
    return _Pipe(mesh.pp_group, mesh.coords["pp"], mesh.pp_ranks, carry,
                 mesh.tensor_group if mesh.shape["tensor"] > 1 else None)


def stage_units(n_units: int, pp: int, stage: int) -> range:
    per = n_units // pp
    return range(stage * per, (stage + 1) * per)


def _exchange(recv: Optional[tuple], send: Optional[tuple]):
    """Post this tick's receive (buffer, peer) and send (tensor, peer) and
    wait for both."""
    reqs = []
    if recv is not None:
        reqs.append(dist.irecv(recv[0], src=recv[1]))
    if send is not None:
        reqs.append(dist.isend(send[0], dst=send[1]))
    for r in reqs:
        r.wait()


def _forward_ticks(run: Callable, pipe: _Pipe, m: int, x: torch.Tensor,
                   side: Optional[torch.Tensor], keep_graph: bool):
    """The fill-drain forward of this stage: (its outputs by microbatch on
    the last stage, else None; the kept graphs by microbatch)."""
    pp, i = pipe.size, pipe.stage
    mbs = x.chunk(m)
    sides = side.chunk(m) if side is not None else [None] * m
    outs: List[Optional[torch.Tensor]] = [None] * m
    saved: List[Optional[tuple]] = [None] * m
    pending = None
    for t in range(m + pp - 1):
        mi = t - i
        active = 0 <= mi < m
        buf = None
        if active and i > 0:
            buf = torch.empty(mbs[mi].shape, dtype=pipe.carry,
                              device=x.device)
        _exchange((buf, pipe.ranks[i - 1]) if buf is not None else None,
                  (pending, pipe.ranks[i + 1]) if pending is not None
                  else None)
        pending = None
        if not active:
            continue
        inp = mbs[mi] if i == 0 else buf
        sd = sides[mi]
        if keep_graph:
            inp = inp.detach().requires_grad_()
            if sd is not None:
                sd = sd.detach().requires_grad_()
            with torch.enable_grad():
                y = run(inp, sd)
            saved[mi] = (inp, sd, y)
        else:
            y = run(inp, sd)
        if i < pp - 1:
            pending = y.detach().to(pipe.carry).contiguous()
        else:
            outs[mi] = y.detach().to(pipe.carry)
    return outs, saved


def _broadcast_from(t: Optional[torch.Tensor], shape, dtype: torch.dtype,
                    device, src: int, group) -> torch.Tensor:
    """``t`` on the rank ``src`` (None elsewhere), on every rank of
    ``group``."""
    buf = t.contiguous() if t is not None else torch.empty(
        shape, dtype=dtype, device=device)
    dist.broadcast(buf, src=src, group=group)
    return buf


def _output(outs: list, pipe: _Pipe, x: torch.Tensor) -> torch.Tensor:
    """The last stage's microbatch outputs, concatenated, on every stage."""
    last = pipe.size - 1
    return _broadcast_from(torch.cat(outs) if pipe.stage == last else None,
                           x.shape, pipe.carry, x.device, pipe.ranks[last],
                           pipe.group)


class _GPipe(torch.autograd.Function):
    """The pipeline of one stage over its ``pp`` group (see the module's
    docstring); ``params`` are the stage's parameters that need a
    gradient, the inputs whose gradients it returns."""

    @staticmethod
    def forward(ctx, run, pipe, m, x, side, *params):
        outs, saved = _forward_ticks(run, pipe, m, x, side, True)
        ctx.pipe, ctx.m, ctx.saved, ctx.params = pipe, m, saved, params
        ctx.x_meta = (x.shape, x.dtype, x.device)
        ctx.has_side = side is not None
        return _output(outs, pipe, x)

    @staticmethod
    def backward(ctx, dy):
        pipe, m, saved, params = ctx.pipe, ctx.m, ctx.saved, ctx.params
        pp, i = pipe.size, pipe.stage
        shape, dtype, device = ctx.x_meta
        dys = dy.chunk(m) if i == pp - 1 else None
        mb_shape = (shape[0] // m,) + tuple(shape[1:])
        p_grads: List[Optional[torch.Tensor]] = [None] * len(params)
        d_sides: List[Optional[torch.Tensor]] = [None] * m
        dxs: List[Optional[torch.Tensor]] = [None] * m
        pending = None
        for t in reversed(range(m + pp - 1)):
            mi = t - i
            active = 0 <= mi < m
            buf = None
            if active and i < pp - 1:
                buf = torch.empty(mb_shape, dtype=pipe.carry, device=device)
            _exchange((buf, pipe.ranks[i + 1]) if buf is not None else None,
                      (pending, pipe.ranks[i - 1]) if pending is not None
                      else None)
            pending = None
            if not active:
                continue
            g = dys[mi] if i == pp - 1 else buf
            inp, sd, y = saved[mi]
            saved[mi] = None
            inputs = [inp] + ([sd] if sd is not None else []) + list(params)
            grads = torch.autograd.grad(y, inputs, g.to(y.dtype),
                                        allow_unused=True)
            dinp = grads[0]
            if sd is not None:
                d_sides[mi] = grads[1]
            for k, gp in enumerate(grads[len(inputs) - len(params):]):
                if gp is not None:
                    p_grads[k] = gp if p_grads[k] is None else p_grads[k] + gp
            if i > 0:
                pending = dinp.to(pipe.carry).contiguous()
            else:
                dxs[mi] = dinp
        dx = torch.cat(dxs).to(dtype) if i == 0 else None
        pipe.tensor_mean(p_grads + [dx])
        dx = _broadcast_from(dx, shape, dtype, device, pipe.ranks[0],
                             pipe.group)
        d_side = None
        if ctx.has_side:
            d_side = torch.cat(d_sides).contiguous()
            dist.all_reduce(d_side, group=pipe.group)
            pipe.tensor_mean([d_side])
        return (None, None, None, dx, d_side, *p_grads)


def gpipe(run: Callable, params: Sequence[torch.Tensor], x: torch.Tensor,
          side: Optional[torch.Tensor] = None, *, num_microbatches: int,
          pipe: _Pipe) -> torch.Tensor:
    """This stage's part of the pipeline over ``pipe``: ``run(h, side_mb)``
    applies the stage's units to one microbatch; ``params`` are the
    parameters ``run`` reads.  ``x`` [B, ...] is the local batch (and
    ``side`` [B, ...] its side input); B must divide by
    ``num_microbatches``.  Returns the last stage's output [B, ...] in
    ``pipe.carry`` on every ``pp`` rank."""
    m = num_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} does not divide into "
                         f"{m} pipeline microbatches")
    needs = [p for p in params if p.requires_grad]
    if torch.is_grad_enabled() and (needs or x.requires_grad or (
            side is not None and side.requires_grad)):
        return _GPipe.apply(run, pipe, m, x, side, *needs)
    return _output(_forward_ticks(run, pipe, m, x, side, False)[0], pipe, x)


# ---------------------------------------------------------------- module

def _save_attn_block(blk: nn.Module, remat: bool) -> Callable:
    """``blk`` as a function of its input, under the ``save_attn``
    checkpoint when ``remat`` and a gradient is taken."""
    if not remat:
        return blk
    from avion_tpu_torch.models.layers import _save_attn

    ctx = functools.partial(create_selective_checkpoint_contexts, _save_attn)

    def run(h):
        if not torch.is_grad_enabled():
            return blk(h)
        return checkpoint(blk, h, use_reentrant=False, context_fn=ctx)

    return run


class PipelinedTransformer(nn.Module):
    """The layer stack of ``models.layers.Transformer`` run as a GPipe
    pipeline over the current mesh's ``pp`` axis (the JAX
    ``PipelinedTransformer``): ``resblocks`` are the port's blocks (no
    DropPath, LayerScale, MoE or sequence parallelism), ``layers`` must
    divide by ``pp``; ``num_microbatches`` microbatches; ``remat``
    checkpoints each block under ``save_attn``."""

    def __init__(self, width: int, layers: int, heads: int, act=None,
                 dtype: torch.dtype = torch.bfloat16, causal: bool = False,
                 num_microbatches: int = 4, remat: bool = False):
        super().__init__()
        from avion_tpu_torch.models.layers import Block, gelu

        self.resblocks = nn.ModuleList(
            Block(width, heads, act or gelu, dtype, causal)
            for _ in range(layers))
        self.num_microbatches = num_microbatches
        self.remat = remat

    def units(self) -> List[List[nn.Module]]:
        """The stack's pipeline units (one block each)."""
        return [[blk] for blk in self.resblocks]

    def draw_drop_path(self, batch: int, generator, device) -> None:
        return None  # no DropPath in a pipelined stack

    def run_units(self, units: Sequence[Sequence[nn.Module]],
                  h: torch.Tensor, side=None) -> torch.Tensor:
        for (blk,) in units:
            h = _save_attn_block(blk, self.remat)(h)
        return h

    def forward(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        if keep is not None:
            raise ValueError("a pipelined stack has no DropPath")
        return run_pipelined(self, x, None, x.dtype)


def run_pipelined(module: nn.Module, x: torch.Tensor,
                  side: Optional[torch.Tensor],
                  carry: torch.dtype) -> torch.Tensor:
    """``module``'s units (``module.units()``, run by
    ``module.run_units``) over the current mesh's pipeline when
    :func:`pipeline_parallelize` cut it, else in sequence."""
    units = module.units()
    pipe = current_pipe(carry) if getattr(module, "pipelined", False) \
        else None
    if pipe is None:
        return module.run_units(units, x, side)
    mine = [units[k] for k in stage_units(len(units), pipe.size,
                                          pipe.stage)]
    params = [p for unit in mine for blk in unit for p in blk.parameters()]
    return gpipe(lambda h, sd: module.run_units(mine, h, sd), params, x,
                 side, num_microbatches=module.num_microbatches, pipe=pipe)


def run_stages_local(module: nn.Module, x: torch.Tensor, pp: int,
                     side: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``module``'s pipeline (a :class:`PipelinedTransformer` or a
    ``pipeline_gated.PipelinedGatedDecoder``, holding all its units) with
    its ``pp`` stages played in one process, on one device: the
    fill-drain ticks over ``module.num_microbatches`` microbatches, each
    stage's units on the microbatch it holds at that tick (and that
    microbatch's side input).  Autograd runs through it as it is.  The
    counterpart of ``tensor_parallel.run_block_local`` for ``mesh.pp``."""
    units = module.units()
    check_stages(module, pp)
    m = module.num_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} does not divide into {m} "
                         f"pipeline microbatches")
    stages = [[units[k] for k in stage_units(len(units), pp, i)]
              for i in range(pp)]
    h = list(x.chunk(m))
    sides = side.chunk(m) if side is not None else [None] * m
    for t in range(m + pp - 1):
        for i in range(pp):
            mi = t - i
            if 0 <= mi < m:
                h[mi] = module.run_units(stages[i], h[mi], sides[mi])
    return torch.cat(h)


def check_stages(module: nn.Module, pp: int) -> None:
    n = len(module.units())
    if n % pp:
        what = getattr(module, "unit_name", "layers")
        if what == "groups":
            raise ValueError(
                f"groups {n} not divisible by pp={pp}: pipeline stages must "
                f"split at cross-attention group boundaries")
        raise ValueError(f"{what} {n} not divisible by pp={pp}")


def pipelined_modules(model: nn.Module) -> List[nn.Module]:
    from avion_tpu_torch.parallel.pipeline_gated import PipelinedGatedDecoder

    return [m for m in model.modules()
            if isinstance(m, (PipelinedTransformer, PipelinedGatedDecoder))]


def pipeline_parallelize(model: nn.Module, mesh) -> nn.Module:
    """Hold each pipelined stack's units on their ``pp`` stage only, in
    place: a rank keeps its stage's parameters and an empty placeholder
    (``tensor_parallel.placeholder``) of every other one, and the model's
    layout lists them all (``tensor_parallel.StageLeaf``), so checkpoints
    and whole copies gather them whole.  Under ``mesh.tensor`` every
    tensor rank of a stage holds its units whole.  A mesh whose ``pp`` is
    1 leaves the model as it is."""
    from avion_tpu_torch.parallel.tensor_parallel import (StageLeaf,
                                                          ensure_layout,
                                                          placeholder)

    pp = mesh.shape["pp"]
    stacks = pipelined_modules(model)
    if pp == 1 or not stacks:
        return model
    names = {id(m): n for n, m in model.named_modules()}
    layout = ensure_layout(model)
    stage = mesh.coords["pp"]
    ranks = mesh.pp_ranks
    for stack in stacks:
        check_stages(stack, pp)
        stack.pipelined = True
        units = stack.units()
        per = len(units) // pp
        for k, unit in enumerate(units):
            owner = k // per
            for blk in unit:
                for pname, p in list(blk.named_parameters()):
                    *path, leaf = pname.split(".")
                    holder = blk.get_submodule(".".join(path))
                    full = f"{names[id(blk)]}.{pname}"
                    layout.leaves[full] = StageLeaf(
                        tuple(p.shape), owner, ranks[owner], mesh.pp_group,
                        stage)
                    if owner != stage and p.dim() > 0:
                        setattr(holder, leaf, nn.Parameter(
                            placeholder(p.detach()),
                            requires_grad=p.requires_grad))
    return model


def placeholder_names(model: nn.Module) -> List[str]:
    """The names of the parameters this rank holds as placeholders."""
    from avion_tpu_torch.parallel.tensor_parallel import StageLeaf

    layout = getattr(model, "tensor_layout", None)
    if layout is None:
        return []
    return [n for n, leaf in layout.leaves.items()
            if isinstance(leaf, StageLeaf) and not leaf.held]
