"""Tensor parallelism over ``mesh.tensor`` (the ``tensor`` rule of
``avion_tpu.parallel.sharding._spec_for_param``) in Megatron's layout, with
explicit collectives.

Which parameters a rank holds in part is the JAX rule on the flax shape
(the port's ``[out, in]`` weight transposed): a matrix whose name holds
``qkv``, ``fc1`` or ``in_proj`` is column-parallel (the port's dim 0), one
whose name holds ``out_proj`` or ``fc2`` row-parallel (the port's dim 1),
each only where that dim divides by ``tensor``, the matrix has a dim of 128
or more, and never a bias or other 1-D leaf.  How a block computes follows
from that:

- a block whose column matrix is held in part is split: its input enters
  through :class:`_CopyToTensor` (identity; the backward sums the input's
  gradient over the tensor group), each rank computes its heads or its MLP
  columns, and the row matrix's partial products are summed over the group
  (:class:`_ReduceFromTensor`) before its bias, which is added once.  The
  column bias is whole on every rank; a rank adds its rows of it
  (:class:`_SliceReplicated`, whose backward sums the rows' gradients over
  the group).  A row matrix the JAX rule keeps whole (too small) is held
  whole and used in the same slices.
- The fused ``Wqkv`` is cut by heads: rank r holds the q, k and v rows of
  heads ``[r H / t, (r + 1) H / t)``, so the attention kernel runs on a
  local ``[B, S, 3 W / t]`` buffer with ``H / t`` heads.  (JAX cuts the
  ``3 W`` columns into ``t`` contiguous blocks and lets XLA reshard; the
  bytes a rank holds are the same share.)  Where ``t`` does not divide the
  heads, the port holds JAX's blocks: rank r computes its contiguous
  ``3 W / t`` rows of the projection, the rows are gathered whole
  (:class:`_GatherLastDim`, whose backward sums the ranks' gradients and
  keeps this rank's block), the kernel runs on all ``H`` heads, and each
  rank multiplies its ``W / t`` columns of the attention output by its
  block of the row-cut ``out_proj``.
- A matrix held in part whose block is not split (the narrator's
  cross-attention ``out_proj``: JAX shards it, not its ``q`` / ``kv``) is
  gathered whole on use (:class:`_GatherOnUse`: all-gather forward; the
  backward averages the gradient over the group and keeps this rank's
  block, a reduce-scatter) and its matmul runs whole.

The numbers are the whole model's; only where the bytes live changes.  The
model's :class:`TensorLayout` (``model.tensor_layout``) lists the parameters
held in part, and gathers and cuts them for checkpoints and whole copies
(``core.train_state``, ``train.common.whole_model``), which keep the one-
process layout.  The same layout lists the parts of the other model axes:
a mixture-of-experts MLP's expert leaves cut along dim 0 over ``ep``
(:class:`TensorLeaf` over the ``ep`` group, ``ops.moe``) and a pipeline's
stage leaves, held whole by their ``pp`` stage and as empty placeholders
elsewhere (:class:`StageLeaf`, ``parallel.pipeline``).  Under ``pp`` a
pipelined stack is not cut: each stage's blocks are whole on every tensor
rank of it, as inside JAX's pipeline map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

COL_PARALLEL = ("qkv", "fc1", "in_proj")
ROW_PARALLEL = ("out_proj", "fc2")


def jax_tensor_dim(name: str, shape: Sequence[int], tensor: int
                   ) -> Optional[int]:
    """The dim of the port's parameter ``name`` (shape ``shape``, a
    ``[out, in]`` weight for a matrix) that the JAX rule shards over
    ``tensor``, or None."""
    if tensor <= 1 or len(shape) < 2 or max(shape) < 128:
        return None
    lname = name.lower()
    if any(k in lname for k in COL_PARALLEL) and shape[0] % tensor == 0:
        return 0
    if any(k in lname for k in ROW_PARALLEL) and shape[1] % tensor == 0:
        return 1
    return None


# ------------------------------------------------------------ collectives

class _CopyToTensor(torch.autograd.Function):
    """Identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTensor(torch.autograd.Function):
    """The sum over the group; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceReplicated(torch.autograd.Function):
    """This rank's ``index`` of a tensor every rank holds whole, along
    ``dim``; the backward puts the gradient at ``index`` and sums it over
    the group, so the whole tensor's gradient agrees on every rank."""

    @staticmethod
    def forward(ctx, p, index, dim, group):
        ctx.save_for_backward(index)
        ctx.shape, ctx.dim, ctx.group = p.shape, dim, group
        return p.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        full = g.new_zeros(ctx.shape).index_add_(ctx.dim, index, g)
        dist.all_reduce(full, group=ctx.group)
        return full, None, None, None


class _GatherOnUse(torch.autograd.Function):
    """The whole of a tensor held in contiguous blocks along ``dim``; the
    backward averages the whole gradient over the group and keeps this
    rank's block."""

    @staticmethod
    def forward(ctx, p, dim, group):
        ctx.dim, ctx.group = dim, group
        parts = [torch.empty_like(p) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, p.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        n = dist.get_world_size(ctx.group)
        dist.all_reduce(g, group=ctx.group)
        g /= n
        block = g.chunk(n, ctx.dim)[dist.get_rank(ctx.group)]
        return block.contiguous(), None, None


class _GatherLastDim(torch.autograd.Function):
    """The whole of an activation held in contiguous blocks along its last
    dim; the backward sums the whole gradient over the group (each rank's
    is partial) and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, -1)[dist.get_rank(ctx.group)].contiguous(), None


# ----------------------------------------------------------------- layout

@dataclass
class TensorLeaf:
    """A parameter held in part over ``group`` (this rank ``rank`` of it):
    the dim it is cut along, its whole size there, and each rank's
    indices along it; ``axis`` the mesh axis of ``group``."""

    dim: int
    size: int
    indices: List[torch.Tensor]
    group: object = None
    rank: int = 0
    axis: str = "tensor"

    def gather(self, value: torch.Tensor) -> torch.Tensor:
        value = value.contiguous()
        parts = [torch.empty_like(value) for _ in self.indices]
        dist.all_gather(parts, value, group=self.group)
        shape = list(value.shape)
        shape[self.dim] = self.size
        whole = value.new_empty(shape)
        for idx, part in zip(self.indices, parts):
            whole.index_copy_(self.dim, idx.to(value.device), part)
        return whole

    def cut(self, whole: torch.Tensor) -> torch.Tensor:
        return whole.index_select(
            self.dim, self.indices[self.rank].to(whole.device)).contiguous()

    def global_shape(self, shape: Sequence[int]) -> tuple:
        shape = list(shape)
        shape[self.dim] = self.size
        return tuple(shape)


def placeholder(whole: torch.Tensor) -> torch.Tensor:
    """What a rank that does not hold ``whole`` keeps in its place: empty
    along dim 0 (the same ndim, so the same optimizer groups); a scalar
    is kept whole and unused."""
    if whole.dim() == 0:
        return whole
    return whole.new_empty((0,) + tuple(whole.shape[1:]))


@dataclass
class StageLeaf:
    """A parameter held whole by one rank of ``group`` (``owner``, the
    pipeline stage that runs it) and as a :func:`placeholder` by the
    others; ``shape`` is the whole shape, ``src`` the owner's global
    rank."""

    shape: tuple
    owner: int
    src: int
    group: object = None
    rank: int = 0
    axis: str = "pp"
    dim = None

    @property
    def held(self) -> bool:
        return self.rank == self.owner

    def gather(self, value: torch.Tensor) -> torch.Tensor:
        buf = (value.contiguous().clone() if self.held
               else value.new_empty(self.shape))
        dist.broadcast(buf, src=self.src, group=self.group)
        return buf

    def cut(self, whole: torch.Tensor) -> torch.Tensor:
        return whole if self.held else placeholder(whole)

    def global_shape(self, shape: Sequence[int]) -> tuple:
        return tuple(self.shape)


@dataclass
class TensorSplit:
    """How one block (an attention or an MLP) computes over the group:
    ``split`` when its inner dim is cut; ``inner`` this rank's rows of the
    column matrix, ``row_index`` its columns of the row matrix,
    ``row_held`` whether the row matrix is held in part (else whole and
    sliced on use); ``gathered`` the names (in the block) of matrices held
    in part and gathered on use; ``gather_qkv`` whether an attention's
    heads are not cut (``t`` does not divide them): its ``Wqkv`` rows are
    JAX's contiguous blocks and the projection is gathered whole."""

    group: object
    size: int
    split: bool = False
    inner: Optional[torch.Tensor] = None
    row_index: Optional[torch.Tensor] = None
    row_held: bool = False
    gathered: Dict[str, int] = field(default_factory=dict)
    gather_qkv: bool = False


@dataclass
class TensorLayout:
    """The parameters a model holds in part, by name (a
    :class:`TensorLeaf` over the ``tensor`` or ``ep`` group, or a
    :class:`StageLeaf` over ``pp``)."""

    leaves: Dict[str, object] = field(default_factory=dict)

    def gather(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """The whole of ``name`` from this rank's part (a collective over
        its leaf's group); any other name's value itself."""
        leaf = self.leaves.get(name)
        return value if leaf is None else leaf.gather(value)

    def cut(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``name``'s whole value; any other name's
        value itself."""
        leaf = self.leaves.get(name)
        return whole if leaf is None else leaf.cut(whole)

    def global_shape(self, name: str, shape: Sequence[int]) -> tuple:
        leaf = self.leaves.get(name)
        return tuple(shape) if leaf is None else leaf.global_shape(shape)

    def axes(self) -> List[tuple]:
        """``(axis, group)`` of every axis with leaves, in one order on
        every rank."""
        found = {leaf.axis: leaf.group for leaf in self.leaves.values()}
        return [(a, found[a]) for a in ("pp", "ep", "tensor") if a in found]


def ensure_layout(model: torch.nn.Module) -> TensorLayout:
    """``model``'s layout, made empty if it has none yet."""
    if getattr(model, "tensor_layout", None) is None:
        model.tensor_layout = TensorLayout()
    return model.tensor_layout


def tensor_layout(model: torch.nn.Module) -> Optional[TensorLayout]:
    return getattr(model, "tensor_layout", None)


def _blocks(n: int, size: int) -> List[torch.Tensor]:
    per = n // size
    return [torch.arange(r * per, (r + 1) * per) for r in range(size)]


def _head_rows(width: int, size: int) -> List[torch.Tensor]:
    """Each rank's rows of a fused ``[q | k | v]`` projection: the q, k
    and v rows of its heads."""
    per = width // size
    return [torch.cat([torch.arange(part * width + r * per,
                                    part * width + (r + 1) * per)
                       for part in range(3)]) for r in range(size)]


def _hold(module: torch.nn.Module, pname: str, dim: int,
          index: torch.Tensor) -> None:
    """Replace parameter ``pname`` of ``module`` by its rows ``index``
    along ``dim``."""
    p = getattr(module, pname)
    part = p.detach().index_select(dim, index.to(p.device)).contiguous()
    setattr(module, pname, torch.nn.Parameter(part,
                                              requires_grad=p.requires_grad))


def tensor_parallelize(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Cut ``model``'s blocks over ``mesh``'s tensor group in place (see
    the module's docstring) and give it its :class:`TensorLayout`; a mesh
    whose ``tensor`` is 1 leaves it as it is.  Call it before FSDP2 and the
    optimizer, on a model that holds its whole weights."""
    from avion_tpu_torch.models.layers import Mlp, SelfAttention
    from avion_tpu_torch.models.narrator import CrossAttention

    t = mesh.shape["tensor"]
    if t == 1:
        return model
    group, rank = mesh.tensor_group, mesh.coords["tensor"]
    leaves: Dict[str, TensorLeaf] = {}
    # a pipelined stack's stage is whole on every tensor rank (JAX's
    # shard_map over pp holds its blocks whole inside the map)
    staged = set()
    if mesh.shape["pp"] > 1:
        from avion_tpu_torch.parallel.pipeline import pipelined_modules

        staged = {id(m) for stack in pipelined_modules(model)
                  for m in stack.modules()}

    def rule(prefix, layer):
        return jax_tensor_dim(f"{prefix}.weight", layer.weight.shape, t)

    for name, module in model.named_modules():
        name = f"{name}." if name else ""
        if id(module) in staged:
            continue
        if isinstance(module, (SelfAttention, Mlp)):
            attn = isinstance(module, SelfAttention)
            col_name, row_name = (("Wqkv", "out_proj") if attn
                                  else ("fc1", "fc2"))
            col, row = getattr(module, col_name), getattr(module, row_name)
            col_dim = rule(f"{name}{col_name}", col)
            row_dim = rule(f"{name}{row_name}", row)
            ts = TensorSplit(group, t)
            if col_dim is not None:
                ts.gather_qkv = attn and module.heads % t != 0
                inner = col.weight.shape[0]
                rows = (_head_rows(inner // 3, t)
                        if attn and not ts.gather_qkv
                        else _blocks(inner, t))
                cols = _blocks(row.weight.shape[1], t)
                _hold(col, "weight", 0, rows[rank])
                leaves[f"{name}{col_name}.weight"] = TensorLeaf(
                    0, inner, rows, group, rank)
                device = col.weight.device
                ts.split = True
                ts.inner = rows[rank].to(device)
                ts.row_index = cols[rank].to(device)
                if row_dim is not None:
                    _hold(row, "weight", 1, cols[rank])
                    leaves[f"{name}{row_name}.weight"] = TensorLeaf(
                        1, row.weight.shape[1] * t, cols, group, rank)
                    ts.row_held = True
            elif row_dim is not None:
                ts.gathered[row_name] = row_dim
        elif isinstance(module, CrossAttention):
            ts = TensorSplit(group, t)
            for lname in ("q", "kv", "out_proj"):
                dim = rule(f"{name}{lname}", getattr(module, lname))
                if dim is not None:
                    ts.gathered[lname] = dim
        else:
            continue
        # the matrices held in part and gathered on use: contiguous blocks
        for lname, dim in ts.gathered.items():
            layer = getattr(module, lname)
            size = layer.weight.shape[dim]
            blocks = _blocks(size, t)
            _hold(layer, "weight", dim, blocks[rank])
            leaves[f"{name}{lname}.weight"] = TensorLeaf(dim, size, blocks,
                                                         group, rank)
        if ts.split or ts.gathered:
            module.tensor = ts
    ensure_layout(model).leaves.update(leaves)
    return model


# ---------------------------------------------------------------- compute

def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def whole_linear(x: torch.Tensor, layer, ts: Optional[TensorSplit],
                 lname: str) -> torch.Tensor:
    """``layer`` applied whole in ``x``'s dtype; a matrix held in part is
    gathered first."""
    w = layer.weight
    if ts is not None and lname in ts.gathered:
        w = _GatherOnUse.apply(w, ts.gathered[lname], ts.group)
    return F.linear(x, w.to(x.dtype), _cast(layer.bias, x.dtype))


def column(x: torch.Tensor, layer, ts: Optional[TensorSplit],
           lname: str) -> torch.Tensor:
    """The column-parallel matmul of a split block (this rank's rows of
    the output), else the whole one."""
    if ts is None or not ts.split:
        return whole_linear(x, layer, ts, lname)
    x = _CopyToTensor.apply(x, ts.group)
    bias = layer.bias
    if bias is not None:
        bias = _SliceReplicated.apply(bias, ts.inner, 0, ts.group)
    return F.linear(x, layer.weight.to(x.dtype), _cast(bias, x.dtype))


def row(x: torch.Tensor, layer, ts: Optional[TensorSplit],
        lname: str) -> torch.Tensor:
    """The row-parallel matmul of a split block (partial products summed
    over the group, then the bias), else the whole one."""
    if ts is None or not ts.split:
        return whole_linear(x, layer, ts, lname)
    w = layer.weight
    if not ts.row_held:
        w = _SliceReplicated.apply(w, ts.row_index, 1, ts.group)
    y = _ReduceFromTensor.apply(F.linear(x, w.to(x.dtype)), ts.group)
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


def local_heads(heads: int, ts: Optional[TensorSplit]) -> int:
    if ts is None or not ts.split or ts.gather_qkv:
        return heads
    return heads // ts.size


def gather_qkv(qkv: torch.Tensor, ts: Optional[TensorSplit]) -> torch.Tensor:
    """The whole ``[q | k | v]`` projection of an attention whose heads are
    not cut (its ranks' contiguous blocks gathered); else ``qkv``."""
    if ts is None or not ts.gather_qkv:
        return qkv
    return _GatherLastDim.apply(qkv, ts.group)


def own_columns(o: torch.Tensor, ts: Optional[TensorSplit]) -> torch.Tensor:
    """This rank's columns of a whole attention output (the input of its
    block of the row-cut ``out_proj``) where the heads are not cut; else
    ``o``."""
    if ts is None or not ts.gather_qkv:
        return o
    per = o.shape[-1] // ts.size
    return o.narrow(-1, int(ts.row_index[0]), per)


# ------------------------------------------------------- one-process play

def run_block_local(block, x: torch.Tensor, tensor: int) -> torch.Tensor:
    """A pre-LN ``models.layers.Block`` (no DropPath) with its ``tensor``
    ranks played in one process, on one device: each rank's heads go
    through the attention kernel on its ``[q | k | v]`` rows of the whole
    ``Wqkv`` and its MLP columns through ``fc1`` / ``fc2``; the
    row-parallel partials are summed in ``x``'s dtype, as the group's
    all-reduce sums them, before the biases.  Autograd reaches the whole
    weights, so their gradients hold every rank's part.  The counterpart
    of ``ops.ring_attention.run_ring_local`` for ``mesh.tensor``."""
    from avion_tpu_torch.ops.flash_attention import flash_attention_fused_qkv

    attn, mlp, dtype = block.attn, block.mlp, x.dtype
    if attn.heads % tensor:
        raise ValueError(f"mesh.tensor={tensor} does not divide the "
                         f"{attn.heads} heads")
    width = x.shape[-1]
    heads = attn.heads // tensor
    h = block.ln_1(x)
    rows = _head_rows(width, tensor)
    cols = _blocks(width, tensor)
    y = 0
    for r in range(tensor):
        w = attn.Wqkv.weight.index_select(0, rows[r].to(x.device))
        b = attn.Wqkv.bias.index_select(0, rows[r].to(x.device))
        qkv = F.linear(h, w.to(dtype), b.to(dtype))
        o = flash_attention_fused_qkv(qkv, heads, x.shape[1],
                                      causal=attn.causal)
        wo = attn.out_proj.weight.index_select(1, cols[r].to(x.device))
        y = y + F.linear(o, wo.to(dtype))
    x = x + block.ls_1(y + attn.out_proj.bias.to(dtype))
    h = block.ln_2(x)
    inner = _blocks(mlp.fc1.weight.shape[0], tensor)
    y = 0
    for r in range(tensor):
        idx = inner[r].to(x.device)
        a = mlp.act(F.linear(h, mlp.fc1.weight.index_select(0, idx).to(dtype),
                             mlp.fc1.bias.index_select(0, idx).to(dtype)))
        y = y + F.linear(a, mlp.fc2.weight.index_select(1, idx).to(dtype))
    return x + block.ls_2(y + mlp.fc2.bias.to(dtype))
