"""Parameter sharding and gradient reduction over the mesh
(``avion_tpu.parallel.sharding``).

- ``fsdp`` shards parameters (and so gradients and optimizer state) at
  rest with FSDP2 (``fully_shard``; hybrid over a 2-D device mesh
  ``(replicate, shard)`` when other axes are wider than 1), on the dim
  that the JAX package's ``_spec_for_param`` picks (:func:`shard_dim`).
  A tensor that rule replicates (ndim <= 1, or no dim of 128 or more) is
  left out of FSDP and its gradient all-reduced by :class:`Parallel`.
- Without ``fsdp``, DDP averages the gradients over the world, or under
  ``pp``, ``ep`` or ``tensor`` over the ranks of one index of those
  (``Mesh.replica_group``), which hold the same parts.
- ``tensor`` cuts the blocks first (``parallel.tensor_parallel``); FSDP2
  then shards each rank's part along the dim the JAX rule gives ``fsdp``
  on the whole parameter (the largest other than the tensor dim).
- ``ep`` cuts a MoE layer's expert leaves along dim 0 (the JAX rule:
  ``expert`` leaves ``[E, ...]`` shard dim 0 over ``ep``), and ``fsdp``
  takes its usual dim of the rest; ``pp`` keeps a pipelined stack's stage
  leaves on their stage (``parallel.pipeline``).  Every leaf JAX
  replicates over ``pp`` or ``ep`` gets the same gradient on each of those
  ranks (the pipeline broadcasts its input's gradient, the MoE layer
  computes its router alike on every ``ep`` rank), so the batch group's
  DDP or FSDP2 at one ``(pp, ep, tensor)`` index finishes every leaf.
- The world average is the gradient of the global loss because the
  losses gather with a summing backward and the sequence-parallel pooling
  sums its cotangents (``losses.losses``, ``models.vit``).

:func:`make_global_batch` is the counterpart of the JAX function of that
name: this rank's rows of a batch along dim 0 (or dim 1 for the
microbatch-major batches of cached accumulation).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from avion_tpu_torch.parallel.mesh import (DATA_AXIS, EP_AXIS, FSDP_AXIS,
                                           PP_AXIS, SP_AXIS, TENSOR_AXIS,
                                           Mesh, local_batch_slice)
from avion_tpu_torch.parallel.pipeline import (pipeline_parallelize,
                                               placeholder_names)
from avion_tpu_torch.parallel.tensor_parallel import (TensorLeaf,
                                                      _blocks, ensure_layout,
                                                      tensor_layout,
                                                      tensor_parallelize)


def is_dtensor(t) -> bool:
    return hasattr(t, "to_local") and hasattr(t, "placements")


def local(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's local shard; any other tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def shard_dim(shape: Sequence[int], fsdp: int,
              taken: Optional[int] = None) -> Optional[int]:
    """The dim ``fsdp`` shards (``_spec_for_param``'s rule), or None to
    replicate: ndim <= 1 or every dim below 128 replicate; otherwise the
    largest dim that divides by ``fsdp`` and is at least ``8 * fsdp``,
    other than ``taken`` (the dim ``tensor`` shards).  ``shape`` is the
    whole parameter's."""
    if len(shape) <= 1 or max(shape) < 128 or fsdp <= 1:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if i != taken and shape[i] % fsdp == 0 and shape[i] >= fsdp * 8:
            return i
    return None


def fsdp_dims(model: torch.nn.Module, fsdp: int) -> Dict[str, Optional[int]]:
    """Each parameter's ``fsdp`` dim by name (:func:`shard_dim` on its whole
    shape; under ``mesh.tensor`` the tensor dim is taken, and FSDP2 cuts
    this rank's part along the same dim)."""
    layout = tensor_layout(model)
    dims = {}
    for name, p in model.named_parameters():
        leaf = layout.leaves.get(name) if layout is not None else None
        shape = layout.global_shape(name, p.shape) if layout else p.shape
        dims[name] = shard_dim(shape, fsdp,
                               leaf.dim if leaf is not None else None)
    return dims


def make_global_batch(mesh: Mesh, batch: Dict[str, torch.Tensor],
                      batch_dim: int = 0) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global ``batch`` along ``batch_dim`` (its batch
    group's block; the ``sp`` ranks of a group get the same rows)."""
    return {k: v.narrow(batch_dim, *_start_len(mesh, v.shape[batch_dim]))
            for k, v in batch.items()}


def share_rows(mesh: Mesh, batch: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """``batch`` as the first rank of this rank's batch group has it,
    broadcast over the ranks that read the same rows (``Mesh.row_group``:
    its ``pp``, ``sp``, ``ep`` and ``tensor`` ranks).  Each rank's loader
    decodes those rows, but host augmentation draws differ between
    processes, and the ranks of a pipeline, an expert group or a tensor
    group must compute on one batch, as the devices of one JAX host do."""
    if mesh.row_group is None:
        return batch
    src = mesh.rank_at(**dict(mesh.coords, pp=0, sp=0, ep=0, tensor=0))
    out = {}
    for k, v in batch.items():
        if torch.is_tensor(v):
            v = v.contiguous()
            dist.broadcast(v, src=src, group=mesh.row_group)
        out[k] = v
    return out


def _start_len(mesh: Mesh, n: int) -> tuple:
    rows = local_batch_slice(mesh, n)
    return rows.start, rows.stop - rows.start


def _device_mesh(mesh: Mesh, device: torch.device):
    """FSDP2's mesh: ``(shard,)`` over fsdp, or ``(replicate, shard)`` with
    the data and sp ranks replicating; rank r at the coordinates it has in
    :class:`Mesh`.  Under ``pp``, ``ep`` or ``tensor`` it is the sub-mesh of
    this rank's index of those (the ranks that hold the same parts)."""
    from torch.distributed.device_mesh import DeviceMesh

    d, f, pp, sp, ep, t = (mesh.shape[a] for a in (
        DATA_AXIS, FSDP_AXIS, PP_AXIS, SP_AXIS, EP_AXIS, TENSOR_AXIS))
    ranks = torch.as_tensor(mesh.layout).reshape(d, f, pp, sp, ep, t).permute(
        0, 3, 1, 2, 4, 5).reshape(d, sp, f, pp * ep * t)
    t = pp * ep * t
    if t == 1:
        if d * sp == 1:
            return DeviceMesh(device.type, ranks.reshape(f),
                              mesh_dim_names=("shard",))
        return DeviceMesh(device.type, ranks.reshape(d * sp, f),
                          mesh_dim_names=("replicate", "shard"))
    if d * sp == 1:
        return DeviceMesh(device.type, ranks.reshape(f, t),
                          mesh_dim_names=("shard", "tensor"))["shard"]
    return DeviceMesh(device.type, ranks.reshape(d * sp, f, t),
                      mesh_dim_names=("replicate", "shard", "tensor"))[
        "replicate", "shard"]


def replicated_params(model: torch.nn.Module, fsdp: int) -> list:
    dims = fsdp_dims(model, fsdp)
    return [p for n, p in model.named_parameters() if dims[n] is None]


def expert_parallelize(model: torch.nn.Module, mesh: Mesh
                       ) -> torch.nn.Module:
    """Give each MoE layer its routing group (the batch group: JAX routes
    the global batch) and, over ``ep``, hold its E / ep experts (dim 0 of
    every ``expert`` leaf) and list them in the model's layout."""
    from avion_tpu_torch.ops.moe import MoEMlp

    layers = [(n, m) for n, m in model.named_modules()
              if isinstance(m, MoEMlp)]
    if not layers:
        return model
    ep, group = mesh.shape[EP_AXIS], mesh.ep_group
    rank = mesh.coords[EP_AXIS]
    leaves = {}
    for name, moe in layers:
        if mesh.n_batch_shards > 1:
            moe.batch_group = mesh.batch_group
        if ep == 1:
            continue
        if moe.experts % ep:
            raise ValueError(f"mesh.ep={ep} does not divide the "
                             f"{moe.experts} experts of {name}")
        blocks = _blocks(moe.experts, ep)
        for leaf in ("expert_fc1", "expert_fc1_bias", "expert_fc2",
                     "expert_fc2_bias"):
            p = getattr(moe, leaf)
            part = p.detach()[blocks[rank]].contiguous()
            setattr(moe, leaf, torch.nn.Parameter(
                part, requires_grad=p.requires_grad))
            leaves[f"{name}.{leaf}" if name else leaf] = TensorLeaf(
                0, moe.experts, blocks, group, rank, EP_AXIS)
        moe.ep = (group, rank, ep)
    if leaves:
        ensure_layout(model).leaves.update(leaves)
    return model


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Cut ``model`` in place over ``tensor`` (``parallel.tensor_parallel``),
    ``ep`` (:func:`expert_parallelize`) and ``pp``
    (``parallel.pipeline.pipeline_parallelize``) and shard it over ``fsdp``
    (FSDP2) where the mesh has them; build the optimizer after this, over
    the sharded parameters."""
    tensor_parallelize(model, mesh)
    expert_parallelize(model, mesh)
    pipeline_parallelize(model, mesh)
    fsdp = mesh.shape[FSDP_AXIS]
    if fsdp == 1:
        return model
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    dims = fsdp_dims(model, fsdp)
    by_id = {id(p): dims[n] for n, p in model.named_parameters()}
    device = next(model.parameters()).device
    params = dict(model.named_parameters())
    ignored = set(replicated_params(model, fsdp)) | {
        params[n] for n in placeholder_names(model)}
    fully_shard(model, mesh=_device_mesh(mesh, device),
                shard_placement_fn=lambda p: Shard(by_id[id(p)]),
                ignored_params=ignored)
    return model


class Parallel:
    """How one rank's model takes part in the mesh: ``model`` is what the
    step calls (DDP's wrapper, or the FSDP2 module itself), ``module`` the
    module whose attributes it reads.  After a backward that should
    synchronize, :meth:`finish_backward` all-reduces the gradients FSDP2
    does not own (over ``Mesh.replica_group``, as DDP)."""

    def __init__(self, mesh: Mesh, module: torch.nn.Module,
                 find_unused: bool = False):
        self.mesh, self.module = mesh, module
        self.fsdp = mesh.shape[FSDP_AXIS] > 1
        params = dict(module.named_parameters())
        # the stage leaves this rank holds as placeholders (other pp stages)
        self.placeholders = [params[n] for n in placeholder_names(module)]
        held = {id(p) for p in self.placeholders}
        self.replicated = ([p for p in replicated_params(
            module, mesh.shape[FSDP_AXIS]) if id(p) not in held]
            if self.fsdp else [])
        if self.fsdp or not dist.is_initialized():
            self.model = module
        else:
            from torch.nn.parallel import DistributedDataParallel

            DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
                module, placeholder_names(module))
            device = next(module.parameters()).device
            self.model = DistributedDataParallel(
                module, device_ids=[device] if device.type == "cuda" else None,
                find_unused_parameters=find_unused,
                process_group=mesh.replica_group)

    @contextlib.contextmanager
    def no_sync(self):
        """Backwards inside keep their gradients local (accumulation)."""
        if self.fsdp:
            self.module.set_requires_gradient_sync(False)
            try:
                yield
            finally:
                self.module.set_requires_gradient_sync(True)
        elif self.model is not self.module:
            with self.model.no_sync():
                yield
        else:
            yield

    def finish_backward(self) -> None:
        """Average the gradients of the parameters FSDP2 leaves replicated
        over the world (DDP and FSDP2 reduce the others).  The ranks first
        agree on which of them have a gradient: one that has none here but
        has one on another rank counts as zeros (as DDP counts it), one
        that has none anywhere keeps none (the MIR loss leaves the logit
        scale without one).  The placeholders of other stages' leaves get
        zero gradients, so every rank's optimizer state has the same
        entries."""
        for p in self.placeholders:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if not self.replicated:
            return
        params = self.replicated
        has = torch.tensor([p.grad is not None for p in params],
                           dtype=torch.int32, device=params[0].device)
        dist.all_reduce(has, op=dist.ReduceOp.MAX,
                        group=self.mesh.replica_group)
        params = [p for p, h in zip(params, has.tolist()) if h]
        if not params:
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh.replica_group)
        flat /= dist.get_world_size(self.mesh.replica_group)
        for g, new in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(new.view_as(g))


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of a sharded tensor (a collective: every rank calls it);
    any other tensor itself."""
    return t.full_tensor() if is_dtensor(t) else t


def shard_like(full: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``full`` cut as ``ref`` is sharded (a sharded tensor of this rank's
    shard), or ``full`` when ``ref`` is not sharded."""
    if not is_dtensor(ref):
        return full
    from torch.distributed.tensor import DTensor

    piece = full.to(ref.device)
    mesh = ref.device_mesh
    coord = mesh.get_coordinate()
    for mesh_dim, placement in enumerate(ref.placements):
        if placement.is_shard():
            piece = piece.chunk(mesh.size(mesh_dim),
                                placement.dim)[coord[mesh_dim]]
    return DTensor.from_local(piece.contiguous(), mesh, ref.placements,
                              run_check=False)
