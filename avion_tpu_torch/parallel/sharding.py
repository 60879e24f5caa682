"""Parameter sharding and gradient reduction over the mesh
(``avion_tpu.parallel.sharding``).

- ``fsdp`` shards parameters (and so gradients and optimizer state) at
  rest with FSDP2 (``fully_shard``; hybrid over a 2-D device mesh
  ``(replicate, shard)`` when other axes are wider than 1), on the dim
  that the JAX package's ``_spec_for_param`` picks (:func:`shard_dim`).
  A tensor that rule replicates (ndim <= 1, or no dim of 128 or more) is
  left out of FSDP and its gradient all-reduced by :class:`Parallel`.
- Without ``fsdp``, DDP averages the gradients over the world, or under
  ``tensor`` over the ranks of one tensor index (``Mesh.replica_group``),
  which hold the same parts.
- ``tensor`` cuts the blocks first (``parallel.tensor_parallel``); FSDP2
  then shards each rank's part along the dim the JAX rule gives ``fsdp``
  on the whole parameter (the largest other than the tensor dim).
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

from avion_tpu_torch.parallel.mesh import (DATA_AXIS, FSDP_AXIS, SP_AXIS,
                                           TENSOR_AXIS, Mesh,
                                           local_batch_slice)
from avion_tpu_torch.parallel.tensor_parallel import (tensor_layout,
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


def _start_len(mesh: Mesh, n: int) -> tuple:
    rows = local_batch_slice(mesh, n)
    return rows.start, rows.stop - rows.start


def _device_mesh(mesh: Mesh, device: torch.device):
    """FSDP2's mesh: ``(shard,)`` over fsdp, or ``(replicate, shard)`` with
    the data and sp ranks replicating; rank r at the coordinates it has in
    :class:`Mesh`.  Under ``tensor`` it is the sub-mesh of this rank's
    tensor index (the ranks that hold the same parts)."""
    from torch.distributed.device_mesh import DeviceMesh

    d, f, sp, t = (mesh.shape[a] for a in (DATA_AXIS, FSDP_AXIS, SP_AXIS,
                                           TENSOR_AXIS))
    ranks = torch.as_tensor(mesh.layout).reshape(d, f, sp, t).permute(
        0, 2, 1, 3)
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


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Cut ``model`` in place over ``tensor`` (``parallel.tensor_parallel``)
    and shard it over ``fsdp`` (FSDP2) where the mesh has them; build the
    optimizer after this, over the sharded parameters."""
    tensor_parallelize(model, mesh)
    fsdp = mesh.shape[FSDP_AXIS]
    if fsdp == 1:
        return model
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    dims = fsdp_dims(model, fsdp)
    by_id = {id(p): dims[n] for n, p in model.named_parameters()}
    device = next(model.parameters()).device
    fully_shard(model, mesh=_device_mesh(mesh, device),
                shard_placement_fn=lambda p: Shard(by_id[id(p)]),
                ignored_params=set(replicated_params(model, fsdp)))
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
        self.replicated = (replicated_params(module, mesh.shape[FSDP_AXIS])
                           if self.fsdp else [])
        if self.fsdp or not dist.is_initialized():
            self.model = module
        else:
            from torch.nn.parallel import DistributedDataParallel

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
        scale without one)."""
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
