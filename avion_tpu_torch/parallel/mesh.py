"""The mesh of process groups (``avion_tpu.parallel.mesh``).

One process drives one card.  The JAX package lays its devices out as
``(data, fsdp, pp, sp, ep, tensor)`` with ``tensor`` fastest; here rank r
takes the mesh coordinates of JAX device r in that layout, so rank r of a
``torch.distributed`` world and device r of a JAX mesh of the same shape
hold the same rows of the batch, the same sequence shard and the same
tensor shard.

- ``data`` and ``fsdp`` are the batch axes: the global batch is cut into
  ``data * fsdp`` batch groups (:attr:`Mesh.n_batch_shards`), and the losses
  gather over the ranks of one ``(sp, tensor)`` index
  (:attr:`Mesh.batch_group`) over the ranks of one ``(pp, sp, ep,
  tensor)`` index.  The ``pp`` and ``ep`` ranks of a batch group hold the
  same rows, as the JAX package's ``BATCH_AXES`` are ``(data, fsdp)``.
- ``sp`` cuts the sequence-parallel visual tower's tokens: the ranks of one
  ``(data, fsdp, tensor)`` index form the ring of ``ops.ring_attention``
  (:attr:`Mesh.sp_group`) and read the same clips.  In a model without a
  sequence-parallel tower they hold replicas and compute the same step, as
  the JAX devices of that axis do.
- ``tensor`` splits the blocks' heads and MLP columns (Megatron's layout,
  ``parallel.tensor_parallel``) over the ranks of one ``(data, fsdp, sp)``
  index (:attr:`Mesh.tensor_group`); they read the same rows.  The
  gradients are averaged over the ranks of one ``(pp, ep, tensor)`` index
  (:attr:`Mesh.replica_group`), which hold the same parameters.
- ``pp`` cuts a pipelined tower's or decoder's layers into stages
  (``parallel.pipeline``, ``parallel.pipeline_gated``): the ranks of one
  ``(data, fsdp, sp, ep, tensor)`` index form the pipeline
  (:attr:`Mesh.pp_group`, in stage order :attr:`Mesh.pp_ranks`) and read
  the same rows.
- ``ep`` cuts the experts of a mixture-of-experts MLP (``ops.moe``): the
  ranks of one ``(data, fsdp, pp, sp, tensor)`` index
  (:attr:`Mesh.ep_group`) read the same rows and each runs E / ep experts.
- Without a pipelined or MoE model, ``pp`` and ``ep`` ranks hold replicas
  and compute the same step, as the JAX devices of those axes do.
- ``fsdp`` also shards parameters and optimizer state
  (``parallel.sharding``).
- ``dcn_data`` places whole nodes as the outer blocks of ``data``
  (:func:`hybrid_device_array`, the JAX package's multi-slice layout with a
  node for a slice): every collective but the gradient reduction stays
  inside a node.  torchrun numbers a node's ranks contiguously, so the
  layout is the plain one; the checks are JAX's.

:func:`use_mesh` makes a mesh current (the JAX package's ``jax.set_mesh``);
the sequence-parallel layers read the current one's ``sp`` group.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch.distributed as dist

DATA_AXIS, FSDP_AXIS, PP_AXIS, SP_AXIS, EP_AXIS, TENSOR_AXIS = (
    "data", "fsdp", "pp", "sp", "ep", "tensor")
MESH_AXES = (DATA_AXIS, FSDP_AXIS, PP_AXIS, SP_AXIS, EP_AXIS, TENSOR_AXIS)
# the axes whose ranks hold different parameters: the gradients are averaged
# over the ranks of one index of them
MODEL_AXES = (PP_AXIS, EP_AXIS, TENSOR_AXIS)


def mesh_coords(rank: int, shape: Dict[str, int]) -> Dict[str, int]:
    """Coordinates of ``rank`` in the (data, fsdp, pp, sp, ep, tensor)
    layout, ``tensor`` fastest (``numpy.unravel_index`` of
    ``make_mesh``'s reshape)."""
    coords = {}
    for axis in reversed(MESH_AXES):
        rank, coords[axis] = divmod(rank, shape[axis])
    return {a: coords[a] for a in MESH_AXES}


def axis_sizes(world: int, data: int = -1, fsdp: int = 1, pp: int = 1,
               sp: int = 1, ep: int = 1, tensor: int = 1) -> Dict[str, int]:
    """Every axis's size over ``world`` ranks; ``data=-1`` takes what the
    others leave."""
    rest = fsdp * pp * sp * ep * tensor
    if data == -1:
        if world % rest:
            raise ValueError(f"{world} ranks do not divide by "
                             f"fsdp*pp*sp*ep*tensor = {rest}")
        data = world // rest
    if data * rest != world:
        raise ValueError(f"mesh {data}x{fsdp}x{pp}x{sp}x{ep}x{tensor} != "
                         f"{world} ranks")
    return dict(zip(MESH_AXES, (data, fsdp, pp, sp, ep, tensor)))


def group_devices_by_slice(devices: Sequence, dcn_data: int) -> list:
    """Partition ``devices`` into ``dcn_data`` equal slice groups (the JAX
    package's rule): by ``slice_index``, else by ``process_index`` blocks
    (consecutive processes packed into a slice), else contiguous blocks;
    groups in the order of their smallest key."""
    n = len(devices)
    if n % dcn_data:
        raise ValueError(f"{n} ranks do not divide into dcn_data = "
                         f"{dcn_data} equal groups")
    per = n // dcn_data

    def _try(keyf):
        groups: dict = {}
        for d in devices:
            k = keyf(d)
            if k is None:
                return None
            groups.setdefault(k, []).append(d)
        if len(groups) == dcn_data and all(
                len(g) == per for g in groups.values()):
            return [groups[k] for k in sorted(groups)]
        if len(groups) % dcn_data == 0 and len(groups) > dcn_data:
            keys = sorted(groups)
            stride = len(keys) // dcn_data
            merged = [[d for k in keys[i * stride:(i + 1) * stride]
                       for d in groups[k]] for i in range(dcn_data)]
            if all(len(g) == per for g in merged):
                return merged
        return None

    got = _try(lambda d: getattr(d, "slice_index", None))
    if got is None and dcn_data > 1:
        got = _try(lambda d: getattr(d, "process_index", None))
    if got is None:
        devices = list(devices)
        got = [devices[i * per:(i + 1) * per] for i in range(dcn_data)]
    return got


def hybrid_device_array(devices, data, fsdp, pp, sp, ep, tensor,
                        dcn_data) -> np.ndarray:
    """The multi-slice layout: slice s owns data rows [s * data / dcn,
    (s + 1) * data / dcn), every other axis inside a slice."""
    if data % dcn_data:
        raise ValueError(f"data axis {data} must be a multiple of dcn_data "
                         f"{dcn_data}")
    groups = group_devices_by_slice(devices, dcn_data)
    blocks = []
    for g in groups:
        block = np.empty(len(g), dtype=object)
        block[:] = g
        blocks.append(block.reshape(data // dcn_data, fsdp, pp, sp, ep,
                                    tensor))
    return np.stack(blocks).reshape(data, fsdp, pp, sp, ep, tensor)


@dataclass(frozen=True)
class RankDevice:
    """A rank as a device of :func:`group_devices_by_slice`: its node
    (``slice_index``; None on one node) and its process."""

    id: int
    slice_index: Optional[int]
    process_index: int


def rank_devices(world: int) -> list:
    """The world's ranks with their nodes: torchrun numbers the ranks of a
    node contiguously, ``LOCAL_WORLD_SIZE`` of them."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    multi = 0 < local < world
    return [RankDevice(r, r // local if multi else None, r)
            for r in range(world)]


@dataclass
class Mesh:
    """This rank's place in the mesh and its process groups: the losses'
    ``batch_group`` (the ranks of its ``(pp, sp, ep, tensor)`` index), the
    ring's ``sp_group`` (of its ``(data, fsdp, pp, ep, tensor)`` index),
    the ``tensor_group`` (of its ``(data, fsdp, pp, sp, ep)`` index), the
    pipeline's ``pp_group`` (of its ``(data, fsdp, sp, ep, tensor)``
    index; ``pp_ranks`` its global ranks by stage), the experts'
    ``ep_group`` (of its ``(data, fsdp, pp, sp, tensor)`` index) and the
    gradients' ``replica_group`` (of its ``(pp, ep, tensor)`` index; None
    while those are 1, where it is the world) and the ``row_group`` of the
    ranks that read its rows (of its ``(data, fsdp)`` index; None while
    ``pp``, ``sp``, ``ep`` and ``tensor`` are 1).  None in a world of one
    process, where every collective is the identity.  ``layout`` holds
    each position's rank."""

    shape: Dict[str, int]
    rank: int = 0
    coords: Dict[str, int] = field(default_factory=dict)
    batch_group: Optional[object] = None
    sp_group: Optional[object] = None
    tensor_group: Optional[object] = None
    replica_group: Optional[object] = None
    pp_group: Optional[object] = None
    ep_group: Optional[object] = None
    row_group: Optional[object] = None
    layout: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.layout is None:
            self.layout = np.arange(self.size).reshape(
                [self.shape[a] for a in MESH_AXES])
        if not self.coords:
            self.coords = self.coords_of(self.rank)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def n_batch_shards(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[FSDP_AXIS]

    @property
    def batch_index(self) -> int:
        """This rank's batch group: its (data, fsdp) index."""
        return (self.coords[DATA_AXIS] * self.shape[FSDP_AXIS]
                + self.coords[FSDP_AXIS])

    def coords_of(self, rank: int) -> Dict[str, int]:
        where = np.argwhere(self.layout == rank)[0]
        return dict(zip(MESH_AXES, (int(i) for i in where)))

    def ranks(self, **fixed: int) -> list:
        """The global ranks whose coordinates match ``fixed``, in order."""
        index = tuple(fixed.get(a, slice(None)) for a in MESH_AXES)
        return sorted(int(r) for r in np.asarray(self.layout[index]).flat)

    @property
    def pp_ranks(self) -> list:
        """The global ranks of this rank's pipeline, stage 0 first."""
        return [self.rank_at(**dict(self.coords, pp=i))
                for i in range(self.shape[PP_AXIS])]

    def rank_at(self, **coords: int) -> int:
        return int(self.layout[tuple(coords[a] for a in MESH_AXES)])


def _make_groups(mesh: Mesh, fixed: Sequence[str]):
    """One process group for every index of the ``fixed`` axes (row-major,
    the same calls on every rank); returns this rank's."""
    mine = None
    for index in itertools.product(*(range(mesh.shape[a]) for a in fixed)):
        where = dict(zip(fixed, index))
        group = dist.new_group(mesh.ranks(**where))
        if all(mesh.coords[a] == i for a, i in where.items()):
            mine = group
    return mine


def make_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1, sp: int = 1,
              pp: int = 1, ep: int = 1, dcn_data: int = 1,
              world: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The mesh over the initialized process group (or ``world`` ranks,
    this one ``rank``, without one).  Every rank must call it, in the same
    order, since it creates the groups."""
    initialized = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if initialized else 1
    if rank is None:
        rank = dist.get_rank() if initialized else 0
    shape = axis_sizes(world, data, fsdp, pp, sp, ep, tensor)
    layout = None
    if dcn_data > 1:
        devices = rank_devices(world)
        nodes = {d.slice_index for d in devices} - {None}
        if nodes and len(nodes) != dcn_data:
            raise ValueError(f"mesh.dcn_data={dcn_data} over {len(nodes)} "
                             f"nodes: each node is one slice of the data "
                             f"axis")
        layout = np.vectorize(lambda d: d.id, otypes=[int])(
            hybrid_device_array(devices, *shape.values(), dcn_data))
    mesh = Mesh(shape, rank, layout=layout)
    if initialized and world > 1:
        # every rank creates every group, in one order
        mesh.batch_group = _make_groups(mesh, (PP_AXIS, SP_AXIS, EP_AXIS,
                                               TENSOR_AXIS))
        mesh.sp_group = _make_groups(mesh, _others(SP_AXIS))
        if shape[TENSOR_AXIS] > 1:
            mesh.tensor_group = _make_groups(mesh, _others(TENSOR_AXIS))
        if shape[PP_AXIS] > 1:
            mesh.pp_group = _make_groups(mesh, _others(PP_AXIS))
        if shape[EP_AXIS] > 1:
            mesh.ep_group = _make_groups(mesh, _others(EP_AXIS))
        if any(shape[a] > 1 for a in MODEL_AXES):
            mesh.replica_group = _make_groups(mesh, MODEL_AXES)
        if shape[SP_AXIS] > 1 or any(shape[a] > 1 for a in MODEL_AXES):
            mesh.row_group = _make_groups(mesh, (DATA_AXIS, FSDP_AXIS))
    return mesh


def _others(axis: str) -> tuple:
    return tuple(a for a in MESH_AXES if a != axis)


def mesh_from_config(cfg, world: Optional[int] = None,
                     rank: Optional[int] = None) -> Mesh:
    """From a ``MeshConfig`` over the initialized process group."""
    return make_mesh(cfg.data, cfg.fsdp, cfg.tensor, cfg.sp, cfg.pp, cfg.ep,
                     cfg.dcn_data, world=world, rank=rank)


def local_batch_slice(mesh: Mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch: its batch group's contiguous
    block (the ``sp`` and ``tensor`` ranks of a group share it)."""
    n = mesh.n_batch_shards
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide by "
                         f"{n} batch groups")
    per = global_batch // n
    return slice(mesh.batch_index * per, (mesh.batch_index + 1) * per)


_CURRENT: list = [None]


def current_mesh() -> Optional[Mesh]:
    return _CURRENT[0]


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` current inside the block."""
    old, _CURRENT[0] = _CURRENT[0], mesh
    try:
        yield mesh
    finally:
        _CURRENT[0] = old
