"""The mesh of process groups (``avion_tpu.parallel.mesh``).

One process drives one card.  The JAX package lays its devices out as
``(data, fsdp, pp, sp, ep, tensor)`` with ``tensor`` fastest; here rank r
takes the mesh coordinates of JAX device r in that layout, so rank r of a
``torch.distributed`` world and device r of a JAX mesh of the same shape
hold the same rows of the batch and the same sequence shard.

- ``data`` and ``fsdp`` are the batch axes: the global batch is cut into
  ``data * fsdp`` batch groups (:attr:`Mesh.n_batch_shards`), and the losses
  gather over the ranks of one ``sp`` index (:attr:`Mesh.batch_group`).
- ``sp`` cuts the visual tower's tokens: the ranks of one batch group form
  the ring of ``ops.ring_attention`` (:attr:`Mesh.sp_group`) and read the
  same clips.
- ``fsdp`` also shards parameters and optimizer state
  (``parallel.sharding``).
- ``pp``, ``ep``, ``tensor`` and ``dcn_data`` above 1 raise
  :class:`NotImplementedError`: they come with later slices.

:func:`use_mesh` makes a mesh current (the JAX package's ``jax.set_mesh``);
the sequence-parallel layers read the current one's ``sp`` group.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch.distributed as dist

DATA_AXIS, FSDP_AXIS, PP_AXIS, SP_AXIS, EP_AXIS, TENSOR_AXIS = (
    "data", "fsdp", "pp", "sp", "ep", "tensor")
MESH_AXES = (DATA_AXIS, FSDP_AXIS, PP_AXIS, SP_AXIS, EP_AXIS, TENSOR_AXIS)
# axes of later slices: the port raises on any of them above 1
LATER_AXES = {"pp": "the pipeline slice", "ep": "the mixture-of-experts "
              "slice", "tensor": "the tensor-parallel slice",
              "dcn_data": "the multi-slice slice"}


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


@dataclass
class Mesh:
    """This rank's place in the mesh and its process groups: the ranks of
    its ``sp`` index (``batch_group``, which the losses gather over) and
    of its batch group (``sp_group``, the ring); None in a world of one
    process, where every collective is the identity."""

    shape: Dict[str, int]
    rank: int = 0
    coords: Dict[str, int] = field(default_factory=dict)
    batch_group: Optional[object] = None
    sp_group: Optional[object] = None

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

    def ranks(self, **fixed: int) -> list:
        """The global ranks whose coordinates match ``fixed``, in order."""
        return [r for r in range(self.size)
                if all(mesh_coords(r, self.shape)[a] == v
                       for a, v in fixed.items())]


def make_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1, sp: int = 1,
              pp: int = 1, ep: int = 1, dcn_data: int = 1,
              world: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The mesh over the initialized process group (or ``world`` ranks,
    this one ``rank``, without one).  Every rank must call it, in the same
    order, since it creates the ``batch`` and ``sp`` groups."""
    for axis, size in (("pp", pp), ("ep", ep), ("tensor", tensor),
                       ("dcn_data", dcn_data)):
        if size != 1:
            raise NotImplementedError(
                f"mesh.{axis}={size}: the PyTorch port parallelizes data, "
                f"fsdp and sp; {axis} comes with {LATER_AXES[axis]}")
    initialized = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if initialized else 1
    if rank is None:
        rank = dist.get_rank() if initialized else 0
    shape = axis_sizes(world, data, fsdp, pp, sp, ep, tensor)
    mesh = Mesh(shape, rank, mesh_coords(rank, shape))
    if initialized and world > 1:
        # every rank creates every group, in one order
        for s in range(shape[SP_AXIS]):
            group = dist.new_group(mesh.ranks(sp=s))
            if mesh.coords[SP_AXIS] == s:
                mesh.batch_group = group
        for d in range(shape[DATA_AXIS]):
            for f in range(shape[FSDP_AXIS]):
                group = dist.new_group(mesh.ranks(data=d, fsdp=f))
                if (mesh.coords[DATA_AXIS], mesh.coords[FSDP_AXIS]) == (d, f):
                    mesh.sp_group = group
    return mesh


def mesh_from_config(cfg) -> Mesh:
    """From a ``MeshConfig`` over the initialized process group."""
    return make_mesh(cfg.data, cfg.fsdp, cfg.tensor, cfg.sp, cfg.pp, cfg.ep,
                     cfg.dcn_data)


def local_batch_slice(mesh: Mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch: its batch group's contiguous
    block (the ``sp`` ranks of a group share it)."""
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
