"""The port's mesh, shard rule and host sharding against the JAX package's,
without processes: rank r's coordinates against JAX device r's in
``make_mesh``, ``shard_dim`` against ``_spec_for_param`` over CLIP_TINY's
parameter tree, and each batch group's index order against the JAX
loader's ``_host_order``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avion_tpu.data.loader import DataLoader as JaxDataLoader
from avion_tpu.models.clip import CLIP as JaxCLIP
from avion_tpu.parallel import make_mesh as jax_make_mesh
from avion_tpu.parallel.mesh import MESH_AXES as JAX_AXES
from avion_tpu.parallel.sharding import _spec_for_param
from avion_tpu_torch.data.loader import DataLoader
from avion_tpu_torch.parallel.mesh import (MESH_AXES, axis_sizes,
                                           local_batch_slice, make_mesh,
                                           mesh_coords)
from avion_tpu_torch.parallel.sharding import shard_dim

CLIP_TINY = dict(embed_dim=32, image_size=32, patch_size=16, num_frames=2,
                 vision_width=64, vision_layers=2, vision_heads=2,
                 context_length=77, vocab_size=49408, text_width=32,
                 text_heads=2, text_layers=2)


@pytest.mark.parametrize("sizes", [
    dict(data=4, fsdp=2), dict(data=2, sp=4), dict(data=2, tensor=4),
    dict(data=2, fsdp=2, tensor=2), dict(data=2, sp=2, tensor=2)])
def test_rank_coordinates_match_jax_devices(sizes):
    assert MESH_AXES == JAX_AXES
    mesh = jax_make_mesh(**{"tensor": 1, **sizes})
    shape = axis_sizes(8, **sizes)
    assert tuple(shape.values()) == mesh.devices.shape
    for dev in jax.devices()[:8]:
        where = np.argwhere(mesh.devices == dev)[0]
        assert mesh_coords(dev.id, shape) == dict(zip(MESH_AXES, where))


def test_batch_groups_and_rows():
    shape = axis_sizes(8, data=2, sp=4)
    for rank in range(8):
        m = make_mesh(data=2, sp=4, world=8, rank=rank)
        assert m.coords == mesh_coords(rank, shape)
        assert m.n_batch_shards == 2 and m.batch_index == rank // 4
        assert local_batch_slice(m, 16) == slice(8 * (rank // 4),
                                                 8 * (rank // 4) + 8)
        assert m.ranks(sp=rank % 4) == [rank % 4, 4 + rank % 4]


@pytest.mark.parametrize("sizes", [
    dict(data=2, pp=2, ep=2), dict(data=2, pp=4), dict(data=2, fsdp=2, pp=2),
    dict(data=2, ep=4), dict(data=1, pp=2, sp=2, ep=2)],
    ids=["d2-pp2-ep2", "d2-pp4", "d2-f2-pp2", "d2-ep4", "pp2-sp2-ep2"])
def test_pp_and_ep_ranks_match_jax_devices(sizes):
    """``pp`` and ``ep`` in JAX's axis order: rank r at JAX device r's
    coordinates; a pipeline's ranks in stage order; the ``pp`` and ``ep``
    ranks of a batch group read the same rows (JAX's ``BATCH_AXES`` are
    ``(data, fsdp)``)."""
    mesh = jax_make_mesh(**{"tensor": 1, **sizes})
    devices = np.vectorize(lambda d: d.id)(mesh.devices)
    for rank in range(8):
        m = make_mesh(**sizes, world=8, rank=rank)
        where = np.argwhere(devices == rank)[0]
        assert m.coords == dict(zip(MESH_AXES, (int(i) for i in where)))
        stages = devices[tuple(m.coords[a] if a != "pp" else slice(None)
                               for a in MESH_AXES)]
        assert m.pp_ranks == [int(r) for r in stages]
        assert m.batch_index == (m.coords["data"] * m.shape["fsdp"]
                                 + m.coords["fsdp"])
        per = 16 // m.n_batch_shards
        assert local_batch_slice(m, 16) == slice(per * m.batch_index,
                                                 per * (m.batch_index + 1))


def test_tensor_groups_and_rows():
    """data=2 x sp=2 x tensor=2: the tensor ranks of a batch group read its
    rows; each group kind holds the ranks of one index of the other axes."""
    for rank in range(8):
        m = make_mesh(data=2, sp=2, tensor=2, world=8, rank=rank)
        assert m.coords == mesh_coords(rank, m.shape)
        assert m.batch_index == rank // 4
        assert local_batch_slice(m, 16) == slice(8 * (rank // 4),
                                                 8 * (rank // 4) + 8)
        c = m.coords
        # the losses' group, the ring, the tensor group, the replicas
        assert m.ranks(sp=c["sp"], tensor=c["tensor"]) == [
            r for r in range(8) if r % 4 == rank % 4]
        assert m.ranks(data=c["data"], tensor=c["tensor"]) == [
            r for r in range(8) if r // 4 == rank // 4 and r % 2 == rank % 2]
        assert m.ranks(data=c["data"], sp=c["sp"]) == [
            r for r in range(8) if r // 2 == rank // 2]
        assert m.ranks(tensor=c["tensor"]) == list(range(rank % 2, 8, 2))


@pytest.mark.parametrize("fsdp", [2, 4])
def test_fsdp_shard_rule_matches_spec_for_param(fsdp):
    model = JaxCLIP(**CLIP_TINY, use_flash=False, dtype=jnp.float32)
    params = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 2, 32, 32, 3)),
                           jnp.zeros((1, 77), jnp.int32)))["params"]
    mesh = jax_make_mesh(data=8 // fsdp, fsdp=fsdp, tensor=1)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    sharded = 0
    for path, leaf in leaves:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        spec = tuple(_spec_for_param(name, leaf.shape, mesh))
        want = spec.index("fsdp") if "fsdp" in spec else None
        assert shard_dim(leaf.shape, fsdp) == want, (name, leaf.shape)
        sharded += want is not None
    assert 0 < sharded < len(leaves)


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("world", [2, 4])
def test_host_order_matches_jax_loader(world, drop_last):
    ds = _Sized(37)
    for group in range(world):
        kw = dict(batch_size=4 * world, shuffle=True, drop_last=drop_last,
                  num_workers=0, seed=5, process_index=group,
                  process_count=world)
        ours = DataLoader(ds, **kw)
        ref = JaxDataLoader(ds, **kw)
        for epoch in (0, 1):
            np.testing.assert_array_equal(ours._order(epoch),
                                          ref._host_order(epoch))
        assert len(ours) == len(ref)
        assert ours.local_batch == ref.local_batch == 4
