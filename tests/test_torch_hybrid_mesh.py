"""``mesh.dcn_data`` in the port (``parallel.mesh``) against the JAX
package's multi-slice layout (``avion_tpu.parallel.mesh``): the three
groupings of ``group_devices_by_slice`` (slice index, process blocks, the
contiguous fallback) on the fake devices of ``tests/test_hybrid_mesh.py``,
``hybrid_device_array``, rank r's coordinates against device r's in JAX's
hybrid mesh, the node check over torchrun's ``LOCAL_WORLD_SIZE``, JAX's
errors and ``MeshConfig``'s round trip."""

import jax
import numpy as np
import pytest

from avion_tpu.parallel import make_mesh as jax_make_mesh
from avion_tpu.parallel.mesh import group_devices_by_slice as jax_group
from avion_tpu.parallel.mesh import hybrid_device_array as jax_hybrid
from avion_tpu_torch.core.config import MeshConfig
from avion_tpu_torch.parallel.mesh import (MESH_AXES, group_devices_by_slice,
                                           hybrid_device_array, make_mesh,
                                           mesh_from_config, rank_devices)


class FakeDev:
    """A device with the TPU runtime's topology attributes."""

    def __init__(self, i, slice_index=None, process_index=0):
        self.id = i
        if slice_index is not None:
            self.slice_index = slice_index
        self.process_index = process_index


def _ids(groups):
    return [[d.id for d in g] for g in groups]


GROUPINGS = {
    "slice_index": (lambda: [FakeDev(i, slice_index=i % 4)
                             for i in range(16)], 4),
    "process_blocks": (lambda: [FakeDev(i, process_index=i // 2)
                                for i in range(8)], 2),
    "contiguous": (lambda: [FakeDev(i) for i in range(8)], 4),
    "unbalanced": (lambda: [FakeDev(i, slice_index=0 if i < 3 else 1)
                            for i in range(8)], 2),
}


@pytest.mark.parametrize("kind", sorted(GROUPINGS))
def test_grouping_matches_jax(kind):
    make, dcn = GROUPINGS[kind]
    devs = make()
    ours, theirs = group_devices_by_slice(devs, dcn), jax_group(devs, dcn)
    assert _ids(ours) == _ids(theirs)
    assert len(ours) == dcn and all(len(g) == len(devs) // dcn for g in ours)
    if kind == "slice_index":
        assert all(d.slice_index == s for s, g in enumerate(ours) for d in g)


@pytest.mark.parametrize("shape,dcn", [
    ((4, 2, 1, 1, 1, 2), 2), ((4, 1, 1, 2, 1, 2), 4), ((2, 2, 1, 2, 1, 2), 2)])
def test_hybrid_array_matches_jax(shape, dcn):
    devs = [FakeDev(i, slice_index=(i * 7) % dcn) for i in range(16)]
    ours = hybrid_device_array(devs, *shape, dcn_data=dcn)
    theirs = jax_hybrid(devs, *shape, dcn_data=dcn)
    assert ours.shape == theirs.shape == shape
    assert [d.id for d in ours.flat] == [d.id for d in theirs.flat]
    # each slice owns whole blocks of the data axis and all of the rest
    per = shape[0] // dcn
    for di in range(shape[0]):
        assert {d.slice_index for d in ours[di].flat} == {
            ours[di - di % per].flat[0].slice_index}


@pytest.mark.parametrize("sizes", [
    dict(data=4, fsdp=2, dcn_data=2), dict(data=4, tensor=2, dcn_data=4),
    dict(data=2, sp=2, tensor=2, dcn_data=2)])
@pytest.mark.parametrize("nodes", [None, "by_node"])
def test_rank_coordinates_match_jax_hybrid_mesh(sizes, nodes, monkeypatch):
    """Rank r of a world of 8 takes device r's coordinates in JAX's hybrid
    mesh, on one host and over ``dcn_data`` nodes of torchrun."""
    if nodes:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(8 // sizes["dcn_data"]))
    else:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    ref = jax_make_mesh(**{"tensor": 1, **sizes},
                        devices=jax.devices()[:8])
    for rank in range(8):
        m = make_mesh(**sizes, world=8, rank=rank)
        where = np.argwhere(ref.devices == jax.devices()[rank])[0]
        assert m.coords == dict(zip(MESH_AXES, (int(i) for i in where)))
        assert m.layout.shape == ref.devices.shape
        assert [int(r) for r in m.layout.flat] == [
            d.id for d in ref.devices.flat]


def test_rank_devices_follow_torchrun_nodes(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert [d.slice_index for d in rank_devices(8)] == [0] * 4 + [1] * 4
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert {d.slice_index for d in rank_devices(8)} == {None}


def test_errors():
    """JAX's: data must be a multiple of dcn_data, the world must split
    into dcn_data equal groups; and across nodes, one node a slice."""
    devs = [FakeDev(i, slice_index=i // 4) for i in range(8)]
    with pytest.raises(ValueError, match="must be a multiple of dcn_data"):
        hybrid_device_array(devs, 1, 8, 1, 1, 1, 1, dcn_data=2)
    with pytest.raises(AssertionError):
        jax_hybrid(devs, 1, 8, 1, 1, 1, 1, dcn_data=2)
    with pytest.raises(ValueError, match="equal groups"):
        group_devices_by_slice(devs[:6], 4)
    with pytest.raises(ValueError, match="multiple of dcn_data"):
        make_mesh(data=2, fsdp=4, dcn_data=4, world=8, rank=0)


def test_node_count_must_equal_dcn_data(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")  # 4 nodes of 2 ranks
    with pytest.raises(ValueError, match="over 4 nodes"):
        make_mesh(data=8, dcn_data=2, world=8, rank=0)
    assert make_mesh(data=8, dcn_data=4, world=8, rank=5).coords["data"] == 5


def test_mesh_config_dcn_roundtrip(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    cfg = MeshConfig(data=4, fsdp=2, dcn_data=2)
    ref = jax_make_mesh(4, 2, 1, jax.devices()[:8], dcn_data=2)
    for rank in range(8):
        m = mesh_from_config(cfg, world=8, rank=rank)
        assert m.shape["data"] == 4 and m.shape["fsdp"] == 2
        # slice 0 is the first contiguous block, as in JAX
        assert [int(r) for r in m.layout[:2].flat] == [
            d.id for d in ref.devices[:2].flat] == [0, 1, 2, 3]
    assert MeshConfig(**{**vars(cfg)}).dcn_data == 2
