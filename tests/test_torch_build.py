"""The kernel libraries' cache key (``ops/_build._lib_path``): an edit to a
source, to any shared header or to the compiler flags names a new library,
so a stale build is never loaded.  CPU only; nothing is compiled."""

import os
import shutil

import pytest

from avion_tpu_torch.ops import _build

SOURCES = ("flash_fwd.cu", "flash_bwd.cu")
HEADERS = ("flash_common.cuh", "flash_sm90.cuh")


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", str(copy))
    return copy


def test_the_lists_name_every_kernel_file():
    files = set(os.listdir(_build.CSRC))
    assert {f for f in files if f.endswith(".cu")} == set(SOURCES)
    assert {f for f in files if f.endswith(".cuh")} == set(HEADERS)


@pytest.mark.parametrize("edited", SOURCES + HEADERS)
def test_lib_path_follows_each_file(csrc, edited):
    before = {s: _build._lib_path(s) for s in SOURCES}
    path = csrc / edited
    path.write_text(path.read_text() + "\n// edited\n")
    for source in SOURCES:
        changed = edited in HEADERS or edited == source
        assert (_build._lib_path(source) != before[source]) == changed


def test_lib_path_follows_nvcc_flags(monkeypatch):
    before = {s: _build._lib_path(s) for s in SOURCES}
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    for source in SOURCES:
        assert _build._lib_path(source) != before[source]
