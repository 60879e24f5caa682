"""The kernel libraries' cache key (``ops/_build._lib_path``): an edit to a
source, to any shared header or to the compiler flags names a new library,
so a stale build is never loaded; and how ``chip_smoke.py``'s build check
reads ptxas.  CPU only; nothing is compiled."""

import os
import shutil

import pytest

import chip_smoke
from avion_tpu_torch.ops import _build

SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "quick_gelu.cu")
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


_ANON = "_ZN45_GLOBAL__N__c19d5e6a_12_flash_fwd_cu_617625e7"


@pytest.mark.parametrize("mangled,label", [
    (_ANON + "16flash_fwd_kernelILi64ELb0ELb1EEEv14CUtensorMap_stP13"
     "__nv_bfloat16Pfiixxf", "flash_fwd_kernel<64, causal=0, lse=1>"),
    (_ANON + "13bwd_kv_kernelILi128ELb1ELb1EEEv14CUtensorMap_stS1_PKfS3_",
     "bwd_kv_kernel<128, causal=1, dq=1>"),
    (_ANON + "13bwd_dq_kernelILi64ELb0EEEv14CUtensorMap_stS1_",
     "bwd_dq_kernel<64, causal=0>"),
])
def test_chip_smoke_names_each_instance(mangled, label):
    assert chip_smoke._instance(mangled)[0] == label
    note = ("ptxas info    : (C7520) Potential Performance Loss: "
            "wgmma.mma_async instructions are serialized due to program "
            "dependence on compiler-inserted WG.AR in divergent path in the "
            f"function '{mangled}'\nptxas info    : Used 128 registers")
    assert chip_smoke.serialized_instances(note) == {label}
    assert chip_smoke.serialized_instances(note.replace("serialized", "")) \
        == set()
