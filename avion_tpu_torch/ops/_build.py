"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds); device
code they share lives in ``csrc/*.cuh`` headers.  The library lands in
``ops/.build/`` under a name that carries the hash of its source, the
headers and the flags: an edited source rebuilds, an unchanged one loads the
library already there.  Nothing is compiled when a module is imported;
:func:`library` builds at first use, and :func:`call` calls one of a
library's launchers on the current CUDA stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas resource report (registers, shared memory, spills) per library
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _lib_path(source: str) -> str:
    # the hash covers the source and every shared header it may include
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def _compile(source: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a temporary name, then rename: a concurrent builder
    # never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
        build_logs[source] = res.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def call(source: str, name: str, argtypes: list, *args) -> None:
    """Call the C function ``name`` of ``csrc/<source>``'s library with
    ``args`` and the current CUDA stream; raise on the cudaError_t it
    returns."""
    lib = library(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.avion_cuda_error_string.argtypes = [ctypes.c_int]
        lib.avion_cuda_error_string.restype = ctypes.c_char_p
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} failed: "
                           + lib.avion_cuda_error_string(err).decode())


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, compiled first if needed."""
    with _lock:
        lib = _libs.get(source)
    if lib is not None:
        return lib
    out = _lib_path(source)
    if not os.path.exists(out):
        _compile(source, out)
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(out)
            _libs[source] = lib
    return lib
