"""The port's video reader builds the native decoder at first use, as the
JAX package's does: on a copy of ``native/decode`` in a temporary
directory (``SRC_DIR`` and ``LIB_PATH`` pointed at it), a clean build
loads and leaves one library and no private file; a build that fails
means cv2, raises nothing and leaves a marker that keeps later processes
from trying again, unless the sources changed; two processes that start
together build once; and a reader opened without ``backend`` on a fresh
copy decodes the same pixels as JAX's reader on the library it built."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from avion_tpu.data import video_reader as jvr
from avion_tpu_torch.data import video_reader as pvr
from torch_native_decode import native_decode_lib  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = os.path.join(ROOT, "native", "decode")
LIB = "libavion_decode.so"
# the rule of a Makefile whose build fails: it counts its runs in COUNT
FAILING_MAKEFILE = f"{LIB}:\n\techo run >> {{count}}\n\texit 1\n"


def _needs_toolchain(request):
    """Skip where the decoder cannot be built here (no make, g++,
    pkg-config or FFmpeg headers: the session's own build says which)."""
    if shutil.which("make") is None:
        pytest.skip("make not found")
    request.getfixturevalue("native_decode_lib")


@pytest.fixture
def copy(tmp_path, monkeypatch):
    """An empty copy of ``native/decode`` (Makefile and source, no
    library) that the port's reader builds from and loads, with its
    per-process cache cleared before and after."""
    src = tmp_path / "decode"
    src.mkdir()
    for name in ("Makefile", "avion_decode.cc"):
        shutil.copy(os.path.join(SOURCES, name), src / name)
    monkeypatch.setattr(pvr, "SRC_DIR", str(src))
    monkeypatch.setattr(pvr, "LIB_PATH", str(src / LIB))
    pvr._native_lib.cache_clear()
    yield src
    pvr._native_lib.cache_clear()  # before monkeypatch puts the names back


def _write_video(path, n_frames, seed, w=64, h=48, fps=10):
    """Seeded noise frames, so that every crop and frame id shows."""
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    rs = np.random.RandomState(seed)
    for _ in range(n_frames):
        vw.write(rs.randint(0, 256, (h, w, 3), np.uint8))
    vw.release()


def _failing(src, tmp_path) -> str:
    """Make ``src``'s build fail; returns the file that counts its runs."""
    count = tmp_path / "runs"
    (src / "Makefile").write_text(FAILING_MAKEFILE.format(count=count))
    return str(count)


def _runs(count: str) -> int:
    return len(open(count).read().split()) if os.path.exists(count) else 0


def _backend_in_new_process(src, env=None) -> subprocess.Popen:
    """A fresh interpreter that points the port's reader at ``src`` and
    prints ``default_backend()``."""
    code = ("from avion_tpu_torch.data import video_reader as v\n"
            f"v.SRC_DIR = {str(src)!r}\n"
            f"v.LIB_PATH = {str(src / LIB)!r}\n"
            "print(v.default_backend())\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _output(proc) -> str:
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    return out.strip()


def test_clean_build_loads_one_library(copy, request):
    _needs_toolchain(request)
    assert pvr.native_available()
    assert pvr.default_backend() == "native"
    # the library and its lock; no private build directory, no marker
    assert sorted(os.listdir(copy)) == sorted(
        ["Makefile", "avion_decode.cc", LIB, LIB + ".lock"])


def test_failed_build_means_cv2_and_is_not_retried(copy, tmp_path):
    if shutil.which("make") is None:
        pytest.skip("make not found")
    count = _failing(copy, tmp_path)
    assert pvr.default_backend() == "cv2"
    assert not pvr.native_available()
    assert _runs(count) == 1
    marker = copy / (LIB + ".failed")
    assert open(marker).readline().strip() == pvr._sources_key()
    assert sorted(os.listdir(copy)) == sorted(
        ["Makefile", "avion_decode.cc", LIB + ".lock", LIB + ".failed"])
    path = str(tmp_path / "v.mp4")
    _write_video(path, 5, seed=0)
    assert pvr.VideoReader(path).backend == "cv2"
    # a second process (its own cache) finds the marker and builds nothing
    assert _output(_backend_in_new_process(copy)) == "cv2"
    pvr._native_lib.cache_clear()
    assert pvr.default_backend() == "cv2"
    assert _runs(count) == 1


def test_stale_marker_is_ignored(copy, tmp_path):
    """A marker keyed by other sources (the Makefile or the source was
    edited since) does not stop the build."""
    if shutil.which("make") is None:
        pytest.skip("make not found")
    count = _failing(copy, tmp_path)
    marker = copy / (LIB + ".failed")
    marker.write_text("0" * 64 + "\nmake exited 2\n")
    assert pvr.default_backend() == "cv2"
    assert _runs(count) == 1
    assert open(marker).readline().strip() == pvr._sources_key()


def test_two_processes_build_once(copy, tmp_path, request):
    """Both processes load the library; ``make`` (counted by a wrapper
    first on ``PATH``) ran once: the second waited on the lock and found
    the first's library."""
    _needs_toolchain(request)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    count = tmp_path / "makes"
    wrapper = bin_dir / "make"
    wrapper.write_text(f"#!/bin/sh\necho run >> {count}\n"
                       f"exec {shutil.which('make')} \"$@\"\n")
    wrapper.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    procs = [_backend_in_new_process(copy, env) for _ in range(2)]
    assert [_output(p) for p in procs] == ["native", "native"]
    assert _runs(str(count)) == 1
    assert sorted(os.listdir(copy)) == sorted(
        ["Makefile", "avion_decode.cc", LIB, LIB + ".lock"])


def test_fresh_reader_matches_jax(copy, tmp_path, monkeypatch, request):
    """A reader opened without ``backend`` on a fresh tree builds the
    library and takes the native decoder, as JAX's reader does there: the
    same pixels as JAX's reader on the library it built."""
    _needs_toolchain(request)
    path = str(tmp_path / "clip.mp4")
    _write_video(path, 20, seed=3)
    ours = pvr.VideoReader(path)
    assert ours.backend == "native"
    monkeypatch.setattr(jvr, "_LIB_PATHS", [pvr.LIB_PATH])
    monkeypatch.setattr(jvr, "_lib", None)
    monkeypatch.setattr(jvr, "_lib_tried", False)
    ref = jvr.VideoReader(path)
    assert ref._backend == "native"  # JAX's reader names it privately
    ids = [7, 3, 3, 15, 0, 19]
    # every side a multiple of 8 (the native decoder's heap fault)
    for crop, out_size in ((None, None), ((0.25, 0.0, 0.5, 1.0, True, False),
                                          (32, 24))):
        got = ours.get_batch(ids, pvr.CropSpec(*crop) if crop else None,
                             out_size)
        want = ref.get_batch(ids, jvr.CropSpec(*crop) if crop else None,
                             out_size)
        w, h = out_size or (64, 48)
        assert got.shape == (len(ids), h, w, 3)
        np.testing.assert_array_equal(got, want)
    ours.close()
    ref.close()
