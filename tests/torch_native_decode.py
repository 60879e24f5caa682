"""The native decoder for the port's decode parity tests, built once per
test session from ``native/decode/avion_decode.cc`` (the flags of
``native/decode/Makefile``) into the session's temporary directory, which
the xdist workers share: the build takes a file lock, compiles to a name of
its own and moves the library into place, so that no worker loads it
half-written.  The tests then point both packages' readers at it, whether
or not a library happens to exist in ``native/decode``.  Every test that
decodes one file through both packages takes the ``backend`` fixture, so
that which decoder each side uses is never left to whichever process
happened to build ``native/decode`` first.

It skips only where ``g++``, ``pkg-config`` or FFmpeg's development files
are missing; any other build failure fails the test."""

import fcntl
import os
import shutil
import subprocess

import pytest

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "decode", "avion_decode.cc")
PACKAGES = ("libavformat", "libavcodec", "libavutil", "libswscale")


def _flags(kind: str) -> list:
    res = subprocess.run(["pkg-config", kind, *PACKAGES],
                         capture_output=True, text=True)
    if res.returncode != 0:
        pytest.skip(f"FFmpeg's development files are missing: pkg-config "
                    f"{kind} {' '.join(PACKAGES)} says "
                    f"{res.stderr.strip()!r}")
    return res.stdout.split()


@pytest.fixture(scope="session")
def native_decode_lib(tmp_path_factory) -> str:
    """The path of the session's ``libavion_decode.so``."""
    missing = [tool for tool in ("g++", "pkg-config")
               if shutil.which(tool) is None]
    if missing:
        pytest.skip(f"the native decoder cannot be built here: "
                    f"{' and '.join(missing)} not found")
    cflags, libs = _flags("--cflags"), _flags("--libs")
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the session's, shared by the workers
    build = base / "avion_decode"
    build.mkdir(exist_ok=True)
    lib = build / "libavion_decode.so"
    with open(build / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            part = build / f"libavion_decode.{os.getpid()}.so"
            res = subprocess.run(
                ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", *cflags,
                 "-shared", "-o", str(part), SOURCE, *libs],
                capture_output=True, text=True)
            if res.returncode != 0:
                if "fatal error: libav" in res.stderr:
                    pytest.skip(f"FFmpeg's headers are missing: "
                                f"{res.stderr.strip()[:300]}")
                raise RuntimeError(f"building the native decoder failed:\n"
                                   f"{res.stderr}")
            os.replace(part, lib)
    return str(lib)


def use_native(monkeypatch, request, jvr, pvr) -> None:
    """Point the JAX reader (``jvr``) and the port's (``pvr``) at the
    session's library, reload both, and check that both load it; the
    readers' state is put back after the test."""
    lib = request.getfixturevalue("native_decode_lib")
    monkeypatch.setattr(pvr, "LIB_PATH", lib)
    monkeypatch.setattr(jvr, "_LIB_PATHS", [lib])
    monkeypatch.setattr(jvr, "_lib", None)
    monkeypatch.setattr(jvr, "_lib_tried", False)
    pvr._native_lib.cache_clear()
    # runs before monkeypatch puts LIB_PATH back: the next load reads it
    request.addfinalizer(pvr._native_lib.cache_clear)
    assert jvr.native_available(), "the JAX reader did not load " + lib
    assert pvr.native_available(), "the port's reader did not load " + lib


def force_cv2(monkeypatch, jvr, pvr) -> None:
    """Both packages' readers decode with cv2 (native disabled in this
    process)."""
    monkeypatch.setattr(jvr, "_lib", None)
    monkeypatch.setattr(jvr, "_lib_tried", True)
    monkeypatch.setattr(pvr, "_native_lib", lambda: None)


@pytest.fixture(params=["native", "cv2"])
def backend(request, monkeypatch):
    """The same decode backend on both sides: ``native`` loads the
    session's own build of the library in both packages, ``cv2`` disables
    it in both; each reader's state is put back afterwards."""
    from avion_tpu.data import video_reader as jvr
    from avion_tpu_torch.data import video_reader as pvr

    if request.param == "cv2":
        force_cv2(monkeypatch, jvr, pvr)
        return "cv2"
    use_native(monkeypatch, request, jvr, pvr)
    return "native"
