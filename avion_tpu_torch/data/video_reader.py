"""Video reading (``avion_tpu.data.video_reader``): a ctypes binding to
the native fused decoder, with a pure-Python (OpenCV) fallback.

The native library (``native/decode/avion_decode.cc``, built with
``make -C native/decode`` on a host with FFmpeg's libraries) does crop +
resize + flip inside the decode loop, so only crop-sized uint8 RGB frames
reach Python.  Crop *parameters* are sampled on the host per clip by the
samplers in ``avion_tpu_torch/data/transforms.py`` and passed in.

Where no library exists, the first use builds it from ``SRC_DIR`` with
its Makefile, as the JAX package's reader does: under a lock beside the
library, to a private directory, then moved into place, so that readers
that start together (``DataLoader`` workers) build it once and none loads
it half-written.  Where the build fails (no compiler, no ``make``, no
FFmpeg headers) the reader decodes with OpenCV, as JAX's does; the decoder
is host code, not a ported kernel.  The failure is recorded in a marker
beside the library, keyed by the hash of the Makefile and the source, and
no process tries again while that marker stands: each worker process
would otherwise pay a failed compile at every loader start.  A library
that exists but cannot load (copied from a host that has FFmpeg to one
that has not) counts as unavailable and is not rebuilt.
``VideoReader.backend`` says which backend a reader took.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

SRC_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "native",
    "decode"))
LIB_PATH = os.path.join(SRC_DIR, "libavion_decode.so")


class DecodeError(RuntimeError):
    pass


@dataclass
class CropSpec:
    """Normalized crop region + flips, constant across a clip."""

    x: float = 0.0
    y: float = 0.0
    w: float = 1.0
    h: float = 1.0
    hflip: bool = False
    vflip: bool = False


def _bind(lib) -> None:
    """argtypes / restype of every entry point; the optional ones of newer
    builds only where the library has them."""
    lib.avd_open.restype = ctypes.c_void_p
    lib.avd_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    if hasattr(lib, "avd_open_fast"):
        lib.avd_open_fast.restype = ctypes.c_void_p
        lib.avd_open_fast.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.avd_frame_count.restype = ctypes.c_int
    lib.avd_frame_count.argtypes = [ctypes.c_void_p]
    lib.avd_fps.restype = ctypes.c_double
    lib.avd_fps.argtypes = [ctypes.c_void_p]
    lib.avd_width.restype = ctypes.c_int
    lib.avd_width.argtypes = [ctypes.c_void_p]
    lib.avd_height.restype = ctypes.c_int
    lib.avd_height.argtypes = [ctypes.c_void_p]
    lib.avd_last_error.restype = ctypes.c_char_p
    lib.avd_last_error.argtypes = [ctypes.c_void_p]
    lib.avd_get_batch.restype = ctypes.c_int
    lib.avd_get_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.avd_close.argtypes = [ctypes.c_void_p]
    lib.avd_write_test_video.restype = ctypes.c_int
    lib.avd_write_test_video.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 6
    if hasattr(lib, "avd_write_test_video_codec"):
        lib.avd_write_test_video_codec.restype = ctypes.c_int
        lib.avd_write_test_video_codec.argtypes = \
            [ctypes.c_char_p] + [ctypes.c_int] * 6 + [ctypes.c_char_p] \
            + [ctypes.c_int]
    if hasattr(lib, "avd_write_test_video_seeded"):
        lib.avd_write_test_video_seeded.restype = ctypes.c_int
        lib.avd_write_test_video_seeded.argtypes = \
            [ctypes.c_char_p] + [ctypes.c_int] * 6 + [ctypes.c_char_p] \
            + [ctypes.c_int, ctypes.c_uint32]


def _sources_key() -> str:
    """The hash of ``SRC_DIR``'s Makefile and source (empty where one is
    missing), which keys the failure marker."""
    digest = hashlib.sha256()
    for name in ("Makefile", "avion_decode.cc"):
        try:
            with open(os.path.join(SRC_DIR, name), "rb") as f:
                digest.update(f.read())
        except OSError:
            pass
        digest.update(b"\0")
    return digest.hexdigest()


def _build() -> None:
    """Build ``LIB_PATH`` with ``SRC_DIR``'s Makefile unless it exists or a
    failure marker for these sources stands; a failure writes the marker
    (``LIB_PATH + ".failed"``: the key, then make's output) and raises
    nothing."""
    key = _sources_key()
    marker = LIB_PATH + ".failed"
    try:
        lock = open(LIB_PATH + ".lock", "a")
    except OSError:  # a read-only tree: nothing can be built or marked
        return
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(LIB_PATH):  # another process built it meanwhile
            return
        try:
            with open(marker) as f:
                if f.readline().strip() == key:
                    return
        except OSError:
            pass
        work = os.path.join(os.path.dirname(LIB_PATH),
                            f".build.{os.getpid()}")
        os.makedirs(work, exist_ok=True)
        try:
            # the Makefile's own rule, run in the private directory with
            # the sources found through VPATH; -B: a library elsewhere on
            # VPATH is no reason to skip
            res = subprocess.run(
                ["make", "-B", "-f", os.path.join(SRC_DIR, "Makefile"),
                 f"VPATH={SRC_DIR}", os.path.basename(LIB_PATH)],
                cwd=work, capture_output=True, text=True)
            built = os.path.join(work, os.path.basename(LIB_PATH))
            if res.returncode == 0 and os.path.exists(built):
                os.replace(built, LIB_PATH)
                return
            why = f"make exited {res.returncode}\n{res.stdout}{res.stderr}"
        except OSError as e:  # no make
            why = f"{type(e).__name__}: {e}"
        finally:
            shutil.rmtree(work, ignore_errors=True)
        try:
            with open(marker, "w") as f:
                f.write(f"{key}\n{why}")
        except OSError:
            pass


@functools.cache
def _native_lib():
    """The loaded library, or None when it is not built and cannot be
    (``_build``), cannot load (missing FFmpeg libraries) or lacks an entry
    point."""
    if not os.path.exists(LIB_PATH) and \
            os.path.exists(os.path.join(SRC_DIR, "Makefile")):
        _build()
    if not os.path.exists(LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(os.path.abspath(LIB_PATH))
        _bind(lib)
    except (OSError, AttributeError):
        return None
    return lib


def native_available() -> bool:
    return _native_lib() is not None


def default_backend() -> str:
    """The backend a ``VideoReader`` opened without ``backend`` takes."""
    return "native" if native_available() else "cv2"


def write_test_video(path: str, n_frames: int, w: int = 64, h: int = 64,
                     fps: int = 30, gop: int = 30, bframes: int = 2,
                     codec: str = "", noise: bool = False,
                     seed: int = 0) -> None:
    """Encode a deterministic mpeg4 test clip (B-frames + sparse
    keyframes) with the native library: fixture generator for the
    decoder's fast-forward and keyframe walk-back paths.  ``seed`` varies
    the texture/chroma/bar phase so seeded videos form distinct classes."""
    lib = _native_lib()
    if lib is None:
        raise DecodeError("native decode library unavailable")
    if seed:
        if not hasattr(lib, "avd_write_test_video_seeded"):
            raise DecodeError(
                "libavion_decode.so predates avd_write_test_video_seeded; "
                "rebuild it (make -C native/decode)")
        rc = lib.avd_write_test_video_seeded(
            path.encode(), n_frames, w, h, fps, gop, bframes,
            codec.encode(), int(noise), seed & 0xFFFFFFFF)
    elif (codec or noise) and hasattr(lib, "avd_write_test_video_codec"):
        rc = lib.avd_write_test_video_codec(path.encode(), n_frames, w, h,
                                            fps, gop, bframes,
                                            codec.encode(), int(noise))
    else:
        rc = lib.avd_write_test_video(path.encode(), n_frames, w, h, fps,
                                      gop, bframes)
    if rc != 0:
        raise DecodeError(lib.avd_last_error(None).decode("utf-8", "replace"))


class VideoReader:
    """Fused crop+scale batches of frames as uint8 HWC RGB.

    ``get_batch(frame_ids, crop, out_size)`` mirrors
    ``decord.VideoReader(...).get_batch(ids)`` with the augmentation fused
    in.  ``backend``: ``None`` (native when available, else cv2),
    ``"native"`` (raises when the native library opens the file and
    fails; cv2 when there is no library) or ``"cv2"``.
    """

    def __init__(self, path: str, num_threads: int = 1,
                 backend: Optional[str] = None, fast: bool = False):
        """``fast=True`` selects the native training-decode profile (H.264
        loop filter skipped + fast bilinear scaling)."""
        self.path = path
        if not os.path.exists(path):
            raise DecodeError(f"no such file: {path}")
        lib = _native_lib() if backend in (None, "native") else None
        if lib is not None:
            opener = (lib.avd_open_fast
                      if fast and hasattr(lib, "avd_open_fast")
                      else lib.avd_open)
            h = opener(path.encode(), num_threads)
            if h:
                self._lib, self._h = lib, h
                self._backend = "native"
                self._n = lib.avd_frame_count(h)
                self._fps = lib.avd_fps(h)
                self._wh = (lib.avd_width(h), lib.avd_height(h))
                return
            if backend == "native":
                raise DecodeError(
                    f"native open failed: {lib.avd_last_error(None)!r}")
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise DecodeError(f"cannot open {path}")
        self._backend = "cv2"
        self._cap = cap
        self._n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        self._wh = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                    int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        self._pos = 0

    @property
    def backend(self) -> str:
        return self._backend

    def __len__(self):
        return self._n

    def get_avg_fps(self) -> float:
        return self._fps

    @property
    def width(self):
        return self._wh[0]

    @property
    def height(self):
        return self._wh[1]

    def get_batch(
        self,
        frame_ids: Sequence[int],
        crop: Optional[CropSpec] = None,
        out_size: Optional[tuple] = None,
    ) -> np.ndarray:
        """Returns [n, out_h, out_w, 3] uint8 RGB."""
        crop = crop or CropSpec()
        if out_size is None:
            out_w = int(self.width * crop.w) & ~1
            out_h = int(self.height * crop.h) & ~1
        else:
            out_w, out_h = out_size
        n = len(frame_ids)
        if self._backend == "native":
            out = np.empty((n, out_h, out_w, 3), np.uint8)
            idx = (ctypes.c_int64 * n)(*[int(i) for i in frame_ids])
            rc = self._lib.avd_get_batch(
                self._h, idx, n, crop.x, crop.y, crop.w, crop.h,
                int(crop.hflip), int(crop.vflip), out_w, out_h,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            if rc != 0:
                raise DecodeError(
                    self._lib.avd_last_error(self._h).decode("utf-8", "replace")
                )
            return out
        return self._cv2_batch(frame_ids, crop, out_w, out_h)

    def _cv2_batch(self, frame_ids, crop, out_w, out_h):
        import cv2

        n = len(frame_ids)
        out = np.empty((n, out_h, out_w, 3), np.uint8)
        sx = int(crop.x * self.width)
        sy = int(crop.y * self.height)
        sw = max(1, int(crop.w * self.width))
        sh = max(1, int(crop.h * self.height))
        order = np.argsort(np.asarray(frame_ids))
        cache = {}
        for oi in order:
            fid = int(np.clip(frame_ids[oi], 0, self._n - 1))
            if fid not in cache:
                if fid != self._pos:
                    self._cap.set(cv2.CAP_PROP_POS_FRAMES, fid)
                    self._pos = fid
                ok, frame = self._cap.read()
                self._pos = fid + 1
                if not ok:
                    raise DecodeError(f"cv2 read failed at frame {fid}")
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                patch = frame[sy : sy + sh, sx : sx + sw]
                patch = cv2.resize(patch, (out_w, out_h),
                                   interpolation=cv2.INTER_LINEAR)
                if crop.hflip:
                    patch = patch[:, ::-1]
                if crop.vflip:
                    patch = patch[::-1]
                cache = {fid: patch}  # keep only the latest (ids are sorted)
            out[oi] = cache[fid]
        return out

    def seek(self, pos: int = 0):
        if self._backend == "cv2":
            import cv2

            self._cap.set(cv2.CAP_PROP_POS_FRAMES, pos)
            self._pos = pos

    def close(self):
        if self._backend == "native" and self._h:
            self._lib.avd_close(self._h)
            self._h = None
        elif self._backend == "cv2":
            self._cap.release()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
