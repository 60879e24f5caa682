"""Server-side decode of the port's server against the JAX server's
functions: ``decode_clip`` bit for bit on cv2-written mp4v clips under the
same (cv2) backend, with and without ``start`` / ``end``, and
``resolve_media_path`` on the cases of ``tests/test_serve.py``."""

import numpy as np
import pytest

from avion_tpu.data import video_reader as jvr
from avion_tpu.serve import server as jax_server
from avion_tpu_torch.data import video_reader as pvr
from avion_tpu_torch.serve import server as port_server
from test_torch_serve import write_clip


@pytest.fixture(autouse=True)
def cv2_both(monkeypatch):
    monkeypatch.setattr(jvr, "_lib", None)
    monkeypatch.setattr(jvr, "_lib_tried", True)
    monkeypatch.setattr(pvr, "_native_lib", lambda: None)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    out = {}
    for name, (w, h, frames, fps) in {"wide": (64, 48, 30, 10),
                                      "tall": (40, 72, 25, 30),
                                      "odd": (50, 50, 7, 5)}.items():
        out[name] = str(root / f"{name}.mp4")
        write_clip(out[name], len(out), frames=frames, w=w, h=h, fps=fps)
    return out


@pytest.mark.parametrize("name", ["wide", "tall", "odd"])
@pytest.mark.parametrize("clip_length,size,start,end", [
    (4, 32, None, None), (2, 24, 0.5, 2.0), (8, 32, 1.0, None),
    (3, 16, None, 0.4), (4, 32, 5.0, 9.0),  # a window past the end
])
def test_decode_clip_bit_equal(clips, name, clip_length, size, start, end):
    got = port_server.decode_clip(clips[name], clip_length, size, start, end)
    ref = jax_server.decode_clip(clips[name], clip_length, size, start, end)
    assert got.dtype == np.uint8 and got.shape == (clip_length, size, size, 3)
    np.testing.assert_array_equal(got, ref)


def test_decode_clip_missing_file_raises_as_jax(tmp_path):
    path = str(tmp_path / "none.mp4")
    with pytest.raises(RuntimeError) as ref:
        jax_server.decode_clip(path, 2, 32)
    with pytest.raises(RuntimeError) as got:
        port_server.decode_clip(path, 2, 32)
    assert not isinstance(got.value, (KeyError, ValueError, TypeError))
    assert not isinstance(ref.value, (KeyError, ValueError, TypeError))


@pytest.fixture
def root(tmp_path):
    root = tmp_path / "media"
    (root / "sub").mkdir(parents=True)
    (root / "sub" / "a.mp4").write_bytes(b"x")
    (tmp_path / "secret").mkdir()
    (root / "link").symlink_to(tmp_path / "secret")
    return str(root)


@pytest.mark.parametrize("path,with_root", [
    ("/etc/hostname", False), ("sub/a.mp4", True), ("/sub/a.mp4", True),
    ("", True), ("sub/../sub/a.mp4", True),
])
def test_resolve_media_path_as_jax(root, path, with_root):
    media_root = root if with_root else None
    got = port_server.resolve_media_path(path, media_root)
    assert got == jax_server.resolve_media_path(path, media_root)


@pytest.mark.parametrize("path", ["../outside", "sub/../../x",
                                  "/../etc/passwd", "link/x.mp4"])
def test_resolve_media_path_rejects_escapes_as_jax(root, path):
    with pytest.raises(ValueError):
        jax_server.resolve_media_path(path, root)
    with pytest.raises(ValueError, match="escapes media root"):
        port_server.resolve_media_path(path, root)
