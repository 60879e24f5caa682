"""The port's HTTP server, started through its normal entry point
(``main`` with ``--device cpu``), against the JAX ``ClipService`` on the
same weights: equal answers on every endpoint (2e-3, as
``tests/test_serve.py``), for ``frames_b64`` and for ``paths`` decoded on
the server under ``--media-root`` (cv2 on both sides), the JAX server's
status code for every bad request, and no silent CPU serving when CUDA is
missing."""

import base64
import json
import queue
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.data import video_reader as jvr
from avion_tpu.models.registry import create_model as jax_create_model
from avion_tpu.serve.server import ClipService as JaxClipService
from avion_tpu.serve.server import make_server as jax_make_server
from avion_tpu.serve.server import serve_forever_in_thread
from avion_tpu.tools.convert_checkpoint import export_clip_to_pt
from avion_tpu_torch.data import video_reader as pvr
from avion_tpu_torch.serve import server as port_server

FRAMES = 2
ARGV = ["model.name=CLIP_TINY", f"data.clip_length={FRAMES}",
        "model.project_embed_dim=32", "data.val_batch_size=4"]
CLIPS = ("clip0.mp4", "sub/clip1.mp4", "clip2.mp4")


def write_clip(path, seed, frames=30, w=64, h=48, fps=10):
    """A seeded mp4v clip (cv2) of a moving gradient with noise."""
    import cv2

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                          (w, h))
    assert out.isOpened()
    for t in range(frames):
        img = np.stack([(xx * 4 + t * 7) % 256, (yy * 5 + seed * 40) % 256,
                        (xx + yy + t * 3) % 256], -1).astype(np.int32)
        img += rs.randint(-20, 20, img.shape)
        out.write(np.clip(img, 0, 255).astype(np.uint8))
    out.release()


@pytest.fixture(scope="module", autouse=True)
def cv2_both():
    """Both packages decode through cv2 (the native reader may load in one
    interpreter and not on the card's machine)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jvr, "_lib", None)
    mp.setattr(jvr, "_lib_tried", True)
    mp.setattr(pvr, "_native_lib", lambda: None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    (root / "sub").mkdir()
    for i, name in enumerate(CLIPS):
        write_clip(root / name, i)
    return root


@pytest.fixture(scope="module")
def servers(tmp_path_factory, media):
    model = jax_create_model("CLIP_TINY", num_frames=FRAMES,
                             project_embed_dim=32)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, FRAMES, 32, 32, 3)),
        jnp.zeros((1, 77), jnp.int32))["params"]
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32), params)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "clip_tiny.pt")
    export_clip_to_pt(params, ckpt)

    jax_service = JaxClipService(model, params, batch=4, max_wait_ms=1.0,
                                 media_root=str(media))
    jax_srv = jax_make_server(jax_service, port=0)
    serve_forever_in_thread(jax_srv)

    ready = queue.Queue()
    argv = ARGV + [f"pretrain_model={ckpt}", "--port", "0",
                   "--device", "cpu", "--media-root", str(media)]
    th = threading.Thread(target=port_server.main, args=(argv,),
                          kwargs={"on_ready": ready.put}, daemon=True)
    th.start()
    port_srv = ready.get(timeout=120)
    urls = tuple(f"http://127.0.0.1:{s.server_address[1]}"
                 for s in (port_srv, jax_srv))
    yield urls
    port_srv.shutdown()
    th.join(timeout=30)
    assert not th.is_alive()
    jax_srv.shutdown()
    jax_service.close()


def _post(url, path, obj):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return r.status, json.loads(r.read())


def _frames(n, seed):
    f = np.random.RandomState(seed).randint(0, 255, (n, FRAMES, 32, 32, 3),
                                             np.uint8)
    return {"frames_b64": base64.b64encode(f.tobytes()).decode(),
            "shape": list(f.shape)}


TEXTS = ["a person cuts an onion", "#C C opens the drawer", "pets the dog"]


@pytest.mark.parametrize("path,req,key", [
    ("/v1/embed/text", {"texts": TEXTS}, "embeddings"),
    ("/v1/embed/video", _frames(5, 1), "embeddings"),
    ("/v1/similarity", dict(_frames(3, 2), texts=TEXTS), "logits"),
    ("/v1/classify", dict(_frames(2, 3), labels=["open door", "cut onion",
                                                 "wash hands"]), "probs"),
    ("/v1/embed/video", {"paths": list(CLIPS)}, "embeddings"),
    ("/v1/embed/video", {"paths": ["/clip0.mp4", "sub/clip1.mp4"],
                         "start": 0.5, "end": 2.2}, "embeddings"),
    ("/v1/similarity", {"paths": list(CLIPS[:2]), "texts": TEXTS,
                        "start": 1.0}, "logits"),
    ("/v1/classify", {"paths": [CLIPS[2]], "end": 1.5,
                      "labels": ["open door", "cut onion"]}, "probs"),
])
def test_endpoint_matches_jax_service(servers, path, req, key):
    port_url, jax_url = servers
    code, got = _post(port_url, path, req)
    assert code == 200
    _, ref = _post(jax_url, path, req)
    got, ref_arr = np.asarray(got[key]), np.asarray(ref[key])
    assert got.shape == ref_arr.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref_arr, atol=2e-3)
    if key == "embeddings":
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-4)


def test_health_and_metrics(servers):
    code, body = _get(servers[0], "/health")
    assert code == 200 and body["platform"] == "cpu"
    assert body["model"] == "CLIP"
    assert [r["device"] for r in body["replicas"]] == ["cpu"]
    _post(servers[0], "/v1/embed/text", {"texts": ["x"]})
    code, m = _get(servers[0], "/metrics")
    assert code == 200 and m["text"]["requests"] >= 1
    enc = m["encoder"]
    assert enc["weight_dtype"] == "bf16" and len(enc["replicas"]) == 1
    assert enc["text_calls"] == enc["replicas"][0]["text_calls"] >= 1
    assert enc["replicas"][0]["weight_bytes"] > 0


@pytest.mark.parametrize("path,req,code", [
    pytest.param("/v1/embed/video", {"shape": [1, FRAMES, 32, 32, 3]}, 400,
                 id="/v1/embed/video-req0-400"),
    pytest.param("/v1/embed/video",
                 {"frames_b64": "", "shape": [1, 5, 32, 32, 3]}, 400,
                 id="/v1/embed/video-req1-400"),
    pytest.param("/v1/embed/video",
                 {"frames_b64": "", "shape": [1, FRAMES, 16, 16, 3]}, 400,
                 id="/v1/embed/video-req2-400"),
    pytest.param("/v1/classify", dict(_frames(1, 4), labels=[]), 400,
                 id="/v1/classify-req5-400"),
    pytest.param("/v1/embed/text", {}, 400, id="/v1/embed/text-req6-400"),
    pytest.param("/v1/nope", {}, 404, id="/v1/nope-req7-404"),
])
def test_bad_requests(servers, path, req, code):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(servers[0], path, req)
    assert e.value.code == code


def _status(url, path, req):
    try:
        return _post(url, path, req)[0]
    except urllib.error.HTTPError as e:
        return e.code


def _wrong_size():
    f = np.zeros((1, FRAMES, 16, 16, 3), np.uint8)
    return {"frames_b64": base64.b64encode(f.tobytes()).decode(),
            "shape": list(f.shape)}


# (servers, route, body, the JAX server's code): ``servers`` serve under
# --media-root, ``narrate_servers`` without one
@pytest.mark.parametrize("fixture,path,req,code", [
    ("servers", "/v1/embed/video", {"paths": ["missing.mp4"]}, 500),
    ("servers", "/v1/embed/video", {"paths": ["../outside.mp4"]}, 400),
    ("servers", "/v1/similarity", {"paths": ["sub/../../x.mp4"],
                                   "texts": ["x"]}, 400),
    ("servers", "/v1/classify", {"paths": ["/../etc/passwd"],
                                 "labels": ["a"]}, 400),
    ("servers", "/v1/embed/video", {"paths": [CLIPS[0]], "start": "x"}, 400),
    ("servers", "/v1/embed/video", _wrong_size(), 400),
    ("narrate_servers", "/v1/narrate", {"paths": ["clip.mp4"]}, 500),
    ("narrate_servers", "/v1/narrate", {"paths": ["../outside.mp4"]}, 500),
    ("narrate_servers", "/v1/narrate", _wrong_size(), 400),
], ids=["missing", "escape", "escape-dotdot", "escape-absolute",
        "bad-start", "wrong-size", "narrate-missing",
        "narrate-outside-no-root", "narrate-wrong-size"])
def test_status_matches_jax_server(request, fixture, path, req, code):
    port_url, jax_url = request.getfixturevalue(fixture)
    assert _status(jax_url, path, req) == code
    assert _status(port_url, path, req) == code


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_server.main(ARGV + ["pretrain_model=x.pt", "--port", "0"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_server.main(ARGV + ["pretrain_model=x.pt", "--device", "cuda:0"])


class FakeTok:
    """An ids-only tokenizer (GPT-2's vocabulary is not in the repo)."""

    eos_token_id = 1

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids)


@pytest.fixture(scope="module")
def narrate_servers(tmp_path_factory):
    """The port's ``main`` with ``--narrator-checkpoint <tiny .pt>
    --narrator-model LAVILA_NARRATOR_TINY`` (the fake tokenizer and
    temperature 1e-6 injected into ``lavila_captioner``), and JAX's
    ``NarrateService`` over the same file's import."""
    import functools

    from avion_tpu.models.lavila_import import import_lavila_narrator_pt
    from avion_tpu.models.pt_import import merge_into_params
    from avion_tpu.serve.server import NarrateService as JaxNarrateService
    from avion_tpu.tools.narrator import lavila_captioner as jax_captioner
    from avion_tpu_torch.models.pt_import import params_from_jax
    from avion_tpu_torch.tools import narrator as narrator_tools

    tmp = tmp_path_factory.mktemp("narrator")
    jm = jax_create_model("LAVILA_NARRATOR_TINY", num_frames=FRAMES)
    video = np.zeros((1, FRAMES, 32, 32, 3), np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), video,
                              jnp.zeros((1, 6), jnp.int32))["params"]
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32), params)
    # the released layout: DDP's prefix, gamma-only pool norms
    sd = params_from_jax(params)
    for base in ("img_attn_pool.norm", "img_attn_pool.context_norm",
                 "img_attn_pool_norm"):
        sd[f"{base}.gamma"] = sd.pop(f"{base}.weight")
        del sd[f"{base}.bias"]
    pt = str(tmp / "narrator.pt")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, pt)
    jparams = merge_into_params(params, import_lavila_narrator_pt(pt),
                                strict=True)
    kw = dict(tokenizer=FakeTok(), temperature=1e-6)
    jax_narrate = JaxNarrateService(
        jax_captioner(model=jm, params=jparams, num_frames=FRAMES, **kw),
        clip_length=FRAMES, image_size=32)
    jax_srv = jax_make_server(None, port=0, narrate=jax_narrate)
    serve_forever_in_thread(jax_srv)

    clip_ckpt = str(tmp / "clip_tiny.pt")
    jclip = jax_create_model("CLIP_TINY", num_frames=FRAMES,
                             project_embed_dim=32)
    export_clip_to_pt(jax.jit(jclip.init)(
        jax.random.PRNGKey(0), video, jnp.zeros((1, 77), jnp.int32))[
            "params"], clip_ckpt)
    mp = pytest.MonkeyPatch()
    mp.setattr(narrator_tools, "lavila_captioner",
               functools.partial(narrator_tools.lavila_captioner, **kw))
    ready = queue.Queue()
    argv = ARGV + [f"pretrain_model={clip_ckpt}", "--port", "0",
                   "--device", "cpu", "--narrator-checkpoint", pt,
                   "--narrator-model", "LAVILA_NARRATOR_TINY"]
    th = threading.Thread(target=port_server.main, args=(argv,),
                          kwargs={"on_ready": ready.put}, daemon=True)
    th.start()
    port_srv = ready.get(timeout=120)
    yield tuple(f"http://127.0.0.1:{s.server_address[1]}"
                for s in (port_srv, jax_srv))
    port_srv.shutdown()
    th.join(timeout=30)
    mp.undo()
    assert not th.is_alive()
    jax_srv.shutdown()
    jax_narrate.close()


def test_main_with_narrator_answers_narrate_as_jax(narrate_servers):
    port_url, jax_url = narrate_servers
    req = _frames(2, 5)
    code, got = _post(port_url, "/v1/narrate", req)
    assert code == 200
    _, ref = _post(jax_url, "/v1/narrate", req)
    assert got == ref
    assert len(got["narrations"]) == 2
    assert all(len(n) == 3 and all(isinstance(c, str) and c for c in n)
               for n in got["narrations"])
    code, m = _get(port_url, "/metrics")
    assert code == 200 and m["narrate"]["requests"] == 2


def test_narrate_paths_as_jax(narrate_servers, media):
    """``paths`` on ``/v1/narrate``, absolute (no media root), with
    ``start`` / ``end``: the JAX server's narrations."""
    port_url, jax_url = narrate_servers
    req = {"paths": [str(media / CLIPS[1]), str(media / CLIPS[0])],
           "start": 0.2, "end": 2.5}
    code, got = _post(port_url, "/v1/narrate", req)
    assert code == 200
    assert got == _post(jax_url, "/v1/narrate", req)[1]
    assert len(got["narrations"]) == 2


@pytest.mark.parametrize("req", [{"frames_b64": "", "shape": [1, 5, 32, 32,
                                                              3]}],
                         ids=["shape"])
def test_narrate_bad_requests(narrate_servers, req):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(narrate_servers[0], "/v1/narrate", req)
    assert e.value.code == 400
