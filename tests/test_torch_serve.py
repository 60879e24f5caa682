"""The port's HTTP server, started through its normal entry point
(``main`` with ``--device cpu``), against the JAX ``ClipService`` on the
same weights: equal answers on every endpoint (2e-3, as
``tests/test_serve.py``), 400 on bad requests, and no silent CPU serving
when CUDA is missing."""

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

from avion_tpu.models.registry import create_model as jax_create_model
from avion_tpu.serve.server import ClipService as JaxClipService
from avion_tpu.serve.server import make_server as jax_make_server
from avion_tpu.serve.server import serve_forever_in_thread
from avion_tpu.tools.convert_checkpoint import export_clip_to_pt
from avion_tpu_torch.serve import server as port_server

FRAMES = 2
ARGV = ["model.name=CLIP_TINY", f"data.clip_length={FRAMES}",
        "model.project_embed_dim=32", "data.val_batch_size=4"]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
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

    jax_service = JaxClipService(model, params, batch=4, max_wait_ms=1.0)
    jax_srv = jax_make_server(jax_service, port=0)
    serve_forever_in_thread(jax_srv)

    ready = queue.Queue()
    argv = ARGV + [f"pretrain_model={ckpt}", "--port", "0",
                   "--device", "cpu"]
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
    _post(servers[0], "/v1/embed/text", {"texts": ["x"]})
    code, m = _get(servers[0], "/metrics")
    assert code == 200 and m["text"]["requests"] >= 1


@pytest.mark.parametrize("path,req,code", [
    ("/v1/embed/video", {"shape": [1, FRAMES, 32, 32, 3]}, 400),
    ("/v1/embed/video", {"frames_b64": "", "shape": [1, 5, 32, 32, 3]}, 400),
    ("/v1/embed/video", {"frames_b64": "", "shape": [1, FRAMES, 16, 16, 3]},
     400),
    ("/v1/embed/video", {"paths": ["clip.mp4"]}, 400),
    ("/v1/similarity", {"paths": ["../outside.mp4"], "texts": ["x"]}, 400),
    ("/v1/classify", dict(_frames(1, 4), labels=[]), 400),
    ("/v1/embed/text", {}, 400),
    ("/v1/nope", {}, 404),
])
def test_bad_requests(servers, path, req, code):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(servers[0], path, req)
    assert e.value.code == code


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_server.main(ARGV + ["pretrain_model=x.pt", "--port", "0"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_server.main(ARGV + ["pretrain_model=x.pt", "--device", "cuda:0"])


@pytest.mark.parametrize("flag", ["--mesh", "--narrator-checkpoint"])
def test_main_refuses_deferred_flags(flag):
    with pytest.raises(SystemExit, match="not in the PyTorch port"):
        port_server.main(ARGV + ["pretrain_model=x.pt", flag, "v",
                                 "--device", "cpu"])
