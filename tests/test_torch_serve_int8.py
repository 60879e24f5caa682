"""``--weights int8`` and ``--mesh`` of the port's server against the JAX
package: every quantized parameter's int8 values and scales equal to
``quantize_inference_params``' (through ``params_from_jax``'s key mapping)
and the same parameters left unquantized; int8 embeddings against the JAX
int8 service in f32 (2e-3, the endpoint tolerance of
``tests/test_torch_serve.py``) and against the exact service (cosine >
0.98, ``tests/test_serve.py``'s bound); the replicated service against the
unreplicated one and its batch rounded as the JAX runner rounds it over a
mesh; the replicas' devices with the card count monkeypatched."""

import queue
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avion_tpu.eval.runners import CLIPEncoders as JaxCLIPEncoders
from avion_tpu.eval.runners import quantize_inference_params as jax_quantize
from avion_tpu.models.registry import create_model as jax_create_model
from avion_tpu.serve.server import ClipService as JaxClipService
from avion_tpu.tools.convert_checkpoint import export_clip_to_pt
from avion_tpu_torch.core.config import MeshConfig
from avion_tpu_torch.eval import runners
from avion_tpu_torch.models.pt_import import params_from_jax
from avion_tpu_torch.models.registry import create_model
from avion_tpu_torch.serve import server as port_server

FRAMES = 2
TEXTS = ["a person chops vegetables", "#C C opens the drawer",
         "pets the dog", "washes a cup", "closes the fridge"]


def _jax_weights(**kw):
    jm = jax_create_model("CLIP_TINY", num_frames=FRAMES,
                          project_embed_dim=32, **kw)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, FRAMES, 32, 32, 3)),
        jnp.zeros((1, 77), jnp.int32))["params"]
    rs = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rs.standard_normal(np.shape(x)).astype(np.float32), params)
    return jm, params, params_from_jax(params)


@pytest.fixture(scope="module")
def weights():
    return _jax_weights()


def _port_model(sd, **kw):
    pm = create_model("CLIP_TINY", num_frames=FRAMES, project_embed_dim=32,
                      **kw)
    pm.load_state_dict(sd, strict=True)
    return pm


def _videos(n, seed):
    return np.random.RandomState(seed).randint(
        0, 255, (n, FRAMES, 32, 32, 3), np.uint8)


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def test_int8_values_and_scales_equal_jax(weights):
    """The JAX tree with each quantized leaf replaced by its int8 values
    (and every other leaf by NaN) goes through ``params_from_jax``: the
    port must quantize exactly the finite names, to the same values, with
    the same scales channel for channel."""
    _check_int8_equal_jax(*weights)


def test_int8_moe_leaves_equal_jax():
    """The same with MoE blocks: the stacked ``[E, ...]`` expert leaves
    (and their ``[E, H]`` biases) quantize per last-axis channel over the
    experts, as JAX's; the router stays f32."""
    jm, params, sd = _jax_weights(moe_experts=4)
    got = _check_int8_equal_jax(jm, params, sd, moe_experts=4)
    assert "visual.transformer.resblocks.0.moe_mlp.expert_fc1" in got
    assert "visual.transformer.resblocks.0.moe_mlp.expert_fc2_bias" in got
    assert not any("router" in k for k in got)


def _check_int8_equal_jax(jm, params, sd, **model_kw):
    leaves, scales, treedef = jax_quantize(params, jm)
    paths = [tuple(str(getattr(k, "key", k)) for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    q_tree, s_by_path = {}, {}
    for path, leaf, s in zip(paths, leaves, scales):
        q_tree[path] = (np.full(np.shape(leaf), np.nan, np.float32)
                        if s is None else np.asarray(leaf, np.float32))
        if s is not None:
            s_by_path[path] = np.asarray(s).reshape(-1)
    q_port_layout = params_from_jax(_unflatten(q_tree))
    want = {k for k, v in q_port_layout.items() if torch.isfinite(v).all()}
    assert want  # the matrices
    assert all(not torch.isfinite(v).any() for k, v in q_port_layout.items()
               if k not in want)

    pm = _port_model(sd, **model_kw)
    got = runners.quantize_inference_params(pm)
    assert set(got) == want
    skipped = {k for k in sd if k not in got}
    assert skipped == set(sd) - want
    assert {"textual.token_embedding.weight", "visual.positional_embedding",
            "textual.positional_embedding", "logit_scale"} <= skipped
    for name, (q, s) in got.items():
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        torch.testing.assert_close(q.float(), q_port_layout[name], rtol=0,
                                   atol=0, msg=name)
    # scales: one per output channel, in channel order
    by_port = {}
    for path, s in s_by_path.items():
        probe = {p: np.full(np.shape(l), np.nan, np.float32)
                 for p, l in zip(paths, leaves)}
        probe[path] = np.zeros(np.shape(dict(zip(paths, leaves))[path]),
                               np.float32)
        name = next(k for k, v in params_from_jax(_unflatten(probe)).items()
                    if torch.isfinite(v).all())
        by_port[name] = s
    assert set(by_port) == want
    for name, s in by_port.items():
        np.testing.assert_array_equal(got[name][1].reshape(-1).numpy(), s,
                                      err_msg=name)
    return got


def test_int8_model_keeps_int8_and_scales_only(weights):
    pm = _port_model(weights[2])
    before = runners.weight_bytes(pm)
    runners.CLIPEncoders(pm, weight_dtype="int8")
    mats = {n: p for n, p in pm.named_parameters() if p.dim() >= 2}
    assert {n for n, p in mats.items() if p.dtype != torch.int8} == {
        "visual.positional_embedding", "visual.temporal_embedding",
        "textual.positional_embedding", "textual.token_embedding.weight"}
    # the quantized weights are rebuilt at use, never stored in f32
    assert pm.visual.transformer.resblocks[0].attn.Wqkv.weight.dtype == \
        torch.float32
    assert runners.weight_bytes(pm) < before
    assert not pm.training


def _jax_service(weights, **kw):
    jm, params, _ = weights
    return JaxClipService(jm, params, batch=4, max_wait_ms=0.5, **kw)


def _embed(svc, clips):
    t = np.asarray(svc.embed_text({"texts": TEXTS})["embeddings"])
    futs = [svc.video_batcher.submit(c) for c in clips]
    return t, np.stack([f.result(60) for f in futs])


def test_int8_service_matches_jax_int8(weights):
    clips = list(_videos(5, 1))
    jax_svc = _jax_service(weights, weight_dtype="int8")
    port_svc = port_server.ClipService(_port_model(weights[2]), batch=4,
                                       max_wait_ms=0.5, weight_dtype="int8")
    try:
        for got, ref in zip(_embed(port_svc, clips), _embed(jax_svc, clips)):
            np.testing.assert_allclose(got, ref, atol=2e-3)
    finally:
        jax_svc.close()
        port_svc.close()


def test_int8_service_close_to_exact(weights):
    clips = list(_videos(3, 2))
    exact = port_server.ClipService(_port_model(weights[2]), batch=4,
                                    max_wait_ms=0.5, weight_dtype="f32")
    quant = port_server.ClipService(_port_model(weights[2]), batch=4,
                                    max_wait_ms=0.5, weight_dtype="int8")
    try:
        for a, b in zip(_embed(exact, clips), _embed(quant, clips)):
            cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))
            assert cos.min() > 0.98, cos
            assert np.abs(a - b).max() > 0  # really quantized
    finally:
        exact.close()
        quant.close()


@pytest.mark.parametrize("dtype", ["fp8", "int4", "bfloat16"])
def test_bad_weight_dtype_raises(weights, dtype):
    with pytest.raises(ValueError, match="bf16\\|int8\\|f32"):
        runners.CLIPEncoders(_port_model(weights[2]), weight_dtype=dtype)


def _start(argv):
    ready = queue.Queue()
    errors = []

    def run():
        try:
            port_server.main(argv, on_ready=ready.put)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            ready.put(None)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    srv = ready.get(timeout=120)
    if srv is None:
        raise errors[0]
    return srv, th


def _get(url, path):
    import json

    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("extra,replicas", [
    (["--weights", "int8"], 1),
    (["--weights", "int8", "--mesh", "mesh.data=2"], 2),
    (["--mesh", "mesh.data=2", "mesh.fsdp=2"], 4),
    (["--mesh", "mesh.data=2", "mesh.sp=2", "mesh.tensor=2"], 2),
])
def test_main_int8_and_mesh_cpu(weights, tmp_path, extra, replicas):
    """``main`` with ``--weights int8`` and / or ``--mesh`` on the CPU:
    the service holds int8 matrices on every replica, /health and
    /metrics list each replica, and the embeddings equal the JAX
    service's of the same weight dtype."""
    ckpt = str(tmp_path / "clip_tiny.pt")
    export_clip_to_pt(weights[1], ckpt)
    srv, th = _start(["model.name=CLIP_TINY", f"data.clip_length={FRAMES}",
                      "model.project_embed_dim=32", "data.val_batch_size=4",
                      f"pretrain_model={ckpt}", "--port", "0", "--device",
                      "cpu", *extra])
    dtype = "int8" if "int8" in extra else "bf16"
    jax_svc = _jax_service(weights, weight_dtype=dtype)
    try:
        enc = srv.service.encoders
        assert len(enc.replicas) == replicas and enc.batch % replicas == 0
        if dtype == "int8":
            for m in enc.replicas:
                assert m.textual.transformer.resblocks[0].mlp.fc1. \
                    parametrizations.weight.original.dtype == torch.int8
        clips = list(_videos(5, 4))
        for got, ref in zip(_embed(srv.service, clips),
                            _embed(jax_svc, clips)):
            np.testing.assert_allclose(got, ref, atol=2e-3)
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        health = _get(url, "/health")
        assert [r["device"] for r in health["replicas"]] == ["cpu"] * replicas
        m = _get(url, "/metrics")["encoder"]
        assert m["weight_dtype"] == dtype and len(m["replicas"]) == replicas
        assert m["image_calls"] == sum(r["image_calls"]
                                       for r in m["replicas"]) > 0
        assert all(r["image_calls"] == m["replicas"][0]["image_calls"]
                   for r in m["replicas"])
    finally:
        srv.shutdown()
        th.join(timeout=30)
        jax_svc.close()
    assert not th.is_alive()


def test_replicated_service_matches_plain(weights):
    """``ClipService`` over data 4 x fsdp 2 CPU replicas against one
    model, texts and videos (``tests/test_serve.py``'s meshed service)."""
    devices = port_server.replica_devices(MeshConfig(data=4, fsdp=2),
                                          torch.device("cpu"))
    assert devices == [torch.device("cpu")] * 8
    plain = port_server.ClipService(_port_model(weights[2]), batch=8,
                                    max_wait_ms=0.5)
    rep = port_server.ClipService(_port_model(weights[2]), batch=8,
                                  max_wait_ms=0.5, devices=devices)
    try:
        clips = list(_videos(11, 5))
        for a, b in zip(_embed(rep, clips), _embed(plain, clips)):
            np.testing.assert_allclose(a, b, atol=2e-3)
        counts = rep.encoders.replica_metrics()
        assert len(counts) == 8
        assert len({c["image_calls"] for c in counts}) == 1
        assert all(c["image_calls"] >= 1 for c in counts)
    finally:
        rep.close()
        plain.close()


@pytest.mark.parametrize("batch", [5, 8, 13])
def test_batch_rounded_as_jax(weights, mesh8, batch):
    jm, params, sd = weights
    ref = JaxCLIPEncoders(jm, params, batch=batch, mesh=mesh8).batch
    enc = runners.CLIPEncoders(_port_model(sd), batch=batch,
                               devices=[torch.device("cpu")] * 8)
    try:
        assert enc.batch == ref == -(-batch // 8) * 8
        # a chunk smaller than the replicas: every replica gets a block
        got = enc.encode_texts(np.zeros((3, 77), np.int64))
        assert got.shape == (3, 32)
    finally:
        enc.close()


@pytest.mark.parametrize("mesh,count,want", [
    (dict(data=-1), 4, 4), (dict(data=2, fsdp=2), 4, 4),
    (dict(data=-1, fsdp=2), 4, 4), (dict(data=2), 8, 2),
    (dict(data=1), 1, 1),
])
def test_replica_devices_cuda(monkeypatch, mesh, count, want):
    """The device list for ``cuda:0..R-1`` with the card count
    monkeypatched; nothing runs on a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    got = port_server.replica_devices(MeshConfig(**mesh),
                                      torch.device("cuda"))
    assert got == [torch.device("cuda", i) for i in range(want)]


@pytest.mark.parametrize("mesh,device,count,want", [
    (dict(data=-1, tensor=2), "cuda", 4, 2),
    (dict(data=2, sp=2), "cpu", 0, 2),
    (dict(data=-1, dcn_data=2), "cuda", 4, 4),
    (dict(data=-1, fsdp=2, sp=2, dcn_data=1), "cuda", 8, 4),
    (dict(data=2, tensor=2, dcn_data=2), "cuda", 4, 2),
    (dict(data=-1, pp=2), "cuda", 4, 2),
    (dict(data=2, ep=2), "cpu", 0, 2),
])
def test_replica_devices_other_axes(monkeypatch, mesh, device, count, want):
    """``tensor``, ``sp``, ``pp``, ``ep`` and ``dcn_data``: ``data x fsdp``
    replicas, the JAX encoders' batch shards, with ``data=-1`` resolved
    over ``fsdp x pp x sp x ep x tensor`` of the cards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    got = port_server.replica_devices(MeshConfig(**mesh),
                                      torch.device(device))
    one = torch.device("cpu") if device == "cpu" else None
    assert got == [one or torch.device("cuda", i) for i in range(want)]


@pytest.mark.parametrize("mesh,device,error,match", [
    (dict(data=4, tensor=2), "cuda", ValueError, "asks for 8 cards"),
    (dict(data=-1, dcn_data=3), "cuda", ValueError, "multiple of dcn_data"),
    (dict(data=8), "cuda", ValueError, "4 cards"),
    (dict(data=-1, fsdp=3), "cuda", ValueError, "divide"),
    (dict(data=-1), "cpu", ValueError, "needs mesh.data"),
    (dict(data=2), "cuda:1", ValueError, "cuda:0..R-1"),
])
def test_replica_devices_raise(monkeypatch, mesh, device, error, match):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(error, match=match):
        port_server.replica_devices(MeshConfig(**mesh), torch.device(device))
