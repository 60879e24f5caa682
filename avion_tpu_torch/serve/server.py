"""HTTP inference server over a CLIP dual encoder
(``avion_tpu.serve.server``).  stdlib ``ThreadingHTTPServer`` front end,
one ``MicroBatcher`` per modality feeding the encoders on one device, or on
one model copy per local card with ``--mesh``.

Endpoints (JSON in/out):

- ``GET  /health``        → liveness + device/platform info
- ``GET  /metrics``       → request counts, batch histogram, latency pXX
- ``POST /v1/embed/text`` ``{"texts": [...]}`` → unit-norm embeddings
- ``POST /v1/embed/video`` ``{"paths": [...]}`` (server-side decode on
  the request thread: uniform temporal sampling between the optional
  ``start`` / ``end`` seconds, short side resized, center crop) or
  ``{"frames_b64": ..., "shape": [N,T,H,W,3]}`` (raw uint8 bytes, base64)
  → unit-norm embeddings
- ``POST /v1/similarity`` ``{"texts": [...], "paths"|"frames_b64": ...}``
  → temperature-scaled logits [n_videos, n_texts]
- ``POST /v1/classify`` ``{"labels": [...], "paths"|"frames_b64": ...}``
  → zero-shot class probabilities (template-ensemble classifier, cached
  per label set)
- ``POST /v1/narrate`` ``{"paths"|"frames_b64": ...}`` → generated
  narrations per clip (with ``--narrator-checkpoint``: the LaViLa
  narrator, ``--narrator-model``, from a released ``.pt``, with KV-cached
  decoding, one clip at a time)

A bad request (a missing key, a wrong shape, a path that escapes
``--media-root``) is answered with 400, any other failure (a file that
does not decode) with 500, as the JAX server answers.  Orbax checkpoint
directories are not read.

Start::

    python -m avion_tpu_torch.serve model.name=CLIP_VITB16 \\
        data.clip_length=4 pretrain_model=<ckpt.pt> --port 8080 \\
        [--host 0.0.0.0 --media-root /data/videos] \\
        [--weights bf16|int8|f32] [--device cuda|cuda:N|cpu] \\
        [--mesh mesh.data=-1] \\
        [--narrator-checkpoint <narrator.pt> --narrator-model \\
         VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL]

``--media-root`` confines the ``paths`` a client may name to a directory.
``--weights int8`` stores the encoders' matrices as int8 with per-channel
f32 scales (lossy, about 0.4% a weight; ``eval.runners.
quantize_inference_params``).  ``--mesh`` serves one model copy per card:
``mesh.data`` x ``mesh.fsdp`` replicas on ``cuda:0..R-1``
(``mesh.data=-1`` takes every visible card; with ``--device cpu`` the
count must be given), each encode batch split into row blocks over them
(:func:`replica_devices`).

The narrator decodes its generations with GPT-2's tokenizer
(``tools.narrator.gpt2_tokenizer``: ``transformers`` and its ``gpt2``
vocabulary must be installed).

It serves on CUDA unless ``--device cpu`` is given, and raises when CUDA
is missing.
"""

from __future__ import annotations

import base64
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

import numpy as np
import torch

from avion_tpu_torch.parallel.launch import resolve_device
from avion_tpu_torch.serve.batcher import MicroBatcher


def decode_clip(path: str, clip_length: int, size: int,
                start: Optional[float] = None,
                end: Optional[float] = None) -> np.ndarray:
    """Uniform temporal sampling + center crop-resize to a square
    input; returns [T, S, S, 3] uint8."""
    import cv2

    from avion_tpu_torch.data.video_reader import VideoReader

    vr = VideoReader(path)
    try:
        fps = vr.get_avg_fps() or 30.0
        lo = int((start or 0.0) * fps)
        hi = int(end * fps) if end is not None else len(vr)
        hi = max(lo + 1, min(hi, len(vr)))
        ids = np.linspace(lo, hi - 1, clip_length).astype(int)
        frames = vr.get_batch(list(ids))
    finally:
        vr.close()
    t, h, w = frames.shape[:3]
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.empty((t, nh, nw, 3), np.uint8)
    for i in range(t):
        out[i] = cv2.resize(frames[i], (nw, nh),
                            interpolation=cv2.INTER_LINEAR)
    y0, x0 = (nh - size) // 2, (nw - size) // 2
    return out[:, y0 : y0 + size, x0 : x0 + size]


def resolve_media_path(path: str, media_root: Optional[str]) -> str:
    """Resolve a client-supplied path against the configured media root.

    With no root configured the server trusts its caller (loopback-only
    by default); with one, any path escaping the root is rejected so a
    network client cannot probe arbitrary server-side files."""
    if media_root is None:
        return path
    root = os.path.realpath(media_root)
    full = os.path.realpath(os.path.join(root, path.lstrip("/")))
    if full != root and not full.startswith(root + os.sep):
        raise ValueError(f"path escapes media root: {path!r}")
    return full


def clips_from_request(req: dict, clip_length: int, size: int,
                       media_root: Optional[str] = None) -> List[np.ndarray]:
    """The request's clips, [T, size, size, 3] uint8 each; ``paths`` are
    decoded here, on the calling (request) thread."""
    if "frames_b64" in req:
        shape = tuple(req["shape"])
        if len(shape) != 5 or shape[1] != clip_length or shape[4] != 3:
            raise ValueError(
                f"shape must be [N, {clip_length}, H, W, 3], "
                f"got {list(shape)}")
        raw = base64.b64decode(req["frames_b64"])
        arr = np.frombuffer(raw, np.uint8).reshape(shape)
        if shape[2] != size or shape[3] != size:
            raise ValueError(
                f"frames must be {size}px square (pre-resized); "
                "use 'paths' for server-side resize")
        return list(arr)
    if "paths" in req:
        return [decode_clip(resolve_media_path(p, media_root), clip_length,
                            size, req.get("start"), req.get("end"))
                for p in req["paths"]]
    raise ValueError("request needs 'paths' or 'frames_b64'")


def replica_devices(mesh, device: torch.device) -> List[torch.device]:
    """The devices of ``--mesh``'s replicas: ``mesh.data`` x ``mesh.fsdp``
    of them, ``cuda:0..R-1`` on CUDA or R CPU replicas with ``--device
    cpu``, where ``mesh.data`` must be given.  ``mesh.data=-1`` takes what
    ``fsdp x pp x sp x ep x tensor`` leave of the visible cards
    (``parallel.mesh.axis_sizes``).  As in the JAX encoders, which shard
    only the batch, the ``pp``, ``sp``, ``ep`` and ``tensor`` devices of a
    replica would hold whole copies of the same rows: the replica's one
    card does their work, and they count only towards the cards the mesh
    needs.  ``dcn_data`` must divide ``data``; more cards than the host has
    raise."""
    from avion_tpu_torch.parallel.mesh import axis_sizes

    if device.index is not None:
        raise ValueError(f"--mesh places its replicas on cuda:0..R-1; "
                         f"give --device cuda or cpu, not {device}")
    # the cards of one replica's rows
    per = mesh.pp * mesh.sp * mesh.ep * mesh.tensor
    if device.type == "cpu":
        if mesh.data == -1:
            raise ValueError("--mesh with --device cpu needs mesh.data")
        count = mesh.data * mesh.fsdp * per
    else:
        count = torch.cuda.device_count()
    sizes = axis_sizes(
        count if mesh.data == -1 else mesh.data * mesh.fsdp * per,
        data=mesh.data, fsdp=mesh.fsdp, pp=mesh.pp, sp=mesh.sp, ep=mesh.ep,
        tensor=mesh.tensor)
    if sizes["data"] % mesh.dcn_data:
        raise ValueError(f"data axis {sizes['data']} must be a multiple of "
                         f"dcn_data {mesh.dcn_data}")
    n = sizes["data"] * sizes["fsdp"]
    if n * per > count:
        raise ValueError(f"--mesh asks for {n * per} cards; this host has "
                         f"{count} cards")
    if device.type == "cpu":
        return [device] * n
    return [torch.device("cuda", i) for i in range(n)]


class NarrateService:
    """The narration endpoint over any ``caption_fn(frames) -> [str]``
    (``tools.narrator``'s captioners).  The batcher serializes the card
    against concurrent requests, one clip at a time; generation batches
    inside through ``num_samples``."""

    def __init__(self, caption_fn, *, clip_length: int, image_size: int,
                 media_root: Optional[str] = None):
        self.clip_length = clip_length
        self.image_size = image_size
        self.media_root = media_root
        self.batcher = MicroBatcher(
            lambda clips: [caption_fn(c) for c in clips],
            max_batch=1, max_wait_ms=0.0, name="narrate")

    def narrate(self, req: dict) -> dict:
        clips = clips_from_request(req, self.clip_length, self.image_size,
                                   self.media_root)
        futs = [self.batcher.submit(c) for c in clips]
        return {"narrations": [f.result(timeout=600) for f in futs]}

    def metrics(self) -> dict:
        return self.batcher.metrics()

    def close(self):
        self.batcher.close()


class ClipService:
    """Model side of the server: decode / tokenize / encode, batched.
    With ``devices`` the encoders keep one copy of ``model`` on each
    (``CLIPEncoders``)."""

    def __init__(self, model, *, batch: int = 32, max_wait_ms: float = 2.0,
                 clip_length: Optional[int] = None,
                 weight_dtype: str = "bf16",
                 media_root: Optional[str] = None,
                 devices: Optional[List[torch.device]] = None):
        from avion_tpu_torch.eval.runners import CLIPEncoders

        self.model_name = type(model).__name__
        self.media_root = media_root
        self.clip_length = clip_length or model.num_frames
        self.encoders = CLIPEncoders(model, batch=batch,
                                     weight_dtype=weight_dtype,
                                     devices=devices)
        self.model = self.encoders.model
        self.text_batcher = MicroBatcher(self._encode_texts, max_batch=batch,
                                         max_wait_ms=max_wait_ms, name="text")
        self.video_batcher = MicroBatcher(self._encode_videos,
                                          max_batch=batch,
                                          max_wait_ms=max_wait_ms,
                                          name="video")
        self._clf_cache: dict = {}

    # -- device-thread callbacks (run inside the batchers) --------------

    def _encode_texts(self, items: List) -> List[np.ndarray]:
        from avion_tpu_torch.data.tokenizer import tokenize
        from avion_tpu_torch.eval.runners import build_text_classifier

        # classifier builds ride the same device thread
        out: List = [None] * len(items)
        texts, idxs = [], []
        for i, it in enumerate(items):
            if isinstance(it, tuple) and it and it[0] == "__build_clf__":
                out[i] = build_text_classifier(
                    self.encoders, it[1],
                    context_length=self.model.context_length)
            else:
                texts.append(it)
                idxs.append(i)
        if texts:
            toks = np.atleast_2d(tokenize(
                texts, context_length=self.model.context_length))
            emb = self.encoders.encode_texts(toks)
            emb /= np.clip(np.linalg.norm(emb, axis=-1, keepdims=True),
                           1e-9, None)
            for i, e in zip(idxs, emb):
                out[i] = e
        return out

    def _encode_videos(self, clips: List[np.ndarray]) -> List[np.ndarray]:
        emb = self.encoders.encode_images(np.stack(clips))
        emb /= np.clip(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-9,
                       None)
        return list(emb)

    # -- endpoint handlers ----------------------------------------------

    def clips_from_request(self, req: dict) -> List[np.ndarray]:
        return clips_from_request(req, self.clip_length,
                                  self.model.image_size, self.media_root)

    def embed_text(self, req: dict) -> dict:
        futs = [self.text_batcher.submit(t) for t in req["texts"]]
        return {"embeddings": [f.result(timeout=120).tolist()
                               for f in futs]}

    def embed_video(self, req: dict) -> dict:
        futs = [self.video_batcher.submit(c)
                for c in self.clips_from_request(req)]
        return {"embeddings": [f.result(timeout=300).tolist()
                               for f in futs]}

    def classify(self, req: dict) -> dict:
        labels = req["labels"]
        if not isinstance(labels, list) or not labels:
            raise ValueError("'labels' must be a non-empty list")
        key = tuple(labels)
        clf = self._clf_cache.get(key)
        if clf is None:
            clf = self.text_batcher.submit(("__build_clf__", labels)).result(
                timeout=600)
            if len(self._clf_cache) > 32:  # bound memory
                self._clf_cache.clear()
            self._clf_cache[key] = clf
        vfuts = [self.video_batcher.submit(c)
                 for c in self.clips_from_request(req)]
        v = np.stack([f.result(timeout=300) for f in vfuts])
        logits = np.exp(self.encoders.logit_scale()) * v @ clf.T
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        top = probs.argmax(-1)
        return {"probs": probs.tolist(),
                "top": [{"label": labels[i], "prob": float(probs[n, i])}
                        for n, i in enumerate(top)]}

    def similarity(self, req: dict) -> dict:
        vfuts = [self.video_batcher.submit(c)
                 for c in self.clips_from_request(req)]
        tfuts = [self.text_batcher.submit(t) for t in req["texts"]]
        v = np.stack([f.result(timeout=300) for f in vfuts])
        t = np.stack([f.result(timeout=120) for f in tfuts])
        return {"logits": (np.exp(self.encoders.logit_scale())
                           * v @ t.T).tolist()}

    def metrics(self) -> dict:
        # tower forwards run, summed over the replicas: each runs every
        # attention layer of its tower
        return {"text": self.text_batcher.metrics(),
                "video": self.video_batcher.metrics(),
                "encoder": {"image_calls": self.encoders.image_calls,
                            "text_calls": self.encoders.text_calls,
                            "weight_dtype": self.encoders.weight_dtype,
                            "replicas": self.encoders.replica_metrics()}}

    def close(self):
        self.text_batcher.close()
        self.video_batcher.close()
        self.encoders.close()


def make_server(service: ClipService, port: int = 0,
                host: str = "127.0.0.1",
                narrate: Optional[NarrateService] = None
                ) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``server.server_address[1]``
    is the bound port (ephemeral when ``port=0``), ``server.service`` the
    service.  With ``narrate`` it also answers ``/v1/narrate``."""
    devices = service.encoders.devices
    names = [torch.cuda.get_device_name(d) if d.type == "cuda" else str(d)
             for d in devices]
    health = {"status": "ok",
              "platform": "gpu" if devices[0].type == "cuda"
              else devices[0].type,
              "device": names[0],
              "replicas": [{"device": str(d), "name": n}
                           for d, n in zip(devices, names)],
              "model": service.model_name}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, health)
            elif self.path == "/metrics":
                m = service.metrics()
                if narrate is not None:
                    m["narrate"] = narrate.metrics()
                self._json(200, m)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            routes = {"/v1/embed/text": service.embed_text,
                      "/v1/embed/video": service.embed_video,
                      "/v1/similarity": service.similarity,
                      "/v1/classify": service.classify}
            if narrate is not None:
                routes["/v1/narrate"] = narrate.narrate
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path not in routes:
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                self._json(200, routes[self.path](req))
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — server must not die
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    server.service = service
    return server


def serve_forever_in_thread(server) -> threading.Thread:
    th = threading.Thread(target=server.serve_forever, daemon=True,
                          name="http-serve")
    th.start()
    return th


def main(argv=None,
         on_ready: Optional[Callable[[ThreadingHTTPServer], None]] = None):
    """Serve until the server is shut down.  ``on_ready(server)`` runs once
    the socket is bound, before serving: an embedding program learns the
    port from ``server.server_address`` and stops it with
    ``server.shutdown()``."""
    from avion_tpu_torch.core.config import TrainConfig, load_dotenv
    from avion_tpu_torch.models.pt_import import load_clip_checkpoint
    from avion_tpu_torch.models.registry import create_model

    load_dotenv()
    argv = list(argv if argv is not None else sys.argv[1:])

    def _flag(name, default=None):
        if name in argv:
            i = argv.index(name)
            if i + 1 >= len(argv):
                raise SystemExit(f"usage: {name} <value> (missing value)")
            val = argv[i + 1]
            del argv[i : i + 2]
            return val
        return default

    port = int(_flag("--port", "8080"))
    # loopback by default: 'paths' name server-side files, so external
    # binding is opt-in (pair it with --media-root)
    host = _flag("--host", "127.0.0.1")
    media_root = _flag("--media-root")
    use_mesh = "--mesh" in argv
    if use_mesh:
        argv.remove("--mesh")
    weight_dtype = _flag("--weights", "bf16")
    narrator_ckpt = _flag("--narrator-checkpoint")
    narrator_name = _flag("--narrator-model",
                          "VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL")
    device = resolve_device(_flag("--device", "cuda"))
    cfg = TrainConfig().apply_overrides(argv)
    m = cfg.model
    if not cfg.pretrain_model:
        raise SystemExit("pretrain_model=<ckpt.pt> is required")
    if not cfg.pretrain_model.endswith((".pt", ".pth")):
        raise SystemExit("the PyTorch port loads .pt/.pth checkpoints only")
    model = create_model(
        m.name, num_frames=cfg.data.clip_length,
        project_embed_dim=m.project_embed_dim,
        use_quick_gelu=m.use_quick_gelu, pooling=m.pooling,
        temperature_init=m.temperature_init, moe_experts=m.moe_experts)
    devices = replica_devices(cfg.mesh, device) if use_mesh else [device]
    load_clip_checkpoint(model, cfg.pretrain_model)
    service = ClipService(model, batch=cfg.data.val_batch_size,
                          weight_dtype=weight_dtype, media_root=media_root,
                          devices=devices)
    narrate = None
    if narrator_ckpt:
        from avion_tpu_torch.tools import narrator as narrator_tools

        with torch.device("meta"):
            nmodel = create_model(narrator_name,
                                  num_frames=cfg.data.clip_length)
        nmodel = nmodel.to_empty(device=device)
        narrate = NarrateService(
            narrator_tools.lavila_captioner(
                narrator_ckpt, model=nmodel,
                num_frames=cfg.data.clip_length),
            clip_length=cfg.data.clip_length, image_size=nmodel.image_size,
            media_root=media_root)
    server = make_server(service, port=port, host=host, narrate=narrate)
    where = ", ".join(str(d) for d in devices)
    print(f"serving {m.name} ({weight_dtype}) on {where} at "
          f":{server.server_address[1]}", flush=True)
    try:
        if on_ready is not None:
            on_ready(server)
        server.serve_forever()
    finally:
        server.server_close()
        service.close()
        if narrate is not None:
            narrate.close()


if __name__ == "__main__":
    main()
