"""HTTP inference server over a CLIP dual encoder
(``avion_tpu.serve.server``).  stdlib ``ThreadingHTTPServer`` front end,
one ``MicroBatcher`` per modality feeding the encoders on one device.

Endpoints (JSON in/out):

- ``GET  /health``        → liveness + device/platform info
- ``GET  /metrics``       → request counts, batch histogram, latency pXX
- ``POST /v1/embed/text`` ``{"texts": [...]}`` → unit-norm embeddings
- ``POST /v1/embed/video`` ``{"frames_b64": ..., "shape": [N,T,H,W,3]}``
  (raw uint8 bytes, base64) → unit-norm embeddings
- ``POST /v1/similarity`` ``{"texts": [...], "frames_b64": ...}`` →
  temperature-scaled logits [n_videos, n_texts]
- ``POST /v1/classify`` ``{"labels": [...], "frames_b64": ...}`` →
  zero-shot class probabilities (template-ensemble classifier, cached
  per label set)

Not in this port yet: ``paths`` input with server-side decode (answered
with a 400), ``/v1/narrate``, ``--mesh``, ``--weights int8`` and orbax
checkpoint directories.

Start::

    python -m avion_tpu_torch.serve model.name=CLIP_VITB16 \\
        data.clip_length=4 pretrain_model=<ckpt.pt> --port 8080 \\
        [--host 0.0.0.0] [--weights bf16|f32] [--device cuda|cuda:N|cpu]

It serves on CUDA unless ``--device cpu`` is given, and raises when CUDA
is missing.
"""

from __future__ import annotations

import base64
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

import numpy as np
import torch

from avion_tpu_torch.serve.batcher import MicroBatcher

_DEFERRED_FLAGS = ("--mesh", "--narrator-checkpoint", "--narrator-model")


def clips_from_request(req: dict, clip_length: int,
                       size: int) -> List[np.ndarray]:
    if "frames_b64" in req:
        shape = tuple(req["shape"])
        if len(shape) != 5 or shape[1] != clip_length or shape[4] != 3:
            raise ValueError(
                f"shape must be [N, {clip_length}, H, W, 3], "
                f"got {list(shape)}")
        if shape[2] != size or shape[3] != size:
            raise ValueError(f"frames must be {size}px square (pre-resized)")
        raw = base64.b64decode(req["frames_b64"])
        return list(np.frombuffer(raw, np.uint8).reshape(shape))
    if "paths" in req:
        raise ValueError("server-side decode of 'paths' is not in the "
                         "PyTorch port yet; send 'frames_b64'")
    raise ValueError("request needs 'frames_b64'")


class ClipService:
    """Model side of the server: tokenize / encode, batched."""

    def __init__(self, model, *, batch: int = 32, max_wait_ms: float = 2.0,
                 clip_length: Optional[int] = None,
                 weight_dtype: str = "bf16"):
        from avion_tpu_torch.eval.runners import CLIPEncoders

        self.model = model
        self.clip_length = clip_length or model.num_frames
        self.encoders = CLIPEncoders(model, batch=batch,
                                     weight_dtype=weight_dtype)
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
                                  self.model.image_size)

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
        # tower forwards run: each runs every attention layer of its tower
        return {"text": self.text_batcher.metrics(),
                "video": self.video_batcher.metrics(),
                "encoder": {"image_calls": self.encoders.image_calls,
                            "text_calls": self.encoders.text_calls}}

    def close(self):
        self.text_batcher.close()
        self.video_batcher.close()


def make_server(service: ClipService, port: int = 0,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``server.server_address[1]``
    is the bound port (ephemeral when ``port=0``)."""
    device = service.encoders.device
    health = {"status": "ok",
              "platform": "gpu" if device.type == "cuda" else device.type,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else str(device)),
              "model": type(service.model).__name__}

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
                self._json(200, service.metrics())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            routes = {"/v1/embed/text": service.embed_text,
                      "/v1/embed/video": service.embed_video,
                      "/v1/similarity": service.similarity,
                      "/v1/classify": service.classify}
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

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever_in_thread(server) -> threading.Thread:
    th = threading.Thread(target=server.serve_forever, daemon=True,
                          name="http-serve")
    th.start()
    return th


def resolve_device(name: str) -> torch.device:
    """``cuda`` / ``cuda:N`` / ``cpu``; a CUDA device without CUDA raises
    (the port never falls back to the CPU on its own)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "serve on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda[:N] or cpu, got {name!r}")
    return device


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

    for name in _DEFERRED_FLAGS:
        if name in argv:
            raise SystemExit(f"{name} is not in the PyTorch port yet")
    port = int(_flag("--port", "8080"))
    host = _flag("--host", "127.0.0.1")
    weight_dtype = _flag("--weights", "bf16")
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
        temperature_init=m.temperature_init)
    load_clip_checkpoint(model, cfg.pretrain_model)
    service = ClipService(model.to(device), batch=cfg.data.val_batch_size,
                          weight_dtype=weight_dtype)
    server = make_server(service, port=port, host=host)
    print(f"serving {m.name} on {device} at :{server.server_address[1]}",
          flush=True)
    try:
        if on_ready is not None:
            on_ready(server)
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
