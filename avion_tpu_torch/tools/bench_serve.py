"""Serving throughput (``avion_tpu.tools.bench_serve``): HTTP, the
micro-batcher and the encoders on the card, end to end.

Starts the port's ``ClipService`` behind ``make_server`` in this process
(random weights drawn from a seed, stored as ``--weights``: bf16, int8
through ``eval.runners.quantize_inference_params``, or f32), floods
``/v1/embed/text`` and ``/v1/embed/video`` with concurrent single-item
requests (the serving worst case: coalescing is what fills the card's
batches) and reports embeds/s with the server's own ``/metrics``
percentiles.  Both towers run the inference flash kernel.  Client wall
time is the host clock; the card's name and power limit go to stderr.

Usage: python -m avion_tpu_torch.tools.bench_serve [--model CLIP_VITB16]
    [--batch 32] [--texts 512] [--videos 64] [--threads 16]
    [--weights bf16|int8|f32] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures as cf
import json
import sys
import time
import urllib.request

import numpy as np
import torch

from avion_tpu_torch.core.profiling import card_line
from avion_tpu_torch.parallel.launch import resolve_device


def _post(url, path, obj, timeout=300):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def main(argv=None) -> dict:
    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.serve.server import (ClipService, make_server,
                                              serve_forever_in_thread)

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="CLIP_VITB16")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--texts", type=int, default=512)
    ap.add_argument("--videos", type=int, default=64)
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--weights", default="bf16",
                    help="encoder weight storage: bf16 (exact) | int8 "
                         "(weight-only quantized) | f32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(card_line(device), file=sys.stderr)

    with torch.device("meta"):
        model = create_model(args.model, num_frames=args.frames,
                             use_flash_attn=True)
    model = model.to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    service = ClipService(model, batch=args.batch, max_wait_ms=3.0,
                          weight_dtype=args.weights, devices=[device])
    server = make_server(service, port=0)
    th = serve_forever_in_thread(server)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        # warm both towers (the kernels' first build on a fresh machine)
        _post(url, "/v1/embed/text", {"texts": ["warmup"]}, timeout=600)
        rs = np.random.RandomState(0)
        size = service.model.image_size
        frame = rs.randint(0, 255, (1, args.frames, size, size, 3),
                           np.uint8)
        payload = {"frames_b64": base64.b64encode(frame.tobytes()).decode(),
                   "shape": list(frame.shape)}
        _post(url, "/v1/embed/video", payload, timeout=600)

        # text flood: 1-item concurrent requests
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(args.threads) as pool:
            list(pool.map(
                lambda i: _post(url, "/v1/embed/text",
                                {"texts": [f"a person does action {i}"]}),
                range(args.texts)))
        text_dt = time.perf_counter() - t0

        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(args.threads) as pool:
            list(pool.map(lambda i: _post(url, "/v1/embed/video", payload),
                          range(args.videos)))
        video_dt = time.perf_counter() - t0
        m = service.metrics()
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=5)
        service.close()
    out = {"metric": "serving_throughput",
           "text_embeds_per_sec": args.texts / text_dt,
           "video_embeds_per_sec": args.videos / video_dt,
           "unit": "requests/s (1-item requests)",
           "text_mean_batch": m["text"]["mean_batch"],
           "video_mean_batch": m["video"]["mean_batch"],
           "text_p95_ms": m["text"]["latency_p95_ms"],
           "video_p95_ms": m["video"]["latency_p95_ms"],
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else str(device))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
