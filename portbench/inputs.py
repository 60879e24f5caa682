"""The one generator of every cell's inputs, driven by the traffic file.

A traffic file's ``batch`` rows a batch and ``batches`` distinct batches,
which the window cycles through; each batch holds what the file asks for:

- ``video``: uint8 clips [batch, frames, size, size, 3], uniform in 0-255;
- ``text``: token ids [batch, context]: ``sot`` first, a caption of
  uniform length in ``min_len`` - ``max_len`` tokens (both ends
  included), ids uniform in ``low`` - ``high`` (``high`` excluded),
  ``eot`` last, zeros after;
- ``tube_mask``: VideoMAE's tube masks, as ``mask``: [batch, tubes]
  (True: masked), each row hiding ``int(mask_ratio * g * g)`` of a
  frame's g x g positions, the same ones in every tubelet, at the
  configuration's geometry.

Every draw comes from one generator on the device seeded from ``--seed``,
all batches of a kind in one call: the same seed gives the same inputs,
and every seed the same sizes.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.weights import INPUTS_STREAM, generator


def make(config: dict, traffic: dict, seed: int,
         device) -> List[Dict[str, torch.Tensor]]:
    g = generator(seed, INPUTS_STREAM, device)
    n, b = traffic["batches"], traffic["batch"]
    parts: Dict[str, torch.Tensor] = {}
    if "video" in traffic:
        v = traffic["video"]
        parts["video"] = torch.randint(
            0, 256, (n, b, v["frames"], v["size"], v["size"], 3),
            generator=g, device=device, dtype=torch.uint8)
    if "text" in traffic:
        t = traffic["text"]
        ctx = t["context"]
        lengths = torch.randint(t["min_len"], t["max_len"] + 1, (n, b, 1),
                                generator=g, device=device)
        ids = torch.randint(t["low"], t["high"], (n, b, ctx), generator=g,
                            device=device)
        pos = torch.arange(ctx, device=device)
        ids = torch.where(pos <= lengths, ids, 0)
        ids = torch.where(pos == lengths + 1, t["eot"], ids)
        ids[..., 0] = t["sot"]
        parts["text"] = ids.to(torch.int32)
    if "tube_mask" in traffic:
        g_side = config["image_size"] // config["patch_size"]
        frames = traffic["video"]["frames"] // config["tubelet_size"]
        per_frame = g_side * g_side
        hidden = int(config["mask_ratio"] * per_frame)
        noise = torch.rand(n, b, per_frame, generator=g, device=device)
        ranks = noise.argsort(dim=-1).argsort(dim=-1)
        parts["mask"] = (ranks < hidden).repeat(1, 1, frames)
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]
