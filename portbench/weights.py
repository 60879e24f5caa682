"""Seeded weights, made on the device in one draw.

A spec is a list of (name, shape, kind, scale): ``normal`` draws
``scale * N(0, 1)``, ``one_plus`` draws ``1 + scale * N(0, 1)`` (norm
gains), ``const`` is ``scale`` itself.  Every weight is a view of one f32
buffer filled by a single ``torch.randn`` from a generator on the device,
seeded from ``--seed``: the same seed gives the same weights, bit for bit,
on the same device.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

WEIGHTS_STREAM = 1
INPUTS_STREAM = 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one of the run's streams: the seed's
    low 60 bits and the stream's 4."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & (2 ** 60 - 1)) << 4) | stream)
    return g


def make(spec: List[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    buf = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS_STREAM,
                                                      device),
                      device=device, dtype=torch.float32)
    out, offset = {}, 0
    for (name, shape, kind, scale), n in zip(spec, sizes):
        view = buf[offset:offset + n].view(shape)
        offset += n
        if kind == "normal":
            view.mul_(scale)
        elif kind == "one_plus":
            view.mul_(scale).add_(1.0)
        elif kind == "const":
            view.fill_(scale)
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {name}")
        out[name] = view
    return out
