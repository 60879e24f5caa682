"""Plain f32 VideoMAE pretraining (arXiv:2203.12602): the encoder on the
visible tubes, the decoder on all of them, the normalized-pixel loss, and
the FLOPs of its train step.

- A uint8 clip [B, T, H, W, 3] is scaled to [0, 1] and normalized with the
  configuration's mean and std, then cut into tubes of ``tubelet_size``
  frames by p x p pixels, N of them in (time, row, column) order, each
  flattened in (frame, p_h, p_w, C) order: the layout of the patch
  embedding ``patch_embed.weight`` [width, tubelet * p * p * 3] and of the
  target.
- The tube mask [B, N] (True: masked) hides the same count in every row.
  The visible tubes, in token order, are embedded and get the fixed
  sinusoid table's rows; the encoder's blocks, ``encoder_norm``, and
  ``encoder_to_decoder`` (no bias) follow.  The decoder sees the visible
  tokens and one ``mask_token`` per masked tube, each plus its row of the
  decoder's sinusoid table, visible first; after its blocks and
  ``decoder_norm``, ``decoder_head`` predicts the masked tubes' pixels.
- The target: each masked tube's pixels normalized per channel over its
  tubelet * p * p elements (mean, unbiased variance, divided by
  ``sqrt(var) + 1e-6``); the loss is the mean squared error over every
  masked tube's every value.

The loss is a mean over the batch's rows, so :func:`loss_and_grad` takes
blocks of rows, each contributing its sum over the whole batch's count.
"""

from __future__ import annotations

from typing import Callable, Dict

import math

import torch

from portbench.flops import StepWork
from portbench.reference.layers import (ACTIVATIONS, block_spec, dense,
                                        layer_norm, stack)


def sincos_table(n_pos: int, dim: int, device=None) -> torch.Tensor:
    """The fixed table [n_pos, dim]: position / 10000^(2 (i // 2) / dim),
    its sine in the even columns and cosine in the odd ones."""
    pos = torch.arange(n_pos, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(dim, device=device)[None, :]
    angle = pos / torch.pow(10000.0, (2 * (i // 2)).double() / dim)
    table = torch.where(i % 2 == 0, torch.sin(angle), torch.cos(angle))
    return table.float()


def geometry(config: dict) -> dict:
    g = config["image_size"] // config["patch_size"]
    frames = config["num_frames"] // config["tubelet_size"]
    n = frames * g * g
    n_masked = int(g * g * config["mask_ratio"]) * frames
    return {"tokens": n, "masked": n_masked, "visible": n - n_masked,
            "patch_dim": 3 * config["tubelet_size"]
            * config["patch_size"] ** 2}


def weight_spec(config: dict, traffic: dict) -> list:
    ew, dw = config["encoder_width"], config["decoder_width"]
    pd = geometry(config)["patch_dim"]
    spec = [("mask_token", (dw,), "normal", 0.02),
            ("patch_embed.weight", (ew, pd), "normal", pd ** -0.5),
            ("patch_embed.bias", (ew,), "normal", 0.02)]
    for i in range(config["encoder_layers"]):
        spec += block_spec(f"encoder.resblocks.{i}", ew, config["mlp_ratio"])
    spec += [("encoder_norm.weight", (ew,), "one_plus", 0.1),
             ("encoder_norm.bias", (ew,), "normal", 0.02),
             ("encoder_to_decoder.weight", (dw, ew), "normal", ew ** -0.5)]
    for i in range(config["decoder_layers"]):
        spec += block_spec(f"decoder.resblocks.{i}", dw, config["mlp_ratio"])
    spec += [("decoder_norm.weight", (dw,), "one_plus", 0.1),
             ("decoder_norm.bias", (dw,), "normal", 0.02),
             ("decoder_head.weight", (pd, dw), "normal", dw ** -0.5),
             ("decoder_head.bias", (pd,), "normal", 0.02)]
    return spec


def step_work(config: dict, traffic: dict) -> StepWork:
    b = traffic["batch"]
    geo = geometry(config)
    ew, dw = config["encoder_width"], config["decoder_width"]
    work = StepWork()
    work.add_dense(b * geo["visible"], geo["patch_dim"], ew)
    work.add_tower(b, geo["visible"], ew, config["encoder_layers"],
                   config["encoder_heads"], False, config["mlp_ratio"])
    work.add_dense(b * geo["visible"], ew, dw)
    work.add_tower(b, geo["tokens"], dw, config["decoder_layers"],
                   config["decoder_heads"], False, config["mlp_ratio"])
    work.add_dense(b * geo["masked"], dw, geo["patch_dim"])
    return work


def tubes(config: dict, video: torch.Tensor) -> torch.Tensor:
    """Normalized clip -> [B, N, tubelet * p * p * C]."""
    b, t, h, w, c = video.shape
    p, ts = config["patch_size"], config["tubelet_size"]
    x = video.reshape(b, t // ts, ts, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, (t // ts) * (h // p) * (w // p), ts * p * p * c)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def squared_error(config: dict, w: Dict[str, torch.Tensor],
                  video: torch.Tensor, mask: torch.Tensor, mm: Callable
                  ) -> torch.Tensor:
    """The sum of the squared errors of these rows' masked tubes."""
    geo = geometry(config)
    mean = torch.tensor(config["input_mean"], device=video.device)
    std = torch.tensor(config["input_std"], device=video.device)
    x = tubes(config, (video.float() / 255.0 - mean) / std)
    order = torch.argsort(mask.to(torch.int32), dim=-1, stable=True)
    vis, hid = order[:, :geo["visible"]], order[:, geo["visible"]:]
    act = ACTIVATIONS[config["activation"]]
    n = geo["tokens"]
    epos = sincos_table(n, config["encoder_width"], video.device)
    dpos = sincos_table(n, config["decoder_width"], video.device)
    h = dense(_rows(x, vis), w, "patch_embed", mm) + epos[vis]
    h = stack(h, w, "encoder.resblocks", config["encoder_layers"],
              config["encoder_heads"], False, act, mm)
    h = dense(layer_norm(h, w, "encoder_norm"), w, "encoder_to_decoder", mm)
    tokens = torch.cat([h + dpos[vis], w["mask_token"] + dpos[hid]], dim=1)
    tokens = stack(tokens, w, "decoder.resblocks", config["decoder_layers"],
                   config["decoder_heads"], False, act, mm)
    tokens = layer_norm(tokens, w, "decoder_norm")
    pred = dense(tokens[:, -geo["masked"]:], w, "decoder_head", mm)
    target = _rows(x, hid)
    if config["normalize_target"]:
        b, m, d = target.shape
        spatial = config["tubelet_size"] * config["patch_size"] ** 2
        ch = target.reshape(b, m, spatial, d // spatial)
        ch = (ch - ch.mean(dim=-2, keepdim=True)) / (
            ch.var(dim=-2, keepdim=True, correction=1).sqrt() + 1e-6)
        target = ch.reshape(b, m, d)
    return ((pred - target) ** 2).sum()


def loss_and_grad(config: dict, traffic: dict, w: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], mm: Callable) -> float:
    rows = traffic["reference"]["block"]
    video, mask = batch["video"], batch["mask"]
    n = video.shape[0]
    count = n * geometry(config)["masked"] * geometry(config)["patch_dim"]
    total = 0.0
    for a in range(0, n, rows):
        part = squared_error(config, w, video[a:a + rows], mask[a:a + rows],
                             mm) / count
        part.backward()
        total += float(part.detach())
    if not math.isfinite(total):
        raise FloatingPointError("the reference's loss is not finite")
    return total
