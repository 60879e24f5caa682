"""Plain f32 CLIP over video (OpenAI CLIP, arXiv:2103.00020, with AVION's
space-time tokens, arXiv:2309.16669), its two losses, and the FLOPs of its
train step.

- Video tower: a uint8 clip [B, T, H, W, 3] is scaled to [0, 1] and
  normalized with the configuration's mean and std; each frame is cut
  into p x p patches, each flattened in (C, p_h, p_w) order and multiplied
  by the patch embedding ``visual.conv1.weight`` [width, C, p, p] (a
  stride-p convolution); every patch gets its spatial position
  (``positional_embedding[1:]``) and its frame's ``temporal_embedding``;
  the CLS token is ``class_embedding + positional_embedding[0]``, then
  ``ln_pre``, the blocks, ``ln_post`` of the CLS token, and the
  projection ``image_projection`` [width, embed].
- Text tower: token embedding plus learned positions, causal blocks,
  ``ln_final``, the row of the end-of-text token (the largest id), the
  projection ``text_projection``.
- Both embeddings are L2-normalized (norm floored at 1e-8).
- InfoNCE: ``exp(logit_scale) * img @ txt.T``, the mean of the two
  cross-entropies.  Max-margin (EK100 MIR): ``relu(margin - s_ii + s_ij)``
  over rows and columns of ``txt @ img.T``, the diagonal left out, divided
  by ``2 n (n - 1)``.

Both losses couple the rows of a batch, so :func:`loss_and_grad` takes the
gradient in two passes: the embeddings of every row without gradients,
the loss and its gradient with respect to them, then each block of rows
again with gradients, its embeddings' backward fed that gradient.  The
sum over the blocks is the whole batch's gradient.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from portbench.flops import StepWork
from portbench.reference.layers import (ACTIVATIONS, block_spec, layer_norm,
                                        stack)


def weight_spec(config: dict, traffic: dict) -> list:
    """(name, shape, kind, scale) of every weight, in the reference's torch
    layout; ``traffic["video"]["frames"]`` sizes the temporal table."""
    vw, tw = config["vision_width"], config["text_width"]
    e, p = config["embed_dim"], config["patch_size"]
    n = (config["image_size"] // p) ** 2
    frames = traffic["video"]["frames"]
    spec = [
        ("image_projection", (vw, e), "normal", vw ** -0.5),
        ("text_projection", (tw, e), "normal", tw ** -0.5),
        ("logit_scale", (), "const", float(torch.tensor(
            1.0 / config["temperature_init"]).log())),
        ("visual.class_embedding", (vw,), "normal", vw ** -0.5),
        ("visual.positional_embedding", (n + 1, vw), "normal", vw ** -0.5),
        ("visual.temporal_embedding", (frames, vw), "normal", 0.02),
        ("visual.conv1.weight", (vw, 3, p, p), "normal", (3 * p * p) ** -0.5),
        ("visual.ln_pre.weight", (vw,), "one_plus", 0.1),
        ("visual.ln_pre.bias", (vw,), "normal", 0.02),
    ]
    for i in range(config["vision_layers"]):
        spec += block_spec(f"visual.transformer.resblocks.{i}", vw,
                           config["mlp_ratio"])
    spec += [("visual.ln_post.weight", (vw,), "one_plus", 0.1),
             ("visual.ln_post.bias", (vw,), "normal", 0.02),
             ("textual.positional_embedding", (config["context_length"], tw),
              "normal", 0.01),
             ("textual.token_embedding.weight",
              (config["vocab_size"], tw), "normal", 0.02)]
    for i in range(config["text_layers"]):
        spec += block_spec(f"textual.transformer.resblocks.{i}", tw,
                           config["mlp_ratio"])
    spec += [("textual.ln_final.weight", (tw,), "one_plus", 0.1),
             ("textual.ln_final.bias", (tw,), "normal", 0.02)]
    return spec


def step_work(config: dict, traffic: dict) -> StepWork:
    """Model FLOPs of one train step over ``traffic``'s batch and clip
    length, and its attention layers."""
    b = traffic["batch"]
    t = traffic["video"]["frames"]
    vw, tw = config["vision_width"], config["text_width"]
    e, p = config["embed_dim"], config["patch_size"]
    patches = t * (config["image_size"] // p) ** 2
    work = StepWork()
    work.add_dense(b * patches, 3 * p * p, vw)
    work.add_tower(b, patches + 1, vw, config["vision_layers"],
                   config["vision_heads"], False, config["mlp_ratio"])
    work.add_dense(b, vw, e)
    work.add_tower(b, config["context_length"], tw, config["text_layers"],
                   config["text_heads"], True, config["mlp_ratio"])
    work.add_dense(b, tw, e)
    return work


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return F.normalize(x, dim=-1, eps=1e-8)


def encode_video(config: dict, w: Dict[str, torch.Tensor],
                 video: torch.Tensor, mm: Callable) -> torch.Tensor:
    mean = torch.tensor(config["input_mean"], device=video.device)
    std = torch.tensor(config["input_std"], device=video.device)
    x = (video.float() / 255.0 - mean) / std
    b, t, h, wd, c = x.shape
    p, width = config["patch_size"], config["vision_width"]
    gh, gw = h // p, wd // p
    x = x.reshape(b, t, gh, p, gw, p, c).permute(0, 1, 2, 4, 6, 3, 5)
    x = mm(x.reshape(b, t, gh * gw, c * p * p),
           w["visual.conv1.weight"].reshape(width, -1).t())
    pos = w["visual.positional_embedding"]
    x = x + pos[1:] + w["visual.temporal_embedding"][:t, None]
    x = x.reshape(b, t * gh * gw, width)
    cls = (w["visual.class_embedding"] + pos[0]).expand(b, 1, width)
    x = layer_norm(torch.cat([cls, x], dim=1), w, "visual.ln_pre")
    x = stack(x, w, "visual.transformer.resblocks", config["vision_layers"],
              config["vision_heads"], False, ACTIVATIONS[config["activation"]],
              mm)
    pooled = layer_norm(x[:, 0], w, "visual.ln_post")
    return _normalize(mm(pooled, w["image_projection"]))


def encode_text(config: dict, w: Dict[str, torch.Tensor], text: torch.Tensor,
                mm: Callable) -> torch.Tensor:
    text = text.long()
    x = w["textual.token_embedding.weight"][text]
    x = x + w["textual.positional_embedding"][: text.shape[1]]
    x = stack(x, w, "textual.transformer.resblocks", config["text_layers"],
              config["text_heads"], True, ACTIVATIONS[config["activation"]],
              mm)
    x = layer_norm(x, w, "textual.ln_final")
    pooled = x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]
    return _normalize(mm(pooled, w["text_projection"]))


def infonce(img: torch.Tensor, txt: torch.Tensor,
            logit_scale: torch.Tensor) -> torch.Tensor:
    logits = logit_scale.exp() * img @ txt.t()
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.t(), labels)) / 2


def max_margin(img: torch.Tensor, txt: torch.Tensor,
               margin: float = 0.2) -> torch.Tensor:
    x = _normalize(txt) @ _normalize(img).t()
    n = x.shape[0]
    diag = x.diagonal()[:, None]
    off = 1.0 - torch.eye(n, device=x.device)
    rows = (torch.relu(margin - diag + x) * off).sum()
    cols = (torch.relu(margin - diag + x.t()) * off).sum()
    return (rows + cols) / (2.0 * n * (n - 1))


def loss_and_grad(config: dict, traffic: dict, w: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], mm: Callable) -> float:
    """The loss of ``batch`` under ``traffic["loss"]`` (``infonce`` or
    ``max_margin``); its gradient is added to the ``.grad`` of ``w``'s
    leaves.  Rows go ``traffic["reference"]["block"]`` at a time."""
    rows = traffic["reference"]["block"]
    video, text = batch["video"], batch["text"]
    n = video.shape[0]
    spans = [(i, min(n, i + rows)) for i in range(0, n, rows)]
    with torch.no_grad():
        img = torch.cat([encode_video(config, w, video[a:b], mm)
                         for a, b in spans])
        txt = torch.cat([encode_text(config, w, text[a:b], mm)
                         for a, b in spans])
    img.requires_grad_(True)
    txt.requires_grad_(True)
    if traffic["loss"] == "infonce":
        loss = infonce(img, txt, w["logit_scale"])
    elif traffic["loss"] == "max_margin":
        loss = max_margin(img, txt, traffic.get("margin", 0.2))
    else:
        raise ValueError(f"unknown loss {traffic['loss']!r}")
    loss.backward()
    for a, b in spans:
        outs = [encode_video(config, w, video[a:b], mm),
                encode_text(config, w, text[a:b], mm)]
        torch.autograd.backward(outs, [img.grad[a:b], txt.grad[a:b]])
    return float(loss.detach())
