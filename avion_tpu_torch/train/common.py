"""Pretrained-weight loading for the entries (``avion_tpu.train.common``):
a CLIP's weights from a ``.pt`` or a checkpoint directory, and the visual
tower alone for the classifier heads."""

from __future__ import annotations

import os

import torch

from avion_tpu_torch.core.checkpoint import Checkpointer
from avion_tpu_torch.models.pt_import import import_clip_pt


def load_pretrained_params(path: str, model: torch.nn.Module, *,
                           num_frames: int = 16, context_length: int = 77,
                           vocab_size: int = 49408,
                           strict: bool = False) -> torch.nn.Module:
    """Load weights into ``model`` in place and return it.

    - a ``.pt`` / ``.pth`` file in a reference layout goes through
      :func:`import_clip_pt` (key remap, temporal-embedding inflation,
      context and vocab padding) and ``load_state_dict(strict=strict)``;
    - a directory of the port's own checkpoints (``<dir>/<step>/state.pt``,
      ``core.checkpoint``; a run's ``output_dir``, whose ``ckpt`` holds
      them, also does) gives the model part of its newest step;
    - an orbax directory of the JAX package raises: turn it into a ``.pt``
      on the JAX side first (``avion_tpu/tools/convert_checkpoint.py``,
      ``export_clip_to_pt``)."""
    if path.endswith((".pt", ".pth")):
        imported = import_clip_pt(path, num_frames=num_frames,
                                  context_length=context_length,
                                  vocab_size=vocab_size)
        model.load_state_dict(imported, strict=strict)
        return model
    model.load_state_dict(latest_model_state(path), strict=strict)
    return model


def latest_model_state(path: str) -> dict:
    """The model part of the newest checkpoint of this port under ``path``
    (``<path>/<step>/state.pt``, or a run's ``output_dir`` whose ``ckpt``
    holds them)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint file or directory {path!r}")
    if os.path.isdir(os.path.join(path, "ckpt")):
        path = os.path.join(path, "ckpt")
    step = Checkpointer(path).latest_step()
    if step is None:
        raise ValueError(
            f"{path} holds no checkpoint of this port (<step>/state.pt); an "
            f"orbax checkpoint of the JAX package must first be exported to "
            f".pt by avion_tpu/tools/convert_checkpoint.py "
            f"(export_clip_to_pt)")
    return torch.load(os.path.join(path, str(step), "state.pt"),
                      map_location="cpu", weights_only=True)["model"]


def extract_visual_params(state: dict) -> dict:
    """The visual tower of a CLIP (or classifier) state dict, keyed below
    ``visual.``, without the CLIP's ``image_projection``: the classifier
    heads' tower (the JAX function drops ``proj`` from the flax tree)."""
    return {k[len("visual."):]: v for k, v in state.items()
            if k.startswith("visual.")}
