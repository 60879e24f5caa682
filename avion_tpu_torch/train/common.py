"""What the entries share (``avion_tpu.train.common``): a CLIP's weights
from a ``.pt`` or a checkpoint directory, the visual tower alone for the
classifier heads, the run over the mesh of process groups, and an
unsharded copy of a sharded model for evaluation."""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch

from avion_tpu_torch.core.checkpoint import Checkpointer
from avion_tpu_torch.models.pt_import import import_clip_pt
from avion_tpu_torch.parallel.launch import host, is_main
from avion_tpu_torch.parallel.mesh import mesh_from_config, use_mesh
from avion_tpu_torch.parallel.sharding import full_tensor, is_dtensor
from avion_tpu_torch.parallel.tensor_parallel import tensor_layout


def over_mesh(cfg, device: torch.device, train: Callable):
    """``train(cfg, device, mesh)`` on this rank: the launcher's process
    group joined (``parallel.launch.host``, left again when it returns if
    it was joined here), ``cfg.mesh`` made current, ``output_dir`` and its
    ``config.json`` written by rank 0."""
    with host(cfg.seed, device) as device:
        if is_main():
            os.makedirs(cfg.output_dir, exist_ok=True)
            cfg.save(os.path.join(cfg.output_dir, "config.json"))
        mesh = mesh_from_config(cfg.mesh)
        with use_mesh(mesh):
            return train(cfg, device, mesh)


def whole_model(model: torch.nn.Module, build: Callable[[], torch.nn.Module],
                params: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.nn.Module:
    """``model`` itself, or, when it is sharded (FSDP2, or cut over
    ``mesh.tensor``, ``ep`` or ``pp``), routes its MoE layers over the ranks,
    or ``params`` (e.g. an EMA, by name) stand in for its
    parameters, a new unsharded module of ``build()`` (on the meta device)
    holding the whole weights,
    on ``model``'s device.  Every rank calls it: the gathers are
    collectives."""
    state = model.state_dict()
    layout = tensor_layout(model)
    if params is None and layout is None and not any(
            is_dtensor(v) for v in state.values()) and not _routes_over_ranks(
                model):
        return model

    def gather(name, value):
        value = full_tensor(value.detach())
        return value if layout is None else layout.gather(name, value)

    whole = {k: gather(k, v) for k, v in state.items()}
    for k, v in (params or {}).items():
        whole[k] = gather(k, v)
    copy = build().to_empty(device=next(iter(whole.values())).device)
    copy.load_state_dict(whole)
    with torch.no_grad():  # the tables the state dict leaves out
        for name, buf in model.named_buffers():
            copy.get_buffer(name).copy_(buf)
    return copy


def _routes_over_ranks(model: torch.nn.Module) -> bool:
    """Whether a MoE layer of ``model`` routes the batch group's global
    batch (its copy routes each rank's rows alone, so its ranks need not
    call it in step)."""
    from avion_tpu_torch.ops.moe import moe_outputs

    return any(m.batch_group is not None for m in moe_outputs(model))


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
