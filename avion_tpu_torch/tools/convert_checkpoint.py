"""Two-way checkpoint conversion between the reference's ``.pt``, the JAX
package's flax parameters and this port (``avion_tpu.tools.
convert_checkpoint``).

The port's state-dict keys are the reference layout, so:

- ``import`` reads a reference ``.pt`` in any layout that
  ``models.pt_import.import_clip_pt`` reads and writes the ``.npz`` of
  flax-flattened parameters that the JAX tool writes
  (``visual/transformer/resblocks_0/attn/qkv/kernel`` ...; dense kernels
  ``[in, out]``, conv1 as the flattened ``[(p p C), width]`` patch
  kernel), with exactly the leaves of ``--model``.  The JAX tool fills a
  leaf the file lacks from its model's random init (``strict=False``);
  the port cannot draw flax's init, so a missing leaf raises and names
  it.
- ``export`` reads a port checkpoint directory (``<dir>/<step>/state.pt``
  of ``core.checkpoint``, the newest step; or a run's ``output_dir``) or
  a ``.pt`` and writes ``{"state_dict": sd}`` in the reference layout,
  as the JAX tool's ``export_clip_to_pt``.  It keeps ``logit_bias`` and
  LayerScale's ``ls_1`` / ``ls_2.gamma`` where the source holds them,
  which the JAX export drops.

Usage::

    python -m avion_tpu_torch.tools.convert_checkpoint import \\
        --src ckpt.pt --dst params.npz --model CLIP_VITB16 --frames 4
    python -m avion_tpu_torch.tools.convert_checkpoint export \\
        --src runs/x/ckpt --dst avion_ckpt.pt --model CLIP_VITB16 --frames 4
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Any, Dict

import numpy as np
import torch

_LAYERS = {"attn.Wqkv": "attn/qkv", "attn.out_proj": "attn/out_proj",
           "mlp.fc1": "mlp/fc1", "mlp.fc2": "mlp/fc2"}
_BLOCK = re.compile(r"^(visual|textual)\.transformer\.resblocks\.(\d+)\."
                    r"(.+)$")


def flatten_params(tree: Dict[str, Any], prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def flax_params_from_state(sd: Dict[str, torch.Tensor]
                           ) -> Dict[str, np.ndarray]:
    """A port CLIP state dict -> the flax CLIP's flattened parameters (the
    inverse of ``models.pt_import.params_from_jax`` for a CLIP): weights
    ``[out, in]`` become kernels ``[in, out]``, conv1 ``[width, C, p, p]``
    the patch kernel ``[(p p C), width]``, a LayerNorm's ``weight`` and
    ``bias`` its wrapped ``norm/scale`` and ``norm/bias``.  A key it does not know raises ``KeyError``."""
    out = {}
    for key, val in sd.items():
        m = _BLOCK.match(key)
        if m:
            tower, i, rest = m.groups()
            pre = f"{tower}/transformer/resblocks_{i}"
            mod, leaf = rest.rsplit(".", 1)
            if mod in _LAYERS:
                name = f"{pre}/{_LAYERS[mod]}/" + (
                    "kernel" if leaf == "weight" else "bias")
                out[name] = _np(val.T if leaf == "weight" else val)
            elif mod in ("ln_1", "ln_2"):
                out[f"{pre}/{mod}/norm/" + ("scale" if leaf == "weight"
                                            else "bias")] = _np(val)
            elif mod in ("ls_1", "ls_2") and leaf == "gamma":
                out[f"{pre}/{mod}/gamma"] = _np(val)
            else:
                raise KeyError(f"unknown block parameter {key!r}")
        elif key == "visual.conv1.weight":
            width = val.shape[0]
            out["visual/conv1/kernel"] = _np(
                val.permute(0, 2, 3, 1).reshape(width, -1).T)
        elif key in ("visual.class_embedding", "visual.positional_embedding",
                     "visual.temporal_embedding",
                     "textual.positional_embedding"):
            out[key.replace(".", "/")] = _np(val)
        elif key == "image_projection":
            out["visual/proj"] = _np(val)
        elif key == "text_projection":
            out["textual/text_projection"] = _np(val)
        elif key == "textual.token_embedding.weight":
            out["textual/token_embedding/embedding"] = _np(val)
        elif re.fullmatch(r"(visual|textual)\.(ln_pre|ln_post|ln_final)\."
                          r"(weight|bias)", key):
            tower, ln, leaf = key.split(".")
            out[f"{tower}/{ln}/norm/" + ("scale" if leaf == "weight"
                                         else "bias")] = _np(val)
        elif key in ("logit_scale", "logit_bias"):
            out[key] = _np(val)
        else:
            raise KeyError(f"unknown CLIP parameter {key!r}")
    return out


def _model_keys(name: str, frames: int):
    """(the state-dict shapes of ``name`` at ``frames``, its context
    length, its vocabulary size), built on the meta device."""
    from avion_tpu_torch.models.registry import create_model

    with torch.device("meta"):
        model = create_model(name, num_frames=frames)
    return ({k: tuple(v.shape) for k, v in model.state_dict().items()},
            model.context_length, model.vocab_size)


def _fit(sd: Dict[str, torch.Tensor], shapes: Dict[str, tuple],
         src: str) -> Dict[str, torch.Tensor]:
    """``sd`` with every key of the model at its shape (a missing key or
    another shape raises, naming it), cut to the model's keys."""
    missing = [k for k in shapes if k not in sd]
    if missing:
        raise KeyError(f"{src} lacks {missing[0]!r} ({len(missing)} missing "
                       f"leaves in all): the JAX tool would fill them from "
                       f"its model's random init, which this port cannot "
                       f"draw")
    for k, shape in shapes.items():
        if tuple(sd[k].shape) != shape:
            raise ValueError(f"shape mismatch at {k}: model {shape} vs "
                             f"{src} {tuple(sd[k].shape)}")
    return {k: sd[k] for k in shapes}


def import_to_npz(src: str, dst: str, model: str, frames: int) -> int:
    """A reference ``.pt`` -> the JAX package's ``.npz``; returns the
    number of arrays written."""
    from avion_tpu_torch.models.pt_import import import_clip_pt

    shapes, ctx, vocab = _model_keys(model, frames)
    sd = _fit(import_clip_pt(src, num_frames=frames, context_length=ctx,
                             vocab_size=vocab), shapes, src)
    flat = flax_params_from_state(sd)
    np.savez(dst, **flat)
    return len(flat)


def export_to_pt(src: str, dst: str, model: str, frames: int) -> int:
    """A port checkpoint directory or a ``.pt`` -> a reference-layout
    ``{"state_dict": ...}``; returns the number of tensors written."""
    from avion_tpu_torch.models.pt_import import import_clip_pt
    from avion_tpu_torch.train.common import latest_model_state

    shapes, ctx, vocab = _model_keys(model, frames)
    if src.endswith((".pt", ".pth")):
        sd = import_clip_pt(src, num_frames=frames, context_length=ctx,
                            vocab_size=vocab)
    else:
        sd = latest_model_state(src)
    _fit(sd, shapes, src)
    # every tensor the source holds: logit_bias and the LayerScale gammas
    # too, where the registry's model at its defaults has none
    sd = {k: v.detach().cpu().contiguous() for k, v in sd.items()}
    torch.save({"state_dict": sd}, dst)
    return len(sd)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    p = argparse.ArgumentParser()
    p.add_argument("direction", choices=["import", "export"])
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--model", default="CLIP_VITB16")
    p.add_argument("--frames", type=int, default=4)
    args = p.parse_args(argv)
    if args.direction == "import":
        n = import_to_npz(args.src, args.dst, args.model, args.frames)
        print(f"wrote {n} arrays to {args.dst}")
    else:
        n = export_to_pt(args.src, args.dst, args.model, args.frames)
        print(f"wrote {n} tensors to {args.dst}")


if __name__ == "__main__":
    main()
