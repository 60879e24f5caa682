"""Load reference-layout ``.pt`` CLIP checkpoints into the port's modules
(``avion_tpu.models.pt_import``), and carry JAX parameter trees across.

The port's state-dict keys ARE the reference layout that
``avion_tpu.tools.convert_checkpoint.export_clip_to_pt`` writes
(``visual.conv1.weight`` as ``[width, C, p, p]``, ``attn.Wqkv``,
``attn.out_proj``, ``mlp.fc1`` / ``mlp.fc2``, top-level
``image_projection`` / ``text_projection`` / ``logit_scale``), so
:func:`import_clip_pt` only has to normalize the other layouts onto it:

- AVION checkpoints ``{state_dict: {'module.'...}}`` with flash-attn
  ``attn.Wqkv`` or unfused ``attn.in_proj_*`` keys;
- OpenAI CLIP: the text tower at the top level (``transformer.*``,
  ``token_embedding``, ``positional_embedding``, ``ln_final``) and
  ``mlp.c_fc`` / ``mlp.c_proj`` names;
- a flattened ``[width, C*p*p]`` conv1 (C, p, p order);
- temporal positional-embedding inflation to another clip length, and
  context-length / vocab padding or truncation.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def load_pt_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Unwrap ``state_dict`` / ``model`` / ``module`` and strip the DDP
    ``module.`` prefix; every tensor comes back as f32 on the CPU."""
    # the reference checkpoints pickle their training args beside the
    # weights; load only files you trust
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model", "module"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    state = {}
    for k, v in obj.items():
        k = k[len("module."):] if k.startswith("module.") else k
        state[k] = torch.as_tensor(v).float()
    return state


def _inflate_temporal(emb: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Linear interpolation of the temporal embedding across a change of
    clip length."""
    t_old = emb.shape[0]
    if t_old == num_frames:
        return emb
    xs = torch.linspace(0, t_old - 1, num_frames, dtype=torch.float64)
    lo = xs.floor().long()
    hi = (lo + 1).clamp(max=t_old - 1)
    frac = (xs - lo).to(emb.dtype)[:, None]
    return emb[lo] * (1 - frac) + emb[hi] * frac


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] >= n:
        return x[:n]
    return torch.cat([x, x.new_zeros(n - x.shape[0], x.shape[1])])


def _conv1(w: torch.Tensor) -> torch.Tensor:
    if w.dim() == 2:  # [width, C*p*p] in (C, p, p) order
        width, cpp = w.shape
        p = int(round((cpp // 3) ** 0.5))
        w = w.reshape(width, 3, p, p)
    return w


_BLOCK_RENAMES = (
    ("attn.in_proj_weight", "attn.Wqkv.weight"),
    ("attn.in_proj_bias", "attn.Wqkv.bias"),
    ("attn.qkv.", "attn.Wqkv."),
    ("attn.proj.", "attn.out_proj."),
    ("mlp.c_fc.", "mlp.fc1."),
    ("mlp.c_proj.", "mlp.fc2."),
)
_BLOCK_RE = re.compile(r"^(visual\.|textual\.|)transformer\.resblocks\.\d+\.")


def import_clip_pt(path_or_state, num_frames: int = 16,
                   context_length: int = 77,
                   vocab_size: int = 49408) -> Dict[str, torch.Tensor]:
    """A ``.pt`` file (or its state dict) -> the port's CLIP state dict."""
    state = (load_pt_state_dict(path_or_state)
             if isinstance(path_or_state, str) else dict(path_or_state))
    openai_text = "transformer.resblocks.0.ln_1.weight" in state
    tp = "" if openai_text else "textual."
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        m = _BLOCK_RE.match(k)
        if not m:
            continue
        if m.group(1) == "visual.":
            name = k
        elif m.group(1) == tp or (openai_text and m.group(1) == ""):
            name = "textual." + k[len(m.group(1)):]
        else:
            continue
        for old, new in _BLOCK_RENAMES:
            name = name.replace(old, new)
        out[name] = v
    out["visual.class_embedding"] = state["visual.class_embedding"]
    out["visual.positional_embedding"] = state["visual.positional_embedding"]
    if "visual.temporal_embedding" in state:
        out["visual.temporal_embedding"] = _inflate_temporal(
            state["visual.temporal_embedding"], num_frames)
    out["visual.conv1.weight"] = _conv1(state["visual.conv1.weight"])
    for ln in ("ln_pre", "ln_post"):
        for which in ("weight", "bias"):
            out[f"visual.{ln}.{which}"] = state[f"visual.{ln}.{which}"]
    for k in ("visual.proj", "visual.image_projection", "image_projection"):
        if k in state:
            out["image_projection"] = state[k]
            break
    out["textual.token_embedding.weight"] = _pad_rows(
        state[f"{tp}token_embedding.weight"], vocab_size)
    out["textual.positional_embedding"] = _pad_rows(
        state[f"{tp}positional_embedding"], context_length)
    for which in ("weight", "bias"):
        out[f"textual.ln_final.{which}"] = state[f"{tp}ln_final.{which}"]
    for k in ("text_projection", "textual.text_projection"):
        if k in state:
            out["text_projection"] = state[k]
            break
    out["logit_scale"] = state["logit_scale"].reshape(())
    return out


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def params_from_jax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax CLIP parameter tree (nested dicts of arrays) -> the port's
    state dict, with the names and layouts ``export_clip_to_pt`` writes:
    dense kernels [in, out] become weights [out, in], the patchify kernel
    [(p p C), width] becomes conv1 [width, C, p, p]."""
    sd: Dict[str, torch.Tensor] = {}

    def raw(x):
        return torch.from_numpy(np.array(np.asarray(x), np.float32))

    for key, val in _flatten(flax_params).items():
        parts = key.split("/")
        if parts[0] not in ("visual", "textual"):
            if key == "logit_scale":
                sd["logit_scale"] = raw(val).reshape(())
            continue
        base, rest = parts[0], parts[1:]
        if rest[0] == "conv1":
            w = raw(val).T  # [width, (p p C)]
            p = int(round((w.shape[1] // 3) ** 0.5))
            sd["visual.conv1.weight"] = (
                w.reshape(w.shape[0], p, p, 3).permute(0, 3, 1, 2)
                .contiguous())
        elif rest[0] in ("class_embedding", "positional_embedding",
                         "temporal_embedding"):
            sd[f"{base}.{rest[0]}"] = raw(val)
        elif rest[0] == "proj":
            sd["image_projection"] = raw(val)
        elif rest[0] == "text_projection":
            sd["text_projection"] = raw(val)
        elif rest[0] == "token_embedding":
            sd["textual.token_embedding.weight"] = raw(val)
        elif rest[0] in ("ln_pre", "ln_post", "ln_final"):
            which = "weight" if rest[-1] == "scale" else "bias"
            sd[f"{base}.{rest[0]}.{which}"] = raw(val)
        elif rest[0] == "transformer":
            pre = f"{base}.transformer.{rest[1].replace('_', '.')}"
            tail = rest[2:]
            if tail[0] in ("ln_1", "ln_2"):
                which = "weight" if tail[-1] == "scale" else "bias"
                sd[f"{pre}.{tail[0]}.{which}"] = raw(val)
                continue
            layer = {"qkv": "attn.Wqkv", "out_proj": "attn.out_proj",
                     "fc1": "mlp.fc1", "fc2": "mlp.fc2"}[tail[1]]
            if tail[2] == "kernel":
                sd[f"{pre}.{layer}.weight"] = raw(val).T.contiguous()
            else:
                sd[f"{pre}.{layer}.bias"] = raw(val)
        else:
            raise KeyError(f"unknown CLIP parameter {key!r}")
    return sd


def load_clip_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a ``.pt`` checkpoint into a port ``CLIP`` with
    ``strict=True``, inflating and padding to the model's geometry."""
    sd = import_clip_pt(path, num_frames=model.num_frames,
                        context_length=model.context_length,
                        vocab_size=model.vocab_size)
    model.load_state_dict(sd, strict=True)
