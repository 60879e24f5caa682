"""Load reference-layout ``.pt`` CLIP checkpoints into the port's modules
(``avion_tpu.models.pt_import``), and carry JAX parameter trees across.

The port's state-dict keys ARE the reference layout that
``avion_tpu.tools.convert_checkpoint.export_clip_to_pt`` writes
(``visual.conv1.weight`` as ``[width, C, p, p]``, ``attn.Wqkv``,
``attn.out_proj``, ``mlp.fc1`` / ``mlp.fc2``, LayerScale's
``ls_1.gamma`` / ``ls_2.gamma``, top-level ``image_projection`` /
``text_projection`` / ``logit_scale`` and SigLIP's ``logit_bias``), so
:func:`import_clip_pt` only has to normalize the other layouts onto it:

- AVION checkpoints ``{state_dict: {'module.'...}}`` with flash-attn
  ``attn.Wqkv`` or unfused ``attn.in_proj_*`` keys;
- OpenAI CLIP: the text tower at the top level (``transformer.*``,
  ``token_embedding``, ``positional_embedding``, ``ln_final``) and
  ``mlp.c_fc`` / ``mlp.c_proj`` names;
- a flattened ``[width, C*p*p]`` conv1 (C, p, p order);
- temporal positional-embedding inflation to another clip length, and
  context-length / vocab padding or truncation.

:func:`import_clip_pt` raises where a file holds no visual block (the
JAX finetune merges with ``strict=False`` and would start the classifier
from random weights).  :func:`import_videomae_pt` reads the VideoMAE
finetune layout (``blocks.N.*``) into the port's ``FinetuneVideoMAE``
names, and :func:`params_from_jax` also carries the flax VideoMAE,
``VideoClassifier``, ``VCLM``, ``LavilaNarrator``, ``VSLNet`` and
``FrozenInTime`` trees across (the released LaViLa file itself goes
through ``models.lavila_import``, a released EgoVLP file through
``egonlq.egovlp``).
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
    """A ``.pt`` file (or its state dict) -> the port's CLIP state dict,
    every block the file holds, at its widths and patch size (the model's
    registry entry sets the heads), with ``logit_bias`` where the file has
    one.  Raises, naming what the file holds, when it has no visual block
    (``visual.transformer.resblocks.N.*``)."""
    state = (load_pt_state_dict(path_or_state)
             if isinstance(path_or_state, str) else dict(path_or_state))
    if not any(k.startswith("visual.transformer.resblocks.") for k in state):
        where = path_or_state if isinstance(path_or_state, str) else \
            "the state dict"
        raise ValueError(f"no CLIP visual block (visual.transformer."
                         f"resblocks.N.*) in {where}: it holds "
                         f"{_layout(state)}")
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
    if "logit_bias" in state:
        out["logit_bias"] = state["logit_bias"].reshape(())
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


_VIDEOMAE_TOP = ("patch_embed", "encoder", "encoder_norm",
                 "encoder_to_decoder", "mask_token", "decoder", "decoder_norm",
                 "decoder_head", "fc_norm", "head", "fc_cls")
_BLOCK_LAYERS = {"qkv": "attn.Wqkv", "out_proj": "attn.out_proj",
                 "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def _raw(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), np.float32))


def _block_param(pre: str, tail, val, sd: Dict[str, torch.Tensor]) -> None:
    """One flax block leaf (``tail`` below ``resblocks_i``) into ``sd``."""
    if tail[0] in ("ls_1", "ls_2"):
        sd[f"{pre}.{tail[0]}.gamma"] = _raw(val)
        return
    if tail[0] in ("ln_1", "ln_2"):
        which = "weight" if tail[-1] == "scale" else "bias"
        sd[f"{pre}.{tail[0]}.{which}"] = _raw(val)
        return
    layer = _BLOCK_LAYERS[tail[1]]
    if tail[2] == "kernel":
        sd[f"{pre}.{layer}.weight"] = _raw(val).T.contiguous()
    else:
        sd[f"{pre}.{layer}.bias"] = _raw(val)


def _videomae_param(parts, val, sd: Dict[str, torch.Tensor]) -> None:
    """A leaf of a flax ``PretrainVideoMAE`` / ``FinetuneVideoMAE`` tree."""
    top = parts[0]
    if top == "mask_token":
        sd["mask_token"] = _raw(val)
    elif top in ("encoder", "decoder"):
        _block_param(f"{top}.{parts[1].replace('_', '.')}", parts[2:], val,
                     sd)
    elif top in ("encoder_norm", "decoder_norm", "fc_norm"):
        which = "weight" if parts[-1] == "scale" else "bias"
        sd[f"{top}.{which}"] = _raw(val)
    elif parts[-1] == "kernel":  # patch_embed, encoder_to_decoder, heads
        sd[f"{top}.weight"] = _raw(val).T.contiguous()
    else:
        sd[f"{top}.bias"] = _raw(val)


def params_from_jax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax CLIP, VideoMAE, ``VideoClassifier``, ``VCLM``,
    ``LavilaNarrator``, ``VSLNet`` or ``FrozenInTime`` parameter tree
    (nested dicts of arrays) -> the
    port's state dict, with the names and layouts ``export_clip_to_pt``
    writes: dense kernels [in, out] become weights [out, in], the patchify
    kernel [(p p C), width] becomes conv1 [width, C, p, p] (VideoMAE's tube
    embed stays a dense weight); the classifier's ``vision`` tower becomes
    ``visual``.  The narrators go through :func:`_vclm_from_jax` and
    :func:`_lavila_from_jax`.  Every leaf is carried (``logit_scale``,
    ``logit_bias``, LayerScale's ``gamma``); one it does not know raises
    ``KeyError``."""
    if "text_decoder" in flax_params:
        return _lavila_from_jax(flax_params)
    if "visual_proj" in flax_params:
        return _vclm_from_jax(flax_params)
    if "video_affine" in flax_params:
        return _vslnet_from_jax(flax_params)
    if "video_model" in flax_params:
        return _egovlp_from_jax(flax_params)
    sd: Dict[str, torch.Tensor] = {}
    for key, val in _flatten(flax_params).items():
        parts = key.split("/")
        if parts[0] in _VIDEOMAE_TOP:
            _videomae_param(parts, val, sd)
            continue
        if key in ("logit_scale", "logit_bias"):
            sd[key] = _raw(val).reshape(())
            continue
        if parts[0] not in ("visual", "textual", "vision"):
            raise KeyError(f"unknown parameter {key!r}")
        base = "visual" if parts[0] == "vision" else parts[0]
        rest = parts[1:]
        if rest[0] == "conv1":
            w = _raw(val).T  # [width, (p p C)]
            p = int(round((w.shape[1] // 3) ** 0.5))
            sd["visual.conv1.weight"] = (
                w.reshape(w.shape[0], p, p, 3).permute(0, 3, 1, 2)
                .contiguous())
        elif rest[0] in ("class_embedding", "positional_embedding",
                         "temporal_embedding"):
            sd[f"{base}.{rest[0]}"] = _raw(val)
        elif rest[0] == "proj":
            sd["image_projection"] = _raw(val)
        elif rest[0] == "text_projection":
            sd["text_projection"] = _raw(val)
        elif rest[0] == "token_embedding":
            sd["textual.token_embedding.weight"] = _raw(val)
        elif rest[0] in ("ln_pre", "ln_post", "ln_final"):
            which = "weight" if rest[-1] == "scale" else "bias"
            sd[f"{base}.{rest[0]}.{which}"] = _raw(val)
        elif rest[0] == "transformer":
            _block_param(f"{base}.transformer.{rest[1].replace('_', '.')}",
                         rest[2:], val, sd)
        else:
            raise KeyError(f"unknown CLIP parameter {key!r}")
    return sd


def _leaf_name(parts, val, transpose: bool = True):
    """(the port's name, value) of a generic flax leaf below ``parts[:-1]``:
    a dense ``kernel`` becomes ``weight`` (transposed unless
    ``transpose`` is false: HF's Conv1D keeps [in, out]), a LayerNorm's
    ``scale`` ``weight``, an ``embedding`` table ``weight``."""
    *mods, leaf = parts
    raw = _raw(val)
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), (raw.T.contiguous() if transpose
                                             else raw)
    if leaf in ("scale", "embedding"):
        return ".".join(mods + ["weight"]), raw
    return ".".join(parts), raw


_VCLM_RENAMES = {"qkv": "Wqkv"}


def _vclm_from_jax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``VCLM`` tree: the visual tower as a CLIP's, ``block_{i}`` as
    ``blocks.{i}``, the layers' ``LayerNorm`` wrapper (``ln_1/norm``) as
    ``ln_1``, ``attn/qkv`` as ``attn.Wqkv``."""
    sd = params_from_jax({"visual": flax_params["visual"]})
    for key, val in _flatten(flax_params).items():
        parts = key.split("/")
        if parts[0] == "visual":
            continue
        names = []
        for p in parts:
            m = re.fullmatch(r"block_(\d+)", p)
            names += ["blocks", m.group(1)] if m else [_VCLM_RENAMES.get(p, p)]
        if len(names) > 2 and names[-2] == "norm":
            del names[-2]
        name, value = _leaf_name(names, val)
        sd[name] = value.reshape(()) if name.endswith("_gate") else value
    return sd


def _lavila_from_jax(flax_params: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """A flax ``LavilaNarrator`` tree in the released layout's names and
    shapes (``models.lavila``): the patchify kernel as the Conv2d weight
    [D, C, p, p] (channel-first), the tables with their leading 1, the
    decoder under ``text_decoder.transformer`` with its Conv1D kernels
    [in, out] as they are, ``blocks_{i}`` / ``h_{i}`` as ``blocks.{i}`` /
    ``h.{i}``, ``mlp_fc1`` as ``mlp.fc1``."""
    sd: Dict[str, torch.Tensor] = {}
    for key, val in _flatten(flax_params).items():
        parts = key.split("/")
        raw = _raw(val)
        if parts[:2] == ["visual", "patch_embed"]:
            if parts[2] == "kernel":  # [(C p p), D]
                w = raw.T
                p = int(round((w.shape[1] // 3) ** 0.5))
                raw = w.reshape(w.shape[0], 3, p, p).contiguous()
            sd[f"visual.patch_embed.proj.{parts[2].replace('kernel', 'weight')}"] = raw
            continue
        if parts[0] == "visual" and parts[1] in ("cls_token", "pos_embed",
                                                 "temporal_embed"):
            sd[f"visual.{parts[1]}"] = raw.reshape(1, -1, raw.shape[-1])
            continue
        names = []
        for p in parts:
            m = re.fullmatch(r"(blocks|h)_(\d+)", p)
            if m:
                names += [m.group(1), m.group(2)]
            elif p.startswith("mlp_fc"):
                names += ["mlp", p[len("mlp_"):]]
            else:
                names.append(p)
        if names[0] == "text_decoder":
            names.insert(1, "transformer")
            if names[2] in ("wte", "wpe"):
                sd[".".join(names) + ".weight"] = raw
                continue
        name, value = _leaf_name(names, val,
                                 transpose=names[0] != "text_decoder")
        sd[name] = value.reshape(()) if "alpha_" in name else value
    return sd


_VSLNET_TOP = ("video_affine", "query_affine", "feature_encoder",
               "cq_attention", "cq_concat", "highlight", "predictor_encoder",
               "start_ln", "end_ln", "start_fc1", "start_fc2", "end_fc1",
               "end_fc2")
_VSLNET_LEAVES = ("kernel", "bias", "scale", "embedding", "w4C", "w4Q",
                  "w4mlu", "pool_weight")


def _vslnet_from_jax(flax_params: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """A flax ``VSLNet`` tree (``egonlq.vslnet``): the conv block's
    ``ln_i`` / ``dw_i`` / ``pw_i`` as ``ln.i`` / ``dw.i`` / ``pw.i``, the
    depthwise kernel [k, 1, C] as the ``Conv1d`` weight [C, 1, k], the
    pointwise kernel [1, C, C] as a ``Linear`` weight, the positional
    tables and the trilinear / pooling weights as they are."""
    sd: Dict[str, torch.Tensor] = {}
    for key, val in _flatten(flax_params).items():
        parts = key.split("/")
        if parts[0] not in _VSLNET_TOP or parts[-1] not in _VSLNET_LEAVES:
            raise KeyError(f"unknown VSLNet parameter {key!r}")
        names = []
        for prev, p in zip([""] + parts, parts):
            m = re.fullmatch(r"(ln|dw|pw)_(\d+)", p)
            names += ([m.group(1), m.group(2)] if m and prev == "conv_block"
                      else [p])
        raw = _raw(val)
        if parts[-1] == "kernel" and raw.dim() == 3:
            w = raw.permute(2, 1, 0) if names[-3] == "dw" else raw[0].T
            sd[".".join(names[:-1] + ["weight"])] = w.contiguous()
            continue
        name, value = _leaf_name(names, val)
        sd[name] = value
    return sd


_ROBERTA_NAMES = {
    "word_embeddings": "embeddings.word_embeddings",
    "position_embeddings": "embeddings.position_embeddings",
    "token_type_embeddings": "embeddings.token_type_embeddings",
    "emb_ln": "embeddings.LayerNorm", "query": "attention.self.query",
    "key": "attention.self.key", "value": "attention.self.value",
    "attn_out": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm",
    "intermediate": "intermediate.dense", "output": "output.dense",
    "out_ln": "output.LayerNorm"}
_PROJ_INDEX = {"fc0": "0", "fc1": "2", "fc2": "4"}


def _egovlp_from_jax(flax_params: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """A flax ``FrozenInTime`` tree (``egonlq.egovlp``) in the released
    EgoVLP layout's names: the video tower as LaViLa's
    (:func:`_lavila_from_jax`) under ``video_model``, RoBERTa's
    ``layer_i`` as HuggingFace's ``encoder.layer.i`` names, the
    projections' ``fc0`` / ``fc1`` / ``fc2`` as ``0`` / ``2`` / ``4``."""
    sd = {"video_model." + k[len("visual."):]: v for k, v in
          _lavila_from_jax({"visual": flax_params["video_model"]}).items()}
    for key, val in _flatten(flax_params).items():
        parts = key.split("/")
        if parts[0] == "video_model":
            continue
        if parts[0] == "text_model":
            m = re.fullmatch(r"layer_(\d+)", parts[1])
            mods = parts[2:-1] if m else parts[1:-1]
            if len(mods) != 1 or mods[0] not in _ROBERTA_NAMES:
                raise KeyError(f"unknown FrozenInTime parameter {key!r}")
            base = (["text_model", "encoder", "layer", m.group(1)] if m
                    else ["text_model"])
            names = base + _ROBERTA_NAMES[mods[0]].split(".") + parts[-1:]
        elif (parts[0] in ("vid_proj", "txt_proj") and len(parts) == 3
              and parts[1] in _PROJ_INDEX):
            names = [parts[0], _PROJ_INDEX[parts[1]], parts[2]]
        else:
            raise KeyError(f"unknown FrozenInTime parameter {key!r}")
        name, value = _leaf_name(names, val)
        sd[name] = value
    return sd


def _tube_embed_weight(w: torch.Tensor) -> torch.Tensor:
    """VideoMAE patch embed [width, C, ts, p, p] or flattened in (C, ts, p,
    p) order -> the dense weight [width, (ts p p C)] of ``tube_patchify``'s
    ordering."""
    if w.dim() == 2:
        width, flat = w.shape
        c, ts = 3, 2
        p = int(round((flat // (c * ts)) ** 0.5))
        w = w.reshape(width, c, ts, p, p)
    return w.permute(0, 2, 3, 4, 1).reshape(w.shape[0], -1).contiguous()


_VIDEOMAE_BLOCK_RE = re.compile(r"^blocks\.(\d+)\.")


def _layout(state: Mapping[str, Any]) -> str:
    """A few words on which layout a state dict holds, for the errors of
    the importers."""
    keys = sorted(state)
    if any(k.startswith("encoder.blocks.") for k in keys):
        return ("the VideoMAE pretraining layout (encoder.blocks.N.*, "
                "decoder.blocks.N.*)")
    if any(k.startswith("visual.transformer.resblocks.") for k in keys):
        return "a CLIP layout (visual.transformer.resblocks.N.*)"
    if any(_VIDEOMAE_BLOCK_RE.match(k) for k in keys):
        return "the VideoMAE finetune layout (blocks.N.*)"
    return f"keys such as {keys[:4]}"


def import_videomae_pt(path_or_state) -> Dict[str, torch.Tensor]:
    """A VideoMAE finetune-layout ``.pt`` (or its state dict) -> the port's
    ``FinetuneVideoMAE`` state dict: ``patch_embed.proj``, ``blocks.N``
    (``norm1`` / ``norm2``, a fused ``attn.Wqkv`` or the reference's
    ``attn.qkv.weight`` with split ``q_bias`` / ``v_bias`` and a zero key
    bias, which no softmax sees; ``attn.proj``, ``mlp.fc1`` / ``fc2``),
    ``fc_norm`` (or ``norm``) and ``head``.  The sincos positions are not
    read.  A file that yields no encoder block raises and names the layout
    it holds (the JAX importer returns nothing for it, so the finetune
    would start from random weights)."""
    state = (load_pt_state_dict(path_or_state)
             if isinstance(path_or_state, str) else dict(path_or_state))
    blocks = sorted({int(m.group(1)) for k in state
                     for m in [_VIDEOMAE_BLOCK_RE.match(k)] if m})
    if not blocks:
        where = path_or_state if isinstance(path_or_state, str) else \
            "the state dict"
        raise ValueError(f"no VideoMAE encoder block (blocks.N.*) in "
                         f"{where}: it holds {_layout(state)}")
    out: Dict[str, torch.Tensor] = {}
    if "patch_embed.proj.weight" in state:
        out["patch_embed.weight"] = _tube_embed_weight(
            state["patch_embed.proj.weight"])
        out["patch_embed.bias"] = state["patch_embed.proj.bias"]
    for i in range(blocks[-1] + 1):
        src, dst = f"blocks.{i}.", f"encoder.resblocks.{i}."

        def get(k):
            return state[src + k]

        for ln, norm in (("ln_1", "norm1"), ("ln_2", "norm2")):
            out[f"{dst}{ln}.weight"] = get(f"{norm}.weight")
            out[f"{dst}{ln}.bias"] = get(f"{norm}.bias")
        if src + "attn.Wqkv.weight" in state:
            w, b = get("attn.Wqkv.weight"), get("attn.Wqkv.bias")
        else:
            w = get("attn.qkv.weight")
            dim = w.shape[0] // 3
            if src + "attn.qkv.bias" in state:
                b = get("attn.qkv.bias")
            else:
                zero = torch.zeros(dim)
                b = torch.cat([state.get(src + "attn.q_bias", zero), zero,
                               state.get(src + "attn.v_bias", zero)])
        out[dst + "attn.Wqkv.weight"], out[dst + "attn.Wqkv.bias"] = w, b
        for layer, name in (("attn.out_proj", "attn.proj"),
                            ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
            out[f"{dst}{layer}.weight"] = get(f"{name}.weight")
            out[f"{dst}{layer}.bias"] = get(f"{name}.bias")
    for src in ("fc_norm", "norm"):
        if f"{src}.weight" in state:
            out["fc_norm.weight"] = state[f"{src}.weight"]
            out["fc_norm.bias"] = state[f"{src}.bias"]
            break
    if "head.weight" in state:
        out["head.weight"] = state["head.weight"]
        out["head.bias"] = state["head.bias"]
    return out


def load_clip_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a ``.pt`` checkpoint into a port ``CLIP`` with
    ``strict=True``, inflating and padding to the model's geometry."""
    sd = import_clip_pt(path, num_frames=model.num_frames,
                        context_length=model.context_length,
                        vocab_size=model.vocab_size)
    model.load_state_dict(sd, strict=True)
