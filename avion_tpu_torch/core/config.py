"""Config system (the PyTorch port's own copy of ``avion_tpu.core.config``).

The port imports nothing of the JAX package, so it keeps this copy; the
``section.key=value`` semantics and every default stay the same, which
``tests/test_torch_config.py`` holds against the original.

One coherent dataclass-based config tree replacing the reference's
per-entry-point argparse forests (e.g. ``scripts/main_lavila_pretrain.py:39-246``
with ~70 flags).  Knob names/semantics are preserved so users of the
reference can map their runs 1:1.  Configs serialize to/from plain dicts
(stored inside checkpoints, mirroring the reference's ``ckpt["args"]``
propagation — ``scripts/main_lavila_finetune_cls.py:278-295``), and can be
overridden from the command line with ``section.key=value`` tokens.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def _convert(value: str, typ) -> Any:
    import typing

    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        return _convert(value, args[0])
    if typ is bool or origin is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if origin in (tuple, list):
        inner = typing.get_args(typ)
        parts = [p for p in value.replace("(", "").replace(")", "").split(",") if p]
        if origin is tuple:
            if len(inner) == 2 and inner[1] is Ellipsis:
                return tuple(_convert(p, inner[0]) for p in parts)
            return tuple(_convert(p, t) for p, t in zip(parts, inner))
        return [_convert(p, inner[0] if inner else str) for p in parts]
    return value


@dataclass
class MeshConfig:
    """Device mesh layout.  data = pure data parallel, fsdp = data parallel
    with parameter/optimizer sharding (supersedes the reference's ZeRO-1,
    ``scripts/main_lavila_pretrain.py:322-332``), tensor = megatron-style
    model parallelism (absent in the reference; a beyond-parity axis)."""

    data: int = -1  # -1: use all remaining devices
    fsdp: int = 1
    pp: int = 1  # pipeline parallelism (GPipe over layer stages)
    sp: int = 1  # sequence parallelism (ring attention over tokens)
    ep: int = 1  # expert parallelism (MoE expert sharding)
    tensor: int = 1
    # multi-slice pods: number of TPU slices, laid out as the OUTER
    # blocks of the data axis so only the gradient all-reduce's
    # inter-slice hop crosses DCN; every model-axis collective stays on
    # intra-slice ICI (parallel/mesh.py:make_mesh).  Must divide data.
    dcn_data: int = 1

    def axis_sizes(self, n_devices: int) -> Tuple[int, int, int]:
        d, f, t = self.data, self.fsdp, self.tensor
        rest = f * self.pp * self.sp * self.ep * t
        if d == -1:
            assert n_devices % rest == 0, (n_devices, f, self.pp, self.sp,
                                           self.ep, t)
            d = n_devices // rest
        assert d * rest == n_devices, (
            f"mesh {d}x{f}x{self.pp}x{self.sp}x{self.ep}x{t} "
            f"!= {n_devices} devices")
        return d, f, t


@dataclass
class ModelConfig:
    # name resolved through avion_tpu_torch.models.registry (mirrors
    # `getattr(model_clip, args.model)` — scripts/main_lavila_pretrain.py:265)
    name: str = "CLIP_VITB16"
    # vision
    image_size: int = 224
    patch_size: int = 16
    num_frames: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    embed_dim: int = 512
    # knobs (names follow the reference CLI)
    use_grad_checkpointing: bool = False
    # remat policy: save_attn | full (see models/layers.Transformer)
    remat_policy: str = "save_attn"
    # ring attention over the mesh "sp" axis (long-clip training);
    # requires pooling=gap and mesh.sp > 1
    sequence_parallel: bool = False
    # GPipe pipeline parallelism: route the visual tower's layer stack
    # through parallel/pipeline.PipelinedTransformer over mesh.pp
    pipeline: bool = False
    pipeline_microbatches: int = 8  # GPipe microbatches (>= 4*pp advised)
    moe_experts: int = 0  # V-MoE visual tower; shard experts over mesh.ep
    moe_aux_weight: float = 0.01  # router load-balance loss weight
    moe_zloss_weight: float = 0.0  # optional router z-loss (0 = off)
    # uint8 batches normalize inside the rematerialized stem instead of
    # in prep_video — the batch-256 HBM lever (docs/PERF.md):
    # none | openai | imagenet
    input_norm: str = "none"
    use_fast_conv1: bool = True
    use_flash_attn: bool = True
    use_quick_gelu: bool = True  # reference silently drops this; we honor it
    patch_dropout: float = 0.0
    drop_path_rate: float = 0.0
    pooling: str = "cls"  # cls | gap
    project_embed_dim: int = 512
    freeze_temperature: bool = False
    temperature_init: float = 0.07
    # SigLIP pairwise-logit bias (set automatically when train.loss ==
    # "siglip"; pair with temperature_init=0.1 per arXiv:2303.15343)
    use_logit_bias: bool = False
    # classifier head (finetune_cls)
    num_classes: int = 0
    classifier_dropout: float = 0.0
    # videomae extras
    decoder_width: int = 384
    decoder_layers: int = 4
    decoder_heads: int = 6
    tubelet_size: int = 2
    mask_ratio: float = 0.9


@dataclass
class DataConfig:
    dataset: str = "ego4d"
    root: str = ""
    root_val: str = ""
    train_metadata: str = ""
    # comma-separated auxiliary train pkls concatenated into the train
    # set — how the reference mixes LaViLa pseudo-narrations with the
    # ground-truth captions for its augmented headline runs
    # (``--train-metadata-aux``, main_lavila_pretrain.py:470-495)
    train_metadata_aux: str = ""
    val_metadata: str = ""
    relevancy_path: str = ""
    label_map: str = ""
    # fast-iteration subsets: keep every Nth train sample (the
    # reference's ``--subsample_stride`` quick-prototype slicing,
    # clip_dataset.py:670-676); None = full dataset
    subsample_stride: Optional[int] = None
    # tar-sharded training input (data/shards.py): when set, the
    # pretrain entry reads packed shards (seek+read on a few large
    # files — the object-storage-friendly path) instead of per-chunk
    # mp4 files; pack with `python -m avion_tpu.data.shards`
    shard_dir: str = ""
    # clip sampling (semantics of avion/data/clip_dataset.py:19-27)
    clip_length: int = 16
    clip_stride: int = 4
    num_clips: int = 1
    sparse_sample: bool = False
    chunk_len: int = 15  # 15-second chunked videos; -1 = unchunked
    fps: int = 30
    # decode
    decode_threads: int = 4
    fused_decode_crop: bool = True
    decode_size: int = 256  # short side decoded by host when not fused
    # fast decode profile: skip the H.264 in-loop deblocking filter +
    # fast bilinear scaling (~1.5-2x decode speedup; artifacts are
    # negligible after training downscale — docs/PERF.md).  Default
    # None = on for training datasets, off for eval; set false for
    # bit-exact parity with the reference decode path
    decode_fast: Optional[bool] = None
    # augmentation
    crop_size: int = 224
    scale_min: float = 0.5  # RRC range, clip_dataset.py:40
    scale_max: float = 1.0
    hflip_prob: float = 0.0
    vflip_prob: float = 0.0
    use_multi_scale_crop: bool = False
    norm_style: str = "openai"  # openai | timm
    # loader
    batch_size: int = 256
    num_workers: int = 8
    prefetch_depth: int = 2
    # data echoing (arXiv:1907.05550): step on each decoded batch this
    # many times consecutively.  The repeats reuse the ON-DEVICE arrays
    # (zero extra decode and zero extra H2D), multiplying the duty
    # cycle on decode-bound hosts at the cost of correlated consecutive
    # steps; epochs run echo_factor x the batch count and the LR
    # schedule accounts for it.  Mid-epoch preemption resume rounds
    # down to the nearest batch boundary.
    echo_factor: int = 1
    repeated_aug: int = 1
    # classification-train augmentation (videomae_finetune /
    # finetune_cls): host RandAugment + cube-mode random erasing
    # (reference ``--aa rand-m7-n4-mstd0.5-inc1`` default pipeline and
    # ``--reprob``, classification_dataset.py:72-90)
    rand_aug: bool = True
    erase_prob: float = 0.25
    # masking (videomae)
    mask_type: str = "tube"
    mask_ratio: float = 0.9
    # eval-time
    val_batch_size: int = 128
    num_crops: int = 1
    num_temporal_views: int = 1


@dataclass
class OptimConfig:
    optimizer: str = "adamw"  # adamw | sgd | lion
    lr: float = 4e-5
    lr_start: float = 1e-6
    lr_end: float = 1e-5
    # constant LR at ``lr`` from step 0 (no warmup/decay) — the
    # reference's ``--fix-lr`` sets lr_schedule=None
    # (main_videomae_pretrain.py:246, main_lavila_pretrain.py:671)
    fix_lr: bool = False
    warmup_epochs: float = 1.0
    epochs: int = 5
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    wd: float = 0.05
    # cosine weight-decay schedule wd -> wd_end over training (the
    # reference's ``--wd-end``, main_videomae_finetune.py:399-401,
    # applied per-iteration at :493-494); None = constant wd
    wd_end: Optional[float] = None
    momentum: float = 0.9
    grad_clip_norm: Optional[float] = None
    layer_decay: Optional[float] = None
    update_freq: int = 1  # gradient accumulation (fixed vs. broken ref path)
    # accumulation semantics when update_freq > 1:
    #   multistep — optax.MultiSteps: effective batch = update_freq x
    #     batch_size, but contrastive negatives stay within each
    #     batch_size chunk (grads averaged across chunks)
    #   cached — open_clip recipe the reference intends but ships broken
    #     (main_lavila_pretrain.py:821-859): data.batch_size is the FULL
    #     contrastive batch, split into update_freq microbatches; pass 1
    #     caches embeddings, pass 2 re-encodes each microbatch with
    #     grads spliced into the cached global batch -> EXACT global-
    #     batch loss at 1/update_freq activation memory (costs one extra
    #     forward).  CLIP/SigLIP pretrain only.
    accum: str = "multistep"
    # optimizer-state precision: float32 | bfloat16 (halves Adam mu/nu
    # HBM; the lever that fits batch 256/chip)
    state_dtype: str = "float32"
    lr_scale_by_batch: Optional[int] = None  # e.g. 128/256 in finetunes
    skip_wd_names: Tuple[str, ...] = ("bias", "scale", "pos_embed", "class_embedding", "logit_scale", "logit_bias")


@dataclass
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # run control
    output_dir: str = "./out"
    resume: str = ""
    auto_resume: bool = True
    seed: int = 0
    precision: str = "bf16"
    print_freq: int = 10
    save_freq: int = 1
    eval_freq: int = 1
    evaluate: bool = False
    wandb: bool = False
    wandb_project: str = "avion_tpu"
    run_name: str = ""
    pretrain_model: str = ""  # checkpoint to start finetune from
    # loss knobs (ClipLoss — avion/losses/losses.py:80-149)
    local_loss: bool = True
    gather_with_grad: bool = True
    label_smoothing: float = 0.0
    # contrastive objective: "clip" (softmax InfoNCE, the reference
    # loss) | "siglip" (sigmoid pairwise, arXiv:2303.15343 — beyond
    # parity; decouples the loss from global batch size)
    loss: str = "clip"
    # siglip only: ring-chunked blocks over the mesh batch axes instead
    # of XLA-partitioned dense rows (peak logit memory [b_local,
    # b_local] vs [b_local, B_global]; the giant-global-batch lever)
    siglip_chunked: bool = True
    # finetune-cls knobs
    mixup: float = 0.0
    cutmix: float = 0.0
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    # timm Mixup granularity: batch | pair | elem (``--mixup-mode``,
    # main_videomae_finetune.py mixup args)
    mixup_mode: str = "batch"
    # cutmix box fraction bounds (``--cutmix-minmax``); set overrides
    # the cutmix_alpha Beta draw with uniform box sampling
    cutmix_minmax: Optional[Tuple[float, float]] = None
    smoothing: float = 0.1
    use_ema: bool = False
    ema_decay: float = 0.9999

    # ---- (de)serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        def build(dc_cls, sub):
            kwargs = {}
            fields = {f.name: f for f in dataclasses.fields(dc_cls)}
            for k, v in sub.items():
                if k not in fields:
                    continue
                f = fields[k]
                # nested sections exist only at the TrainConfig level and
                # arrive as dicts (MeshConfig also has a field named
                # "data" — an int — so the dict check is load-bearing)
                if isinstance(v, dict) and dc_cls is cls and f.name in (
                        "model", "data", "optim", "mesh"):
                    sub_cls = {"model": ModelConfig, "data": DataConfig,
                               "optim": OptimConfig, "mesh": MeshConfig}[f.name]
                    kwargs[k] = build(sub_cls, v)
                elif isinstance(v, list):
                    kwargs[k] = tuple(v)
                else:
                    kwargs[k] = v
            return dc_cls(**kwargs)

        return build(cls, d)

    def apply_overrides(self, tokens) -> "TrainConfig":
        """Apply ``section.key=value`` / ``key=value`` CLI tokens in place."""
        for tok in tokens:
            if "=" not in tok:
                raise ValueError(f"override must be key=value, got {tok!r}")
            key, value = tok.split("=", 1)
            parts = key.split(".")
            obj = self
            for p in parts[:-1]:
                obj = getattr(obj, p)
            name = parts[-1]
            fields = {f.name: f for f in dataclasses.fields(obj)}
            if name not in fields:
                raise ValueError(f"unknown config key: {key!r}")
            setattr(obj, name, _convert(value, fields[name].type_resolved
                                        if hasattr(fields[name], "type_resolved")
                                        else _resolve_type(type(obj), name)))
        return self

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)


def _resolve_type(dc_cls, name):
    import typing

    hints = typing.get_type_hints(dc_cls)
    return hints[name]


def load_dotenv(path: str = ".env") -> dict:
    """Minimal ``.env`` loader (the reference uses python-dotenv for its
    dataset-path env vars, ``avion/utils/misc.py:8-10``); sets only keys
    not already in the environment."""
    import os

    loaded = {}
    if not os.path.exists(path):
        return loaded
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, value = line.split("=", 1)
        key, value = key.strip(), value.strip().strip("'\"")
        loaded[key] = value
        os.environ.setdefault(key, value)
    return loaded
