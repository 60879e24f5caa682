"""The per-rank bodies of the port's parallel tests (run by
``tests/torch_dist.run_ranks`` in spawned processes of a gloo group).

They import torch and the port only: the JAX references run in the pytest
process.  Inputs arrive as numpy arrays or torch state dicts, results go
back the same way.
"""

from __future__ import annotations

import io
import os
import signal

import numpy as np
import torch
import torch.distributed as dist

CLIP_TINY_FRAMES = 2
NITER = 4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def losses(rank, world, img, txt, scale_param, bias):
    """Each loss over the world on this rank's rows of ``img`` / ``txt``:
    loss, clip_acc and the gradients of this rank's embeddings, the logit
    scale's parameter and the bias."""
    from avion_tpu_torch.losses import losses as L

    per = img.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    out = {}
    for name in ("clip", "siglip", "siglip_chunked"):
        zi = _t(img[rows]).requires_grad_()
        zt = _t(txt[rows]).requires_grad_()
        p = torch.tensor(scale_param, requires_grad=True)
        b = torch.tensor(bias, requires_grad=True)
        group = dist.group.WORLD
        if name == "clip":
            res = L.clip_loss(zi, zt, p.exp(), group=group)
        elif name == "siglip":
            res = L.siglip_loss(zi, zt, p.exp(), b, group=group)
        else:
            res = L.siglip_loss_chunked(zi, zt, p.exp(), b, group=group)
        res["loss"].backward()
        out[name] = {"loss": res["loss"].item(),
                     "clip_acc": float(res["clip_acc"]),
                     "d_img": zi.grad.numpy(), "d_txt": zt.grad.numpy(),
                     "d_scale": p.grad.item(),
                     "d_bias": 0.0 if b.grad is None else b.grad.item()}
    return out


class _Rotate(torch.autograd.Function):
    """``rotate`` of one tensor; its gradient rotates back (n - 1 more
    rotations on a ring of n)."""

    @staticmethod
    def forward(ctx, x, group):
        from avion_tpu_torch.ops.ring_attention import rotate

        ctx.group = group
        return rotate([x], group)[0]

    @staticmethod
    def backward(ctx, g):
        from avion_tpu_torch.ops.ring_attention import rotate

        for _ in range(dist.get_world_size(ctx.group) - 1):
            (g,) = rotate([g], ctx.group)
        return g, None


def ring_attention(q, k, v, group, causal, block_k):
    """The blockwise plain ring (``avion_tpu.ops.ring_attention.
    ring_attention``), the test's second reference: q, k, v the local
    [B, S_local, H, D] shards; keys in ``block_k`` chunks with an online
    softmax; the local output shard in q's dtype.  Autograd runs through
    the rotations."""
    from avion_tpu_torch.ops.ring_attention import (DEFAULT_MASK_VALUE,
                                                    group_rank_size)

    b, s_loc, h, d = q.shape
    i, n = group_rank_size(group)
    qe = q.float() / d ** 0.5
    rows = torch.arange(s_loc)
    o = q.new_zeros(b, s_loc, h, d, dtype=torch.float32)
    m = q.new_full((b, h, s_loc), DEFAULT_MASK_VALUE, dtype=torch.float32)
    l = q.new_zeros(b, h, s_loc, dtype=torch.float32)
    kv = torch.stack([k, v])
    for j in range(n):
        if j:
            kv = _Rotate.apply(kv, group)
        src = (i - j) % n
        for c0 in range(0, s_loc, block_k):
            kb, vb = kv[0][:, c0:c0 + block_k], kv[1][:, c0:c0 + block_k]
            logits = torch.einsum("bqhd,bkhd->bhqk", qe, kb.float())
            if causal:
                cols = src * s_loc + c0 + torch.arange(kb.shape[1])
                ok = cols[None, :] <= (i * s_loc + rows)[:, None]
                logits = logits + torch.where(ok, 0.0, DEFAULT_MASK_VALUE)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            a = torch.exp(m - m_new)
            l = l * a + p.sum(dim=-1)
            o = (o * a.transpose(1, 2)[..., None]
                 + torch.einsum("bhqk,bkhd->bqhd", p, vb.float()))
            m = m_new
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring(rank, world, q, k, v, g, heads, causal):
    """``sequence_parallel_attention`` (the kernel ring of
    ``ring_flash_attention_packed`` on [B, S, H, D] views) over the world on
    this rank's sequence shard: (out, dq, dk, dv) of the shard for
    cotangent ``g``; the same of the blockwise :func:`ring_attention` under
    ``blockwise``."""
    from avion_tpu_torch.ops import flash_attention as fa
    from avion_tpu_torch.ops.ring_attention import sequence_parallel_attention

    per = q.shape[1] // world
    b, s, w = q.shape[0], per, q.shape[2]
    cut = lambda x: _t(x[:, rank * per:(rank + 1) * per])  # noqa: E731
    heads_first = lambda x: x.view(b, s, heads, w // heads)  # noqa: E731
    out = {}
    for name in ("flash", "blockwise"):
        qh, kh, vh = (heads_first(cut(x)).requires_grad_() for x in (q, k, v))
        fa.reset_launches()
        if name == "flash":
            o = sequence_parallel_attention(qh, kh, vh,
                                            group=dist.group.WORLD,
                                            causal=causal)
        else:
            o = ring_attention(qh, kh, vh, dist.group.WORLD, causal,
                               block_k=4)
        o.backward(heads_first(cut(g)))
        res = {"out": o.detach().reshape(b, s, w).numpy(),
               **{key: x.grad.reshape(b, s, w).numpy() for key, x
                  in (("dq", qh), ("dk", kh), ("dv", vh))}}
        if name == "flash":
            out.update(res, plain_calls=dict(fa.plain_calls))
        else:
            out["blockwise"] = res
    return out


def _mesh_model(model, data, fsdp=1, sp=1):
    from avion_tpu_torch.parallel.mesh import make_mesh
    from avion_tpu_torch.parallel.sharding import Parallel, shard_model

    mesh = make_mesh(data=data, fsdp=fsdp, sp=sp)
    shard_model(model, mesh)
    return mesh, Parallel(mesh, model)


def vit_sp(rank, world, state, video, data, sp, remat=False):
    """The tiny sequence-parallel ViT over a data x sp mesh (with ``remat``
    under the ``save_attn`` policy): this rank's batch group's clips, its
    shard of the tokens; loss ``sum(o cos o)`` of the gathered pooled
    features.  Returns the gathered output, the world-averaged gradients
    and the plain calls by kernel, from every rank."""
    from avion_tpu_torch.losses.losses import gather_batch
    from avion_tpu_torch.models.vit import VisionTransformer
    from avion_tpu_torch.ops import flash_attention as fa
    from avion_tpu_torch.parallel.mesh import use_mesh
    from avion_tpu_torch.parallel.sharding import make_global_batch

    model = VisionTransformer(image_size=32, patch_size=16, num_frames=8,
                              width=32, layers=2, heads=2,
                              dtype=torch.float32, pooling="gap",
                              sequence_parallel=True, remat=remat)
    model.load_state_dict(state, strict=True)
    mesh, par = _mesh_model(model, data=data, sp=sp)
    fa.reset_launches()
    with use_mesh(mesh):
        x = make_global_batch(mesh, {"video": _t(video)})["video"]
        o = gather_batch(par.model(x), mesh.batch_group)
        (o * o.cos()).sum().backward()
    return {"out": o.detach().numpy(),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
            "plain_calls": dict(fa.plain_calls)}


def _clip_tiny(sd, use_logit_bias=False, sequence_parallel=False,
               **model_kw):
    from avion_tpu_torch.models.registry import create_model

    model = create_model("CLIP_TINY", num_frames=CLIP_TINY_FRAMES,
                         use_logit_bias=use_logit_bias,
                         sequence_parallel=sequence_parallel,
                         pooling="gap" if sequence_parallel else "cls",
                         **model_kw)
    model.load_state_dict(sd, strict=True)
    return model


def encode(rank, world, sd, videos, texts, batch):
    """``CLIPEncoders`` over the world: each rank encodes its rows of
    every chunk, the embeddings are gathered."""
    from avion_tpu_torch.eval.runners import CLIPEncoders

    enc = CLIPEncoders(_clip_tiny(sd), batch=batch, weight_dtype="f32",
                       group=dist.group.WORLD)
    return enc.encode_images(videos), enc.encode_texts(texts)


def _gathered(state):
    """The whole parameters (and EMA) of ``state`` as numpy, gathered over
    fsdp and tensor (every rank calls it)."""
    from avion_tpu_torch.parallel.sharding import full_tensor

    whole = state.state_dict()
    return ({k: full_tensor(v).numpy() for k, v in whole["model"].items()},
            {k: full_tensor(v).numpy() for k, v in whole["ema"].items()}
            if whole.get("ema") is not None else None)


def _gathered_grads(model):
    from avion_tpu_torch.parallel.sharding import full_tensor
    from avion_tpu_torch.parallel.tensor_parallel import tensor_layout

    layout = tensor_layout(model)
    out = {}
    for k, p in model.named_parameters():
        if p.grad is None:
            continue
        g = full_tensor(p.grad)
        out[k] = (g if layout is None else layout.gather(k, g)).numpy()
    return out


def train_step(rank, world, sd, opt, batch, data, fsdp, update_freq,
               loss_type="clip", sp=1, tensor=1, steps=1, pp=1, ep=1,
               model_kw=None):
    """One CLIP_TINY step over a data x fsdp x pp x sp x ep mesh (FSDP2
    when fsdp > 1, DDP otherwise; with sp > 1 the sequence-parallel visual
    tower, gap pooling; ``model_kw`` e.g. ``moe_experts`` or ``pipeline``)
    on this rank's rows of ``batch`` (microbatch-major [M, B / M, ...] when
    ``update_freq`` > 1).  Returns the metrics, the whole updated
    parameters and whether they are sharded at rest."""
    from avion_tpu_torch.core.config import OptimConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from avion_tpu_torch.parallel.sharding import (Parallel, full_tensor,
                                                   is_dtensor,
                                                   make_global_batch,
                                                   shard_model)
    from avion_tpu_torch.train.steps import (make_clip_accum_train_step,
                                             make_clip_train_step)

    model = _clip_tiny(sd, loss_type == "siglip", sequence_parallel=sp > 1,
                       **(model_kw or {}))
    mesh = make_mesh(data=data, fsdp=fsdp, sp=sp, tensor=tensor, pp=pp,
                     ep=ep)
    shard_model(model, mesh)
    cfg = OptimConfig(**opt, update_freq=update_freq, accum="cached")
    optimizer, _ = build_optimizer(cfg, model, NITER)
    state = TrainState.create(model, optimizer, parallel=Parallel(
        mesh, model, find_unused=update_freq > 1))
    with use_mesh(mesh):
        step = (make_clip_accum_train_step(model, update_freq,
                                           loss_type=loss_type)
                if update_freq > 1 else
                make_clip_train_step(model, loss_type=loss_type))
        local = make_global_batch(mesh, {k: _t(v) for k, v in batch.items()},
                                  batch_dim=1 if update_freq > 1 else 0)
        for _ in range(steps):
            state, metrics = step(state, local)
    sharded = {n: is_dtensor(p) for n, p in model.named_parameters()}
    moments_sharded = all(
        is_dtensor(m) == is_dtensor(p)
        for p, s in optimizer.inner.state.items() for m in s.values())
    # the step's (clipped) gradients, still on the parameters
    grads = _gathered_grads(model)
    whole, _ = _gathered(state)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": whole if rank == 0 else None,
            "grads": grads if rank == 0 else None, "sharded": sharded,
            "moments_sharded": moments_sharded,
            "local": {n: full_tensor(p.detach()).numpy()
                      for n, p in model.named_parameters()},
            "tensor": mesh.coords["tensor"]}


def save_after_step(rank, world, sd, opt, batch, out_dir, tensor=1, pp=1,
                    ep=1, model_kw=None):
    """One step at fsdp = world / (tensor pp ep) (sharded state), ``tensor``,
    ``pp`` and ``ep`` (``model_kw``: CLIP_TINY's ``pipeline`` or
    ``moe_experts``), then a checkpoint; returns the gathered state rank 0
    wrote, serialized by ``torch.save``."""
    from avion_tpu_torch.core.checkpoint import Checkpointer, _to_cpu
    from avion_tpu_torch.core.config import OptimConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from avion_tpu_torch.parallel.sharding import (Parallel,
                                                   make_global_batch,
                                                   shard_model)
    from avion_tpu_torch.train.steps import make_clip_train_step

    model = _clip_tiny(sd, **(model_kw or {}))
    mesh = make_mesh(data=1, fsdp=world // (tensor * pp * ep), tensor=tensor,
                     pp=pp, ep=ep)
    shard_model(model, mesh)
    optimizer, _ = build_optimizer(OptimConfig(**opt), model, NITER)
    state = TrainState.create(model, optimizer,
                              parallel=Parallel(mesh, model))
    with use_mesh(mesh):
        step = make_clip_train_step(model)
        state, _ = step(state, make_global_batch(
            mesh, {k: _t(v) for k, v in batch.items()}))
    Checkpointer(out_dir).save(state.step, state, extra={"world": world})
    whole = _to_cpu(state.state_dict())
    if rank:
        return None
    buf = io.BytesIO()  # tensors in a queue would travel as shared memory
    torch.save(whole, buf)
    return buf.getvalue()


def preempted_main(rank, world, args):
    """``pretrain_clip.main`` on every rank; rank 1 alone gets SIGTERM after
    its first step.  Returns main's result."""
    from avion_tpu_torch.train import pretrain_clip

    make_step = pretrain_clip.make_step

    def signalling(cfg, model):
        step = make_step(cfg, model)

        def wrapped(state, batch):
            out = step(state, batch)
            if rank == 1 and state.step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    pretrain_clip.make_step = signalling
    res = pretrain_clip.main(args)
    return {"step": res["step"], "steps": res["steps"]}


# the four entries' models at the tests' tiny size (f32), by kind
TINY_TOWER = dict(image_size=32, patch_size=16, num_frames=2, width=64,
                  layers=2, heads=2)
VMAE_GEOMETRY = dict(image_size=32, patch_size=16, num_frames=4,
                     tubelet_size=2)
VMAE_PRETRAIN = dict(VMAE_GEOMETRY, encoder_width=64, encoder_layers=2,
                     encoder_heads=2, decoder_width=32, decoder_layers=2,
                     decoder_heads=2, mask_ratio=0.5)
VMAE_FINETUNE = dict(VMAE_GEOMETRY, width=64, layers=2, heads=2,
                     num_classes=5)
# a decoder of 3 heads, which tensor=2 does not divide (JAX's column blocks)
VMAE_PRETRAIN_H3 = dict(VMAE_PRETRAIN, decoder_width=96, decoder_heads=3)
# the narrator's VCLM: CLIP's vocabulary, so the embedding shards
VCLM_TINY = dict(vocab_size=49408, context_length=16, width=32, layers=2,
                 heads=2, cross_every=1, image_size=32, patch_size=16,
                 num_frames=2, vision_width=32, vision_layers=2,
                 vision_heads=2)


def entry_model(kind):
    """The tiny f32 model of an entry: ``mir`` CLIP_TINY, ``cls`` the
    classifier on a 2-frame tower (5 classes), ``vmae_pretrain`` /
    ``vmae_finetune`` the VideoMAE pair of ``test_torch_videomae_model``,
    ``narrator`` :data:`VCLM_TINY` (``narrator_pp`` with its decoder
    pipelined, 2 microbatches)."""
    from avion_tpu_torch.models import videomae as vm
    from avion_tpu_torch.models.clip import VideoClassifier
    from avion_tpu_torch.models.layers import quick_gelu
    from avion_tpu_torch.models.narrator import VCLM
    from avion_tpu_torch.models.vit import VisionTransformer

    if kind == "narrator":
        return VCLM(**VCLM_TINY, dtype=torch.float32)
    if kind == "narrator_pp":
        return VCLM(**VCLM_TINY, dtype=torch.float32, pipeline=True,
                    pipeline_microbatches=2)
    if kind == "mir":
        from avion_tpu_torch.models.registry import create_model

        return create_model("CLIP_TINY", num_frames=CLIP_TINY_FRAMES)
    if kind == "cls":
        return VideoClassifier(VisionTransformer(
            **TINY_TOWER, act=quick_gelu, dtype=torch.float32,
            pooling="cls"), num_classes=5)
    if kind == "vmae_pretrain":
        return vm.PretrainVideoMAE(**VMAE_PRETRAIN, dtype=torch.float32)
    if kind == "vmae_pretrain_h3":
        return vm.PretrainVideoMAE(**VMAE_PRETRAIN_H3, dtype=torch.float32)
    return vm.FinetuneVideoMAE(**VMAE_FINETUNE, dtype=torch.float32,
                               drop_path_rate=0.0)


def entry_step(rank, world, kind, sd, opt, batch, data, fsdp, ema_decay=None,
               label_smoothing=0.0, tensor=1, sp=1, pp=1, ep=1):
    """One step of an entry's train step (``kind`` as :func:`entry_model`)
    over a data x fsdp mesh (FSDP2 when fsdp > 1, DDP otherwise) on this
    rank's rows of ``batch``, with layer decay over 2 layers and, given
    ``ema_decay``, an EMA.  Returns the metrics, the whole updated
    parameters and EMA (rank 0), whether any parameter is sharded, and
    each parameter's layer-decay scale by name."""
    from avion_tpu_torch.core.config import OptimConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from avion_tpu_torch.parallel.sharding import (Parallel, full_tensor,
                                                   is_dtensor,
                                                   make_global_batch,
                                                   shard_model)
    from avion_tpu_torch.train import steps

    model = entry_model(kind)
    model.load_state_dict(sd, strict=True)
    mesh = make_mesh(data=data, fsdp=fsdp, tensor=tensor, sp=sp, pp=pp,
                     ep=ep)
    shard_model(model, mesh)
    optimizer, _ = build_optimizer(OptimConfig(**opt), model, NITER,
                                   num_layers=2)
    state = TrainState.create(model, optimizer, use_ema=ema_decay is not None,
                              parallel=Parallel(mesh, model,
                                                find_unused=kind == "mir"))
    if kind == "mir":
        step = steps.make_mir_finetune_step(model)
    elif kind.startswith("narrator"):
        from avion_tpu_torch.train.train_narrator import make_narrator_step

        step = make_narrator_step(model)
    elif kind.startswith("vmae_pretrain"):
        step = steps.make_videomae_train_step(model)
    else:
        step = steps.make_cls_train_step(model, label_smoothing,
                                         ema_decay=ema_decay)
    with use_mesh(mesh):
        local = make_global_batch(mesh, {k: _t(v) for k, v in batch.items()})
        state, metrics = step(state, local)
    names = {id(p): n for n, p in model.named_parameters()}
    scales = {names[id(p)]: g["lr_scale"]
              for g in optimizer.inner.param_groups for p in g["params"]}
    whole, ema = _gathered(state)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": whole if rank == 0 else None,
            "ema": ema if rank == 0 else None,
            "sharded": any(is_dtensor(p) for p in model.parameters()),
            "scales": scales}


def max_margin(rank, world, img, txt):
    """``max_margin_ranking_loss`` over the world on this rank's rows:
    the loss and the gradients of this rank's embeddings."""
    from avion_tpu_torch.losses.losses import max_margin_ranking_loss

    per = img.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    zi = _t(img[rows]).requires_grad_()
    zt = _t(txt[rows]).requires_grad_()
    loss = max_margin_ranking_loss(zi, zt, group=dist.group.WORLD)["loss"]
    loss.backward()
    return {"loss": loss.item(), "d_img": zi.grad.numpy(),
            "d_txt": zt.grad.numpy()}


def mix(rank, world, video, labels, draws, seed, kw):
    """This rank's rows of the global batch mixed over the world: by
    ``apply_mix`` on this rank's rows of the given per-sample ``draws``,
    and by ``mixup_cutmix`` drawing from a generator seeded ``seed``."""
    from avion_tpu_torch.train import augment_device as ad

    per = video.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    v, lab = _t(video[rows]), _t(labels[rows])
    group = dist.group.WORLD
    out = {}
    if draws is not None:
        got = ad.apply_mix(v, lab, 7, 0.1, *[_t(d[rows]) for d in draws],
                           group=group)
        out["apply"] = [x.numpy() for x in got]
    got = ad.mixup_cutmix(torch.Generator().manual_seed(seed), v, lab, 7,
                          smoothing=0.1, group=group, **kw)
    out["drawn"] = [x.numpy() for x in got]
    return out


def entry_main(rank, world, entry, args):
    """``<entry>.main(args)`` on every rank of the world; returns its
    result's steps and eval metrics."""
    import importlib

    main = importlib.import_module(f"avion_tpu_torch.train.{entry}").main
    res = main(args)
    return {"steps": res["steps"], "step": res["step"],
            "eval": res.get("eval"), "epochs": res["epochs"]}


def vmae_validate(rank, world, cfg_args, sd, ema, fsdp):
    """``videomae_finetune.validate`` over the world on a tiny finetune
    model loaded with ``sd`` and carrying ``ema`` as its EMA, sharded over
    ``fsdp`` (the rest data)."""
    from types import SimpleNamespace

    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.parallel.mesh import make_mesh
    from avion_tpu_torch.parallel.sharding import (Parallel, shard_like,
                                                   shard_model)
    from avion_tpu_torch.train import videomae_finetune as vf

    cfg = TrainConfig().apply_overrides(cfg_args)
    model = vf.build_model(cfg).to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    model.load_state_dict(sd, strict=True)
    mesh = make_mesh(data=world // fsdp, fsdp=fsdp)
    shard_model(model, mesh)
    params = dict(model.named_parameters())
    state = SimpleNamespace(
        model=model, parallel=Parallel(mesh, model),
        ema={k: shard_like(v, params[k]) for k, v in ema.items()})
    return vf.validate(cfg, SimpleNamespace(state=state))


def cls_validate(rank, world, cfg_args, w):
    """``finetune_cls.validate`` over the world with a linear scorer of the
    normalized clip (``w``, the test's ``_Scorer``)."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.train import finetune_cls

    class Scorer(torch.nn.Module):
        dtype = torch.bfloat16

        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(_t(w))

        def forward(self, video):
            return video.reshape(video.shape[0], -1).float() @ self.w

    cfg = finetune_cls.env_defaults(TrainConfig().apply_overrides(cfg_args))
    _, pairs, _ = finetune_cls.load_actions(cfg.data.label_map)
    return finetune_cls.validate(cfg, Scorer(), pairs, dist.group.WORLD)


def ema_checkpoint(rank, world, sd, opt, batch, out_dir):
    """One classification step of the tiny VideoMAE finetune model with an
    EMA at fsdp = world, then a checkpoint; returns (the EMA gathered whole
    by ``full_tensor`` on every rank, whether it was sharded)."""
    from avion_tpu_torch.core.checkpoint import Checkpointer
    from avion_tpu_torch.core.config import OptimConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from avion_tpu_torch.parallel.sharding import (Parallel, full_tensor,
                                                   is_dtensor,
                                                   make_global_batch,
                                                   shard_model)
    from avion_tpu_torch.train.steps import make_cls_train_step

    model = entry_model("vmae_finetune")
    model.load_state_dict(sd, strict=True)
    mesh = make_mesh(data=1, fsdp=world)
    shard_model(model, mesh)
    optimizer, _ = build_optimizer(OptimConfig(**opt), model, NITER,
                                   num_layers=2)
    state = TrainState.create(model, optimizer, use_ema=True,
                              parallel=Parallel(mesh, model))
    with use_mesh(mesh):
        state, _ = make_cls_train_step(model, ema_decay=0.9)(
            state, make_global_batch(mesh, {k: _t(v)
                                            for k, v in batch.items()}))
    Checkpointer(out_dir).save(state.step, state)
    return ({k: full_tensor(v).numpy() for k, v in state.ema.items()},
            any(is_dtensor(v) for v in state.ema.values()))


def restore_parts(rank, world, sd, opt, ckpt_dir, tensor, pp=1, ep=1,
                  model_kw=None):
    """A CLIP_TINY train state at tensor x pp x ep = world restored from
    ``ckpt_dir``: the step, and this rank's parts of the parameters and
    of AdamW's first moments, by parameter name."""
    from avion_tpu_torch.core.checkpoint import Checkpointer
    from avion_tpu_torch.core.config import OptimConfig
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.parallel.mesh import make_mesh
    from avion_tpu_torch.parallel.sharding import shard_model

    model = _clip_tiny(sd, **(model_kw or {}))
    shard_model(model, make_mesh(data=world // (tensor * pp * ep),
                                 tensor=tensor, pp=pp, ep=ep))
    optimizer, _ = build_optimizer(OptimConfig(**opt), model, NITER)
    state = TrainState.create(model, optimizer)
    Checkpointer(ckpt_dir).restore(state)
    mu = {n: optimizer.inner.state[p]["exp_avg"].numpy()
          for n, p in zip(optimizer.names, optimizer.params)
          if "exp_avg" in optimizer.inner.state[p]}
    return {"step": state.step, "mu": mu,
            "params": {n: p.detach().numpy()
                       for n, p in model.named_parameters()},
            "held": sorted(model.tensor_layout.leaves)}


def tensor_block(rank, world, kind, sd, x, g, causal=False):
    """A block cut over a world of tensor ranks (``layers.Block`` of width
    ``x.shape[-1]``, or the narrator's ``CrossAttention`` over a visual
    input that is ``x`` itself), forward on ``x`` and backward of
    ``sum(out * g)``: the output, the input's gradient, and every
    parameter's whole gradient (gathered over the group)."""
    from avion_tpu_torch.models.layers import Block
    from avion_tpu_torch.models.narrator import CrossAttention
    from avion_tpu_torch.parallel.mesh import make_mesh
    from avion_tpu_torch.parallel.tensor_parallel import tensor_parallelize

    width = x.shape[-1]
    heads = width // 32
    if kind == "block":
        model = Block(width, heads, dtype=torch.float32, causal=causal)
    else:
        model = CrossAttention(width, heads)
    model.load_state_dict(sd, strict=True)
    tensor_parallelize(model, make_mesh(data=1, tensor=world))
    xt = _t(x).requires_grad_()
    out = model(xt) if kind == "block" else model(xt, xt)
    (out * _t(g)).sum().backward()
    layout = model.tensor_layout
    return {"out": out.detach().numpy(), "dx": xt.grad.numpy(),
            "grads": {n: layout.gather(n, p.grad).numpy()
                      for n, p in model.named_parameters()},
            "held": sorted(layout.leaves),
            "gathered": sorted(n for n, m in model.named_modules()
                               if getattr(m, "tensor", None) is not None
                               and m.tensor.gathered)}


def tensor_draws(rank, world, data, tensor, seed, step):
    """The random draws of a training step over a data x tensor mesh:
    this rank's seed (``steps._parallel_parts``) and, from its step
    generator, patch dropout's kept tokens, DropPath's keep masks, the
    device tube masks and mixup's draws."""
    from types import SimpleNamespace

    from avion_tpu_torch.data.transforms import tube_mask_device
    from avion_tpu_torch.models.layers import Transformer, patch_dropout
    from avion_tpu_torch.parallel.mesh import make_mesh
    from avion_tpu_torch.parallel.sharding import Parallel, shard_model
    from avion_tpu_torch.train import augment_device as ad
    from avion_tpu_torch.train.steps import _parallel_parts, _step_generator

    model = Transformer(64, 2, 2, dtype=torch.float32, drop_path_rate=0.5)
    mesh = make_mesh(data=data, tensor=tensor)
    shard_model(model, mesh)
    state = SimpleNamespace(parallel=Parallel(mesh, model))
    _, module, _, rank_seed = _parallel_parts(state, seed)
    gen = _step_generator(module, rank_seed, step)
    x = torch.arange(2 * 9 * 4, dtype=torch.float32).reshape(2, 9, 4)
    kept = patch_dropout(x, 0.5, gen)
    keep = module.draw_drop_path(2, gen, "cpu")
    tubes = tube_mask_device(gen, 2, 2, 2, 2, 0.5)
    video = torch.rand(2, 2, 4, 4, 3, generator=gen)
    mixed, target = ad.mixup_cutmix(gen, video, torch.tensor([0, 1]), 3,
                                    group=mesh.batch_group)
    return {"seed": rank_seed, "tensor": mesh.coords["tensor"],
            "batch": mesh.batch_index, "kept": kept.numpy(),
            "drop_path": keep.numpy(), "tubes": tubes.numpy(),
            "mixed": mixed.numpy(), "target": target.numpy()}


def tensor_whole_model(rank, world, sd, fsdp):
    """``train.common.whole_model`` of CLIP_TINY cut over tensor = world /
    fsdp (and sharded over ``fsdp``): the copy's state dict, and whether
    the copy is a whole model (no tensor layout, no sharded tensor)."""
    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.parallel.mesh import make_mesh
    from avion_tpu_torch.parallel.sharding import is_dtensor, shard_model
    from avion_tpu_torch.parallel.tensor_parallel import tensor_layout
    from avion_tpu_torch.train.common import whole_model

    def build():
        with torch.device("meta"):
            return create_model("CLIP_TINY", num_frames=CLIP_TINY_FRAMES)

    model = _clip_tiny(sd)
    shard_model(model, make_mesh(data=1, fsdp=fsdp, tensor=world // fsdp))
    copy = whole_model(model, build)
    state = copy.state_dict()
    return ({k: v.numpy() for k, v in state.items()},
            tensor_layout(copy) is None
            and not any(is_dtensor(v) for v in state.values()))


def _grads_whole(model):
    """Every parameter's gradient, whole (gathered over fsdp and the
    model's layout; every rank calls it)."""
    from avion_tpu_torch.parallel.sharding import full_tensor
    from avion_tpu_torch.parallel.tensor_parallel import tensor_layout

    layout = tensor_layout(model)
    out = {}
    for k, p in model.named_parameters():
        g = full_tensor(p.grad)
        out[k] = (g if layout is None else layout.gather(k, g)).numpy()
    return out


def moe_layer(rank, world, kind, sd, x, c, data, ep, kw):
    """``ops.moe.MoEMlp(**kw)`` (``kind`` "mlp") or a ``layers.Block`` with
    ``moe_experts`` (``kind`` "block"), f32, over a data x ep mesh (DDP
    over data) on this rank's rows of ``x``; objective ``sum(y * c)`` of
    the batch group's gathered output plus 0.01 times the aux loss.
    Returns the gathered output, the aux loss and stats, every parameter's
    whole gradient, and the input's gradient (as the global objective's)."""
    from avion_tpu_torch.losses.losses import gather_batch
    from avion_tpu_torch.models.layers import Block
    from avion_tpu_torch.ops.moe import MoEMlp, moe_outputs
    from avion_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from avion_tpu_torch.parallel.sharding import (Parallel,
                                                   make_global_batch,
                                                   shard_model)

    model = (MoEMlp(**kw, dtype=torch.float32) if kind == "mlp" else
             Block(**kw, dtype=torch.float32))
    model.load_state_dict(sd, strict=True)
    mesh = make_mesh(data=data, ep=ep)
    shard_model(model, mesh)
    par = Parallel(mesh, model)
    with use_mesh(mesh):
        xl = make_global_batch(mesh, {"x": _t(x)})["x"].requires_grad_()
        y = gather_batch(par.model(xl), mesh.batch_group)
        moe = moe_outputs(model)[0]
        ((y * _t(c)).sum() + 0.01 * moe.aux).backward()
        par.finish_backward()
    return {"out": y.detach().numpy(), "aux": float(moe.aux.detach()),
            "zloss": float(moe.zloss.detach()), "load": moe.load.numpy(),
            "overflow": float(moe.overflow), "grads": _grads_whole(model),
            "dx": (xl.grad / mesh.n_batch_shards).numpy(),
            "held": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def pipe_stack(rank, world, kind, sd, x, c, data, fsdp, pp, m, remat,
               kw, enc=None):
    """A pipelined stack in f32 over a data x fsdp x pp mesh: ``kind``
    "tower" (``pipeline.PipelinedTransformer(**kw)``), "vclm" or "gpt2"
    (``pipeline_gated.PipelinedGatedDecoder(**kw)``, cross position mid or
    pre, on the visual tokens ``enc``), ``m`` microbatches, ``remat``;
    objective ``sum(y * c)`` of the batch group's gathered output.
    Returns the gathered output, every parameter's whole gradient, the
    input's (and ``enc``'s) gradient as the global objective's, the shapes
    this rank holds, and the plain attention calls."""
    from avion_tpu_torch.losses.losses import gather_batch
    from avion_tpu_torch.ops import flash_attention as fa
    from avion_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from avion_tpu_torch.parallel.pipeline import PipelinedTransformer
    from avion_tpu_torch.parallel.pipeline_gated import (
        PipelinedGatedDecoder)
    from avion_tpu_torch.parallel.sharding import (Parallel,
                                                   make_global_batch,
                                                   shard_model)

    if kind == "tower":
        model = PipelinedTransformer(**kw, dtype=torch.float32,
                                     num_microbatches=m, remat=remat)
    else:
        model = PipelinedGatedDecoder(
            **kw, cross_position="mid" if kind == "vclm" else "pre",
            dtype=torch.float32, num_microbatches=m, remat=remat)
    model.load_state_dict(sd, strict=True)
    mesh = make_mesh(data=data, fsdp=fsdp, pp=pp)
    shard_model(model, mesh)
    par = Parallel(mesh, model)
    fa.reset_launches()
    with use_mesh(mesh):
        rows = {"x": _t(x)} if enc is None else {"x": _t(x), "enc": _t(enc)}
        local = {k: v.requires_grad_() for k, v in
                 make_global_batch(mesh, rows).items()}
        args = (local["x"],) if enc is None else (local["x"], local["enc"])
        y = gather_batch(par.model(*args), mesh.batch_group)
        (y * _t(c)).sum().backward()
        par.finish_backward()
    n = mesh.n_batch_shards
    return {"out": y.detach().numpy(), "grads": _grads_whole(model),
            "dx": (local["x"].grad / n).numpy(),
            "denc": None if enc is None else (local["enc"].grad / n).numpy(),
            "held": {k: tuple(p.shape) for k, p in model.named_parameters()},
            "plain_calls": dict(fa.plain_calls)}


def vclm_pipe(rank, world, sd, video, tokens, c, data, pp, m, kw):
    """A VCLM (``kw``, f32) with its decoder pipelined (``m`` microbatches)
    over a data x pp mesh, on this rank's rows of ``video`` / ``tokens``;
    objective ``sum(logits * c)`` of the batch group's gathered logits.
    Returns the gathered logits and every parameter's whole gradient."""
    from avion_tpu_torch.losses.losses import gather_batch
    from avion_tpu_torch.models.narrator import VCLM
    from avion_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from avion_tpu_torch.parallel.sharding import (Parallel,
                                                   make_global_batch,
                                                   shard_model)

    model = VCLM(**kw, dtype=torch.float32, pipeline=True,
                 pipeline_microbatches=m)
    model.load_state_dict(sd, strict=True)
    mesh = make_mesh(data=data, pp=pp)
    shard_model(model, mesh)
    par = Parallel(mesh, model)
    with use_mesh(mesh):
        local = make_global_batch(mesh, {"video": _t(video),
                                         "tokens": _t(tokens)})
        logits = gather_batch(par.model(local["video"], local["tokens"]),
                              mesh.batch_group)
        (logits * _t(c)).sum().backward()
        par.finish_backward()
    return {"logits": logits.detach().numpy(), "grads": _grads_whole(model)}


def narrator_main(rank, world, kw, args):
    """``train_narrator.main(args)`` with ``VCLM_TINY_PP`` (a VCLM of
    ``kw`` in f32, its pipeline options from the entry) registered; returns
    the result's steps and epochs."""
    from avion_tpu_torch.models.narrator import VCLM
    from avion_tpu_torch.models.registry import register_model
    from avion_tpu_torch.train import train_narrator

    @register_model("VCLM_TINY_PP")
    def _tiny_pp(num_frames=2, pipeline=False, pipeline_microbatches=8,
                 pipeline_remat=False, dtype=None, **_):
        return VCLM(**kw, num_frames=num_frames, pipeline=pipeline,
                    pipeline_microbatches=pipeline_microbatches,
                    pipeline_remat=pipeline_remat,
                    dtype=dtype or torch.float32)

    res = train_narrator.main(args)
    return {"steps": res["steps"], "step": res["step"],
            "epochs": res["epochs"]}
