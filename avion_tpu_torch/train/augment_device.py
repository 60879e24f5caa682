"""Mixup / cutmix on the device (``avion_tpu.train.augment_device``), with
timm's knobs: Beta (or, with ``cutmix_minmax``, uniform box) draws at
batch, pair or element granularity, the partner of sample i is sample
B - 1 - i (the batch reversed), a cutmix box, soft targets with label
smoothing.

It is split in two: :func:`draw_mix` takes every random number from an
explicit generator and returns per-sample ``(lam, box, use_cutmix,
apply)``; :func:`apply_mix` is deterministic given them.  The JAX
function's bits cannot be reproduced here, so the parity test feeds its
draws into :func:`apply_mix`.

Over a batch ``group`` (the mesh's ``batch_group``; each rank holds its
block of the global batch, in rank order) the JAX step mixes the global
batch: the partner of global row i is global row B - 1 - i, which lives on
rank n - 1 - r.  :func:`mixup_cutmix` then draws for the whole global batch
from a generator seeded alike on every rank of the group and keeps this
rank's rows, and :func:`apply_mix` fetches the partner rows with one
exchange of the video and the labels with that rank (:func:`global_flip`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _rank_size(group) -> Tuple[int, int]:
    if group is None or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def global_flip(xs: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each of ``xs`` (this rank's rows of a global batch) replaced by this
    rank's rows of the global batch reversed: the rows of rank n - 1 - r of
    ``group``, reversed, got by one exchange with that rank (a rank that is
    its own partner, or one without a group, reverses its own)."""
    rank, n = _rank_size(group)
    peer = n - 1 - rank
    if peer == rank:
        return [x.flip(0) for x in xs]
    peer = dist.get_global_rank(group, peer)
    sends = [x.contiguous() for x in xs]
    got = [torch.empty_like(x) for x in sends]
    ops = [dist.P2POp(dist.isend, x, peer, group) for x in sends]
    ops += [dist.P2POp(dist.irecv, x, peer, group) for x in got]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [x.flip(0) for x in got]


def smooth_one_hot(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.0) -> torch.Tensor:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    one_hot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    return one_hot * (on - off) + off


def _beta(generator, alpha: float, n: int, device) -> torch.Tensor:
    a = torch._standard_gamma(torch.full((n,), float(alpha), device=device),
                              generator=generator)
    b = torch._standard_gamma(torch.full((n,), float(alpha), device=device),
                              generator=generator)
    return a / (a + b)


def _pair_mirror(v: torch.Tensor) -> torch.Tensor:
    """out[i] == out[B - 1 - i]: each pair shares the first half's draw."""
    first = torch.arange(v.shape[0], device=v.device) < v.shape[0] // 2
    return torch.where(first.view(-1, *([1] * (v.dim() - 1))), v, v.flip(0))


def _cut_boxes(generator, lam: torch.Tensor, cutmix_minmax, h: int, w: int):
    """Per-sample boxes [B, H, W] bool: a square of area ratio 1 - lam
    centred anywhere and clipped at the borders (timm ``rand_bbox``), or
    with ``cutmix_minmax=(lo, hi)`` sides uniform in [lo, hi] of the
    frame's, fully inside it (``rand_bbox_minmax``)."""
    b, dev = lam.shape[0], lam.device
    if cutmix_minmax is not None:
        lo, hi = float(cutmix_minmax[0]), float(cutmix_minmax[1])
        cut_h = torch.randint(int(h * lo), int(h * hi) + 1, (b,),
                              generator=generator, device=dev)
        cut_w = torch.randint(int(w * lo), int(w * hi) + 1, (b,),
                              generator=generator, device=dev)
        cy = (torch.rand(b, generator=generator, device=dev)
              * (h - cut_h).clamp(min=1)).long()
        cx = (torch.rand(b, generator=generator, device=dev)
              * (w - cut_w).clamp(min=1)).long()
        y0, y1, x0, x1 = cy, cy + cut_h, cx, cx + cut_w
    else:
        cut_ratio = (1.0 - lam).sqrt()
        cut_h = (h * cut_ratio).long()
        cut_w = (w * cut_ratio).long()
        cy = torch.randint(0, h, (b,), generator=generator, device=dev)
        cx = torch.randint(0, w, (b,), generator=generator, device=dev)
        y0 = (cy - cut_h // 2).clamp(0, h)
        y1 = (cy + cut_h // 2).clamp(0, h)
        x0 = (cx - cut_w // 2).clamp(0, w)
        x1 = (cx + cut_w // 2).clamp(0, w)
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]
    return ((yy >= y0[:, None, None]) & (yy < y1[:, None, None])
            & (xx >= x0[:, None, None]) & (xx < x1[:, None, None]))


def draw_mix(generator, batch: int, h: int, w: int, device=None,
             mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
             switch_prob: float = 0.5, prob: float = 1.0,
             mode: str = "batch",
             cutmix_minmax: Optional[Sequence[float]] = None):
    """The random part: per-sample (lam [B] f32, box [B, H, W] bool,
    use_cutmix [B] bool, apply [B] bool).  ``lam`` is the mixup
    coefficient; a cutmix sample's coefficient follows from its box."""
    if mode not in ("batch", "pair", "elem"):
        raise ValueError(f"mixup mode must be batch|pair|elem, got {mode!r}")
    n = batch if mode in ("pair", "elem") else 1
    have_cutmix = cutmix_alpha > 0 or cutmix_minmax is not None

    def uniform():
        return torch.rand(n, generator=generator, device=device)

    use_cutmix = (uniform() < switch_prob) & have_cutmix
    if mixup_alpha > 0:
        lam = _beta(generator, mixup_alpha, n, device)
    else:  # cutmix only: always cutmix where applied
        lam = torch.ones(n, device=device)
        use_cutmix = torch.full((n,), have_cutmix, device=device)
    if cutmix_minmax is None and cutmix_alpha > 0:
        lam_cut = _beta(generator, cutmix_alpha, n, device)
    else:  # with minmax the box gives the coefficient
        lam_cut = torch.ones(n, device=device)
    apply = uniform() < prob
    if mode == "pair":
        lam, lam_cut = _pair_mirror(lam), _pair_mirror(lam_cut)
        use_cutmix, apply = _pair_mirror(use_cutmix), _pair_mirror(apply)
    box = _cut_boxes(generator, lam_cut.expand(batch), cutmix_minmax, h, w)
    if mode == "pair":
        box = _pair_mirror(box)
    elif mode == "batch":
        box = box[:1].expand_as(box)
    return (lam.expand(batch).float(), box, use_cutmix.expand(batch),
            apply.expand(batch))


def apply_mix(video: torch.Tensor, labels: torch.Tensor, num_classes: int,
              smoothing: float, lam: torch.Tensor, box: torch.Tensor,
              use_cutmix: torch.Tensor, apply: torch.Tensor, group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic part: (mixed video, soft targets [B, classes]).
    A cutmix sample takes its partner's pixels inside its box and the
    coefficient ``1 - box area / frame area``; a mixup sample blends in f32
    (then the video's dtype) with ``lam``; a sample not applied is left.
    The partner is the sample at the mirrored place of the batch, of the
    global batch over ``group`` (the draws are this rank's rows)."""
    h, w = video.shape[-3], video.shape[-2]
    targets = smooth_one_hot(labels, num_classes, smoothing)
    flipped_v, flipped_l = global_flip([video, labels], group)
    lam_box = 1.0 - box.sum(dim=(1, 2)).float() / (h * w)
    cut_mixed = torch.where(box[:, None, :, :, None], flipped_v, video)
    lam_v = lam[:, None, None, None, None]
    mix_mixed = (lam_v * video + (1.0 - lam_v) * flipped_v).to(video.dtype)
    sel = use_cutmix[:, None, None, None, None]
    mixed = torch.where(sel, cut_mixed, mix_mixed)
    coef = torch.where(use_cutmix, lam_box, lam)
    mixed = torch.where(apply[:, None, None, None, None], mixed, video)
    coef = torch.where(apply, coef, torch.ones_like(coef))
    soft = (coef[:, None] * targets + (1.0 - coef)[:, None]
            * smooth_one_hot(flipped_l, num_classes, smoothing))
    return mixed, soft


def mixup_cutmix(generator, video: torch.Tensor, labels: torch.Tensor,
                 num_classes: int, mixup_alpha: float = 0.8,
                 cutmix_alpha: float = 1.0, switch_prob: float = 0.5,
                 prob: float = 1.0, smoothing: float = 0.1,
                 mode: str = "batch",
                 cutmix_minmax: Optional[Sequence[float]] = None,
                 group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mixed video [B, T, H, W, C], soft targets [B, num_classes]); the
    draws come from ``generator`` (on ``video``'s device).  Over a batch
    ``group`` the global batch is mixed: ``generator`` must be seeded
    alike on every rank of the group, and every rank holds as many rows."""
    rank, n = _rank_size(group)
    b = video.shape[0]
    draws = draw_mix(generator, b * n, video.shape[-3], video.shape[-2],
                     video.device, mixup_alpha, cutmix_alpha, switch_prob,
                     prob, mode, cutmix_minmax)
    draws = [x[rank * b:(rank + 1) * b] for x in draws]
    return apply_mix(video, labels, num_classes, smoothing, *draws,
                     group=group)
