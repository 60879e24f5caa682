"""Smoke test of the PyTorch port on one CUDA card: build the kernels, hold
each against its plain version, serve full-width CLIP ViT-B/16 over HTTP
through the port's normal entry point, train it for a few steps on seeded
batches, then through the training entry on decoded video, evaluate it
zero-shot on the five suites, pretrain and finetune VideoMAE ViT-B/16,
finetune CLIP ViT-B/16 at 16 frames for EK100 retrieval and action
classification, and train CLIP ViT-L/14 at the global batch 896 through
cached gradient accumulation, SigLIP and bf16 optimizer state, train,
run and serve the narrators (the VCLM and LaViLa's), extract EgoNLQ
features from a long video and train VSLNet on them, and convert
checkpoints, serve decoded ``paths`` with int8 weights over one replica per
card and profile a train step through the port's tools, run the
convergence drill (train, preempt, resume, evaluate), play the ranks of
tensor-parallel blocks on the card, train the mixture-of-experts tower
and play the pipelines' stages and the experts' ranks, and run each
benchmark tool of the port at a small size.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit, and
   the video reader's decode backend with the seconds its first use took
   (on a tree without ``native/decode/libavion_decode.so``, the first-use
   build attempt: it fails where FFmpeg's headers are missing, and its
   marker keeps the data phases' loader workers from trying again); the
   loaders' forkserver is started, to import this script during the build;
2. build: ``avion_tpu_torch/ops/csrc/flash_{fwd,bwd}.cu``, one ``nvcc``
   each, started together; every instance of the forward's kernel (8) and
   of the backward's two kernels (12) must report 0 spill bytes and no
   serialized wgmma (ptxas) and hold ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   loads) in its SASS (``cuobjdump -sass``), the combined instance
   ``UBLKRED`` (dq by bulk reduce-add) and no per-element f32 atomic;
3. kernel: every flash-attention kernel (bf16) against its plain f32
   version: the forward (inference and with lse) at KERNEL_SHAPES (max abs
   error 3e-2, the JAX bf16 forward tolerance, RMS error at most 0.5% of
   the RMS output, lse within LSE_TOL), the backward's dq, dk and dv at
   BWD_SHAPES (3e-2 and 1.5%), each with its time through the wrapper
   (``kernel_ms``), the plain time, the time of
   ``scaled_dot_product_attention`` (its backward for the backward; a
   yardstick only, the port never calls it), the least time the card could
   take (``bound_ms``), its TFLOP/s and its device time kernel by kernel
   (torch.profiler; the forward's sum is ``device_ms``, the backward's
   ``delta_kernel`` alone ``delta_ms``); then, under
   ``torch.use_deterministic_algorithms(True)``, two backwards at the
   combined route's (32, 785, 12, 64) bit-equal, each on the split dq /
   dkv kernels (no combined launch), timed beside the default route;
   then the QuickGELU kernels (``csrc/quick_gelu.cu``) at MIR's hidden
   tensor, [64 x 3137, 3072] bf16 (ACT_SHAPE): forward and gradient
   against the formula in f32 (max abs error over the largest reference
   value and RMS error over RMS reference at most one bf16 ulp, 2^-8),
   one launch each, each timed beside its bytes bound and the plain
   chain (the formula, and autograd's backward through it); the seeded
   train path (5), the data phase's run A and the data-fed MIR and CLS
   finetunes then count the pair's launches against their models' (a
   forward and a backward per layer of a QuickGELU tower, one more
   forward under remat, one per layer of each inference forward), and
   the ``kernels`` line carries the pair beside the flash kernels;
4. serve: a seeded random ``CLIP_VITB16`` checkpoint in the reference
   layout, served by ``avion_tpu_torch.serve.server.main`` at 4 frames on
   an ephemeral port; every endpoint is called, the answers checked, the
   kernel's launches counted (one per attention layer of every tower
   forward), five requests profiled one by one (device time by kind), and
   two clips and two texts re-run on the CPU through the plain path
   (cosine >= 0.99);
5. train: the recipe of ``scripts/examples/pretrain_vitb_ego4d.sh`` at
   batch 256 and 4 frames, built through ``TrainConfig``,
   ``build_model_and_state``, ``make_clip_train_step`` and ``setup_run``;
   ``train_one_epoch`` over 8 seeded batches (3 distinct) with finite
   losses and 24 forward-with-lse and 24 combined-backward launches per
   step; step time, clips/s, peak memory, a profiled step, the share of
   989 TFLOP/s; the forward counts of the ``full`` and ``save_attn_k10``
   policies; 4 more steps under the deterministic flag (24 + 24 + 24
   split launches a step, p50 beside the default's); one batch-2 step
   against the CPU in f32 (loss within 2%, gradient cosine >= 0.99); save
   and an exact resume;
6. train at the config's default 16 frames (3137 tokens): 2 steps at
   batch 8, whose visual backward takes the split dq / dkv kernels;
7. data: cv2's video I/O, then a seeded synthetic Ego4D layout (15 s mp4v
   chunks at 512x288, 30 fps, 2048 narration rows) that
   ``avion_tpu_torch.train.pretrain_clip.main`` decodes in its
   ``DataLoader`` workers and trains on at batch 256: 4 steps with host
   crop over every 2nd row (run A; per-step time and data wait from
   ``log.jsonl``, the idle share of the last two steps with their batch
   waits, the gap to phase 5), 2 steps with device crop over every 4th
   row (run B), 24 + 24 launches a step and finite
   losses in both; ``crop_resize_flip_normalize`` on the card against the
   CPU in f32 on one decoded batch of CROP_BATCH clips (max abs error
   1e-3); and a second
   ``main`` on run A's output that restores and trains no step;
8. eval: seeded synthetic layouts of the five zero-shot suites (EK100
   MIR with 32 clips, EK100 CLS, EGTEA with 16, Charades-Ego with 16
   videos, EgoMCQ with 16 items; mp4v at 512x288, 30 fps);
   (a) ``pretrain_clip.main`` with ``eval_freq=1`` and
   the MIR suite, two one-step epochs on the data phase's layout: metrics
   before training and after each epoch, ``is_best`` on the MIR mAP, the
   training model bit-equal across each eval pass; (b)
   ``avion_tpu_torch.eval.validate.main``, strict, at val batch 128 on the
   serve phase's checkpoint: every suite's wall time, clips/s, data-wait
   share and metrics; (c) its ``flash_fwd`` launches equal to 12 per tower
   forward; (d) ``tools.embed_videos`` on 8 clips and 8 sentences against
   the CPU plain path in f32 (cosine >= 0.99); (e) the idle share of one
   profiled MIR sweep and its device time by kind; then the inference
   forward against its plain f32 version at every shape (a) and (b) gave
   it (batch 128 and the ragged last chunks; phase 3's tolerances);
9. videomae: (a) every kernel at VideoMAE's shapes (the encoder's 160
   visible tokens, the decoder's 1568 at width 384, the finetune ViT's
   1568, and the head_dim-128 twins) against its plain f32 version at
   batch 8 (phase 3's tolerances), timed at batch 128 beside its bound and
   SDPA; (b) seeded ``VIDEOMAE_VITB16`` pretraining at 16 frames, batch
   128, with the recipe of ``scripts/examples/videomae_pretrain_k400.sh``
   through ``videomae_pretrain.build_model_and_state`` and ``train.loop``:
   8 steps (16 forward-with-lse, 12 combined, 4 dq and 4 dkv launches a
   step), a profiled step, a batch-2 step against the CPU in f32, an exact
   resume, two ``VIDEOMAE_VITB16_H128`` steps (head_dim 128 launched) and
   an echoed batch whose repeats draw their own tube masks; (c)
   ``videomae_pretrain.main`` on a synthetic Kinetics layout (256 mp4v
   videos at 340x256) at batch 64 for 4 steps: p50 step and data wait,
   the idle share of the last two steps, decode ms a clip, a resume; (d)
   ``videomae_finetune.main`` with the finetune recipe's augmentation on a
   random reference-layout checkpoint (split q / v bias), 2 steps and the
   5 x 3-view test (acc1, acc5; 12 ``flash_fwd`` a forward), then seeded
   finetune steps at batch 128 (12 + 12 + 12 launches a step) and the EMA
   against its formula on the card's parameters, bit for bit;
10. finetune, CLIP ViT-B/16 at 16 frames (3137 visual tokens): (a) every
   kernel at the visual (3137, 12 x 64) and causal text (77, 8 x 64)
   shapes against its plain f32 version at batch 4 (phase 3's
   tolerances), timed at batch 64 beside its bound and SDPA; (b) the
   recipe of ``scripts/examples/finetune_mir_ek100.sh`` at batch 64
   (AdamW, remat) through ``finetune_mir.build_model_and_state`` and
   ``train.loop``: 8 steps on 3 seeded batches (24 forward-with-lse, 12
   combined, 12 dq and 12 dkv launches a step), a profiled step, a batch-2
   step against the CPU in f32 on the first 8 frames of the clips (1569
   tokens, still the split backward) and an exact resume; (c) the same for
   ``scripts/examples/finetune_cls_ek100.sh`` (SGD, lr x 64 / 128, mixup
   0.8, 3806 classes; 12 + 12 + 12 launches a step); (d) a synthetic EK100
   layout (train and test csvs, sentence csvs, relevancy pkls,
   ``actions.csv``; mp4v at 512x288) on which ``finetune_mir.main`` and
   ``finetune_cls.main`` start from the serve phase's checkpoint, take 2
   steps and validate (MIR mAP and ``is_best``; the 2-view test's top-1 and
   verb / noun top-1, 12 ``flash_fwd`` a tower forward), with p50 step,
   data wait and decode ms a clip; (e) 2 seeded steps each of Lion and of
   AdamW with a cosine weight decay to ``wd_end``;
11. contrastive, CLIP ViT-L/14 at 4 frames (1025 visual tokens): (a) every
   kernel at the visual (1025, 16 x 64; split backward, a last tile of one
   row), head_dim-128 (1025, 8 x 128) and causal text (77, 12 x 64)
   shapes, and the forward at 336 px (2305 tokens), against its plain f32
   version at batch 4 (phase 3's tolerances), timed at batch 112 beside
   its bound and SDPA; (b) the recipe of
   ``scripts/examples/pretrain_vitb_ego4d.sh`` with ``CLIP_VITL14`` at the
   global batch 896 (``docs/TRAINING.md``) as 8 cached microbatches of
   112 with bf16 AdamW state, through ``pretrain_clip.
   build_model_and_state``, ``make_step`` and ``train.loop``: 2 seeded
   steps (288 ``flash_fwd``, 288 forward-with-lse, 96 combined, 192 dq and
   192 dkv launches a step), a profiled step, p50, clips/s, share of 989
   TFLOP/s, peak memory; (c) 4 cached microbatches against one step at
   batch 32 on the same weights (loss within 1e-3, gradient cosine >=
   0.99) and pass 1's cached embeddings against pass 2's live ones; (d)
   peak memory with f32 optimizer state; (e) a step of
   ``CLIP_VITL14_H128`` (head_dim 128 launched), 2 of
   ``loss=siglip`` (``logit_bias`` learned) and 2 of ``accum=multistep``
   with ``update_freq=2`` (one update); (f) ``pretrain_clip.main`` on the data phase's layout at
   batch 224 as 2 cached microbatches with bf16 state, 2 steps, and its
   checkpoint restored bit for bit;
12. parallel, the ring hops and the process-group entry: (a) the hop
   instances (the forward with lse, ``bwd_dq`` and ``bwd_kv<dq=0>``, D 64
   and 128) from the build check's lines; (b) the hop kernels against
   their plain f32 versions at ViT-B/16, 16 frames, gap pooling (3136
   tokens) over sp = 4, (16, 784, 12, 64) and (16, 784, 6, 128), with
   k / v from a [B, S, 2W] buffer other than q's and the score bias 0 and
   -1e30 (phase 3's tolerances; a voided hop's gradients exactly 0), timed
   at bias 0 beside the bound and SDPA; (c) the ring over 4 shards of
   (16, 3136, 12, 64) played on the card through the hop ops and the f32
   merge (``ring_attention.run_ring_local``) against the plain f32
   attention over the whole sequence on the same inputs, causal and not:
   out, dq, dk, dv (phase 3's tolerances: max abs 3e-2, RMS 0.5% / 1.5%),
   16 + 16 + 16 hop launches a ring; (d) ``pretrain_clip.main`` at
   ViT-B/16 batch 64, 2 seeded steps, without a
   process group and under a one-rank NCCL group (torchrun's
   environment, ``mesh.data=1 mesh.tensor=1 mesh.dcn_data=1``, DDP),
   under the deterministic flag: the parameters bit for bit, the launches
   by kernel; (e) the same for ``finetune_mir.main``,
   ``finetune_cls.main``, ``videomae_pretrain.main`` and
   ``videomae_finetune.main`` at ViT-B/16, 16 frames, batch 4, 2 steps,
   on the finetune and VideoMAE phases' layouts and checkpoints
   (``mesh.data=1 mesh.fsdp=1``): the logged losses, the final parameters
   (and EMA) bit for bit, every backward on the split kernels;
13. narrator: the kernels at the head_dim-128 decoder's (77, 4 x 128,
   causal) and the generation decoder's (30, 8 x 64, causal, forward
   only) shapes, and at LaViLa's training cell's (LV_KERNEL_SHAPES: the
   divided attention's space mode, 256 x 577 rows, and time mode, 36864 x
   5, forward only; GPT-2 XL's causal self-attention, 64 x 76 at 25 x 64,
   with its backward); (a) seeded ``VCLM_VITB16`` training (ViT-B/16 at 4
   frames, a 12 x 512 causal decoder with gated cross-attention on every
   2nd block) through ``train_narrator.build_model_and_state``,
   ``make_narrator_step`` and ``train.loop``: the config's batch 256 as 2
   calls of 128 averaged by ``optim.accum=multistep`` (one call of 256
   keeps more activations than the card holds), 8 calls on 3 seeded
   batches (24 forward-with-lse and 24 combined launches a call: 12 each
   from the visual tower and 12 from the decoder), p50, clips/s, peak
   memory, a profiled step, the activation bytes a clip keeps; (c) a batch-2 step against the CPU in f32 (loss within
   2%, gradient cosine >= 0.99) and an exact resume; (b) 2 steps at batch
   32 under the deterministic flag, twice from one state: split launches
   only, parameters bit for bit; (e) ``tools.narrator.narrate_video`` with
   ``vclm_captioner`` (bf16 copy, 3 samples of 30 tokens) over one 15 s
   chunk of the data phase's layout: 12 ``flash_fwd`` a generation and
   none in the cached decoder, windows a second, and one generation's
   cached logits against a teacher-forced ``decode`` of its tokens (the
   causal inference kernel; max abs error within 0.15 and RMS error
   within 0.02 of the logits' RMS); (d) ``train_narrator.main`` on the
   layout's first 64 rows at batch 32, 2 steps (p50, data wait, decode
   ms a clip), and a second ``main`` that restores and trains no step;
   (f) the LaViLa narrator ``VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL``
   at full width (2.45 B parameters, seeded random weights, gates
   opened, bf16 inference copy, an ids-only tokenizer) behind
   ``serve.server.make_server(..., narrate=NarrateService(...))``: one
   ``/v1/narrate`` of a 336 px clip (3 samples of up to LV_MAX_LEN
   tokens; latency, tokens a second, peak
   memory; the inference kernel twice a visual block for each sample's
   encode, none in the cached decoder), then a full-width twin with 2 vision
   blocks and 3 decoder layers, teacher-forced, against the CPU in f32
   (cosine >= 0.99);
14. egonlq: the inference kernel at the extractor's shapes (32 windows of
   785 tokens, 12 x 64; one query, 77 tokens, 8 x 64, causal); (a)
   ``egonlq.extract_features.main`` at ``CLIP_VITB16``, 4 frames, batch
   32, on a 120 s NLQ clip (mp4v at 512x288, 30 fps; an Ego4D NLQ clip is
   480 s) with 64 queries in the official json schema: 60 windows in 2
   batches, ``flash_fwd`` launches exactly 12 x 2 + 12 x 64, windows/s,
   decode ms a window, ms a query, the idle share of one profiled window
   batch, peak memory, features (60, 512) and (512,), 2 windows and 2
   queries against the CPU in f32 (cosine >= 0.99); (b)
   ``egonlq.train_nlq.main`` at the ``NLQConfig`` defaults on 1024
   planted-span samples of the extractor's widths (``tests/
   test_nlq_entry.py``'s generator), 2 epochs of 32 steps, evaluated on
   256 of them after each epoch (R@1 / R@5 at IoU 0.3 / 0.5, mIoU, no
   bound): p50 step, queries/s, data wait, the idle share of the last 2
   steps with their batches, peak memory; then one epoch on (a)'s 64
   extracted samples (the widths from the data); (c) one step at batch 8,
   f32, drop 0, card against CPU (loss within 1e-3, gradient cosine >=
   0.999) and a second ``main`` that restores and trains no step; (d)
   ``extract_features.main --legacy`` with the full-width EgoVLP
   FrozenInTime (TimeSformer ViT-B/16, RoBERTa-base, 4096-wide
   projections, 312 M seeded random parameters in the released layout, a
   made-up RoBERTa vocabulary): windows/s, ms a query, peak memory, no
   kernel launched; a twin of 2 video blocks and 2 text layers, card f32
   against CPU f32 (cosine >= 0.99);
15. serve completed, tools: (a) ``tools.convert_checkpoint export`` of
   phase 5's checkpoint directory to the reference ``.pt``, loaded back
   with ``load_clip_checkpoint`` (strict) bit-equal to the saved model,
   and ``import`` of phase 4's ``.pt`` to the JAX package's ``.npz``, read
   back bit-equal; (b) ``serve.server.main`` on the exported ``.pt`` with
   ``--weights int8 --mesh mesh.data=-1 --media-root`` (the data phase's
   Ego4D layout; one replica on one card): 16-clip ``paths`` requests
   (relative paths, one with ``start`` / ``end``) against ``frames_b64``
   of the same clips decoded on the host by ``serve.server.decode_clip``
   (max abs 1e-2), against the CPU f32 plain path on the same weights
   (cosine >= 0.98), 12 ``flash_fwd`` a tower forward and no other
   kernel, 400 for a path that escapes the root and 500 for a missing
   file (the JAX server's codes), the matrices int8 on the card and their
   weight bytes beside phase 4's bf16 service, the p50 of each route
   beside phase 4's bf16 p50 and the host decode ms a clip; (c)
   ``tools.profile_step.main`` at batch 32, 2 traced steps: 24
   ``flash_fwd_kernel`` (forward) and 24 ``bwd_kv_kernel`` (combined
   backward) a step in its rows, device time above 0 and below the wall;
16. drill: ``python -m avion_tpu_torch.tools.e2e_convergence --family
   clip`` as a child process (DRILL_ARGS: the default ``CLIP_VITB16_H128``
   at 4 frames, 224 px; 8 seeded mp4v classes x 16 windows, batch 32, 3
   epochs, SIGTERM once step 6 is logged): the tool trains
   ``pretrain_clip`` in a child, preempts it, relaunches it to the end
   and scores the restored checkpoint on 32 held-out windows against the
   run's fresh init; the phase asks for a resume step above 0, a last
   logged loss below the first, the restored zero-shot top-1 above the
   init's and forward-with-lse, combined-backward and inference launches
   in the children (their counter files, ``AVION_KERNEL_COUNTS``), and
   logs the steps, losses, resume step, top-1 against init, clips/s and
   walls with the card's name and power limit;
17. tensor: (a) the kernels at every shard of TP_BLOCKS (H / t heads at t
   = 2 and 4 where they divide; errors at batch 4, times at the block's
   batch) against their plain versions; (b) ViT-B/16's visual block (32,
   785, 12 x 64) and (8, 3137, 12 x 64), the text block (32, 77, 8 x 64,
   causal) and the H128 block (32, 785, 6 x 128), bf16, whole and with its
   t ranks played on the card (``parallel.tensor_parallel.
   run_block_local``: each rank's heads through the kernels, the
   row-parallel partials summed): output (max abs error over the largest
   value 3e-2, RMS 0.5%), the gradients of x and of every weight (3e-2,
   1.5% RMS), the launches, and the
   split block's, the whole block's, a shard's attention and the whole
   attention's ms.  Phase 12 (d) passes ``mesh.tensor=1
   mesh.dcn_data=1``, so the new mesh and group code runs there, alone
   and under the one-rank NCCL group;
18. experts and pipeline: (a) ``pretrain_clip.main`` with
   ``model.moe_experts=8`` (CLIP_VITB16, batch 32, 2 steps on the data
   phase's layout, a one-rank NCCL group, no checkpoint written): 24
   forward-with-lse and 24 combined launches a step, finite loss,
   ``moe_aux`` and ``moe_overflow``, ``moe_load_max`` at most 1; the MoE
   layer's router, dispatch, expert products and combine timed beside
   their bounds; (b) ``ops.moe.run_experts_local`` at ep = 2, 4, (c)
   CLIP_VITB16's pipelined tower at pp = 2, 4 (M = 8, with and without
   remat), (d) VCLM_VITB16's pipelined decoder at pp = 2, 3 (pp = 4
   refused) and (e) LaViLa's gated GPT-2 at XL width, 6 layers, pp = 2,
   their ranks played on the card (``parallel.pipeline.
   run_stages_local``) against the whole module: output and gradients
   (phase 17's bounds), the launches;
19. tools: each tool of ``avion_tpu_torch.tools`` that drives a path
   through the kernels (``bench_attention``, ``mxu_roofline``,
   ``bench_vitl``, ``bench_videomae``, ``bench_pipeline``,
   ``bench_serve``, ``headdim_ablation``) and ``bench_narrator`` (plain
   attention: no kernel), through its ``main`` at a small size, the
   launch counters set to 0 before each and read after: each tool but
   the narrator's launched every kernel of its path, and its JSON line
   carries the JAX tool's keys.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import base64
import contextlib
import csv
import glob
import json
import math
import os
import pickle
import queue
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from avion_tpu_torch.core import profiling
from avion_tpu_torch.core.flops import H100_BYTES_PER_S
from avion_tpu_torch.core.flops import H100_PEAK_FLOPS as H100_BF16_FLOPS
from avion_tpu_torch.core.flops import attention_bound as bound
from avion_tpu_torch.core.flops import attn_flops
from avion_tpu_torch.ops import _build
from avion_tpu_torch.ops import activation as act
from avion_tpu_torch.ops import flash_attention as fa

# cuBLAS is deterministic under torch.use_deterministic_algorithms only with
# a fixed workspace, set before its first use (H100's default size)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

TOL = 3e-2  # max abs error, the JAX bf16 forward tolerance
# RMS error over RMS output.  With randn q/k/v an output row averages ~S
# rows of v, so a typical output is ~sqrt(e/S): 0.03 at S=3137, as large as
# TOL.  The relative bound is what holds the visual shapes: a kernel that
# let the zero-filled keys of the ragged last tile into the softmax would
# be off by ~1.2% (S=3137) to ~3.5% (S=785) of every output.
REL_TOL = 5e-3
# (batch, seq, heads, head_dim, causal): the visual tower at 4 frames and
# at the default 16, the text tower, and the head_dim-128 geometry
KERNEL_SHAPES = [(32, 785, 12, 64, False), (32, 77, 8, 64, True),
                 (4, 3137, 12, 64, False), (32, 785, 6, 128, False)]
# the backward at the same shapes (route by the dispatch rule: combined up
# to S = 1024, split at 3137), and the main shape once more with the split
# kernels forced
BWD_SHAPES = [(32, 785, 12, 64, False, None), (32, 77, 8, 64, True, None),
              (4, 3137, 12, 64, False, None), (32, 785, 6, 128, False, None),
              (32, 785, 12, 64, False, False)]
# lse (log2 units) against the plain f32 forward: the kernel rounds the
# scaled q to bf16, a score error of ~1.6e-3 RMS; a causal row with one key
# carries one score's whole error, up to ~1e-2 (PERF.md)
LSE_TOL = 3e-2
# dq, dk, dv: RMS error over RMS reference.  A backward without the delta
# term is off by ~5% in dq and dk (PERF.md)
BWD_REL_TOL = 1.5e-2
# the MLP's hidden tensor of CLIP_VITB16's visual tower in the MIR
# finetune: 64 clips of 3137 tokens, 4 x 768 wide
ACT_SHAPE = (64 * 3137, 3072)
ACT_TOL = 2.0 ** -8  # one bf16 ulp, relative
MODEL, FRAMES, BATCH, SIZE = "CLIP_VITB16", 4, 32, 224
# the recipe of scripts/examples/pretrain_vitb_ego4d.sh at one card's share
# of its global batch 2048 over the reference's 8 cards; with 8 steps per
# epoch its one warmup epoch spans the whole run
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SEEDS = 256, 8, (0, 1, 2)
TRAIN_RECIPE = [f"model.name={MODEL}", f"data.clip_length={FRAMES}",
                f"data.batch_size={TRAIN_BATCH}", f"data.crop_size={SIZE}",
                "model.use_grad_checkpointing=true", "optim.optimizer=adamw",
                "optim.lr=4e-5", "optim.wd=0.05", "optim.betas=0.9,0.999",
                "optim.warmup_epochs=1", "optim.epochs=5",
                "optim.grad_clip_norm=1.0", "print_freq=1"]
POLICY_BATCH, REF_BATCH = 8, 2
# the config's default clip length (3137 tokens), where the backward splits
LONG_FRAMES, LONG_BATCH, LONG_STEPS = 16, 8, 2
LAYERS = 12  # attention layers per tower of CLIP_VITB16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return profiling.card_line(torch.device("cuda"))


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside the block: every
    flash backward takes the split kernels, whose sums run in a fixed
    order."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    return profiling.device_ms(fn, torch.device("cuda"), iters, warmup)


def phase_environment() -> str:
    log("== environment")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = card_line()
    log(card)
    log(f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    from avion_tpu_torch.data import video_reader

    marker = video_reader.LIB_PATH + ".failed"
    first_use = ("loaded the library" if os.path.exists(video_reader.LIB_PATH)
                 else "marker stood" if os.path.exists(marker)
                 else "build attempt")
    t0 = time.perf_counter()
    backend = video_reader.default_backend()
    log(f"decode backend {backend}, first use ({first_use}) "
        f"{time.perf_counter() - t0:.3f} s, failure marker now "
        f"{os.path.exists(marker)}")
    # the loaders' forkserver imports this script while the kernels build
    from avion_tpu_torch.data.loader import start_forkserver

    start_forkserver()
    return card


def phase_build() -> None:
    """Both kernel sources, one nvcc each, started together; then the
    backward's resources (ptxas) and instructions (SASS)."""
    log("== build")
    t0 = time.perf_counter()
    sources = (fa.SOURCE, fa.BWD_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.library, sources))
    log(f"built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s")
    bad = [f for source, instances in ((fa.SOURCE, 8), (fa.BWD_SOURCE, 12))
           for f in check_build(source, instances)]
    if bad:
        raise RuntimeError(f"build check failed: {bad}")


# flash_fwd_kernel<D, causal, lse>, bwd_kv_kernel<D, causal, dq> and
# bwd_dq_kernel<D, causal>, mangled
INSTANCE = re.compile(r"(flash_fwd_kernel|bwd_kv_kernel|bwd_dq_kernel)"
                      r"ILi(\d+)ELb([01])E(?:Lb([01])E)?")
# a per-element f32 atomic on global memory (the bulk reduce is UBLKRED)
F32_ATOMIC = re.compile(r"\b(?:RED|ATOMG?)\.\S*F32")


def _instance(mangled: str):
    """(label, whether it is a combined-backward instance) or None."""
    m = INSTANCE.search(mangled)
    if m is None:
        return None
    kind, d, causal, flag = m.groups()
    if kind == "bwd_dq_kernel":
        return f"bwd_dq_kernel<{d}, causal={causal}>", False
    if kind == "flash_fwd_kernel":
        return f"flash_fwd_kernel<{d}, causal={causal}, lse={flag}>", False
    return f"bwd_kv_kernel<{d}, causal={causal}, dq={flag}>", flag == "1"


# ptxas: "(C7520) Potential Performance Loss: wgmma.mma_async instructions
# are serialized due to ... in the function '<mangled>'"
SERIALIZED = re.compile(
    r"wgmma\.mma_async instructions are serialized.*?function '([^']+)'")


def serialized_instances(ptxas: str) -> set:
    """Labels of the instances whose wgmma ptxas serialized."""
    return {_instance(m)[0] for m in SERIALIZED.findall(ptxas)
            if _instance(m)}


# every instance's build-check line, for phase_parallel (a)
_BUILD_LINES: list = []


def check_build(source: str, instances: int) -> list:
    """Every kernel instance of ``source``'s library: registers and spills
    from ptxas (0 spill bytes, no wgmma serialized), and in its SASS wgmma
    (HGMMA) and TMA loads (UTMALDG); a combined-backward instance adds dq
    by bulk reduce (UBLKRED) with no per-element f32 atomics.  Returns the
    failing instances."""
    if source not in _build.build_logs:  # loaded from an earlier build
        _build._compile(source, _build._lib_path(source))
    ptxas = _build.build_logs[source]
    stats = {}
    for block in ptxas.split("Compiling entry function '")[1:]:
        name = _instance(block.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        if name and regs and spill:
            stats[name[0]] = (int(regs.group(1)), int(spill.group(1))
                              + int(spill.group(2)))
    serialized = serialized_instances(ptxas)
    lib = _build._lib_path(source)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    bad, seen = [], 0
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = _instance(func.split("\n", 1)[0])
        if name is None:
            continue
        seen += 1
        label, combined = name
        counts = {op: len(re.findall(rf"\b{op}\b", func))
                  for op in ("HGMMA", "UTMALDG", "UBLKRED")}
        counts["f32 RED/ATOM"] = len(F32_ATOMIC.findall(func))
        regs, spills = stats.get(label, (None, None))
        line = (f"{label}: {regs} registers at launch (setmaxnreg: producer "
                f"24, consumers 232), {spills} spill bytes, wgmma serialized "
                f"{label in serialized}; SASS {counts}")
        _BUILD_LINES.append(line)
        log("  " + line)
        if (not (counts["HGMMA"] and counts["UTMALDG"]) or spills != 0
                or label in serialized):
            bad.append(label)
        if combined and (not counts["UBLKRED"] or counts["f32 RED/ATOM"]):
            bad.append(label + " (dq)")
    if seen != instances:
        bad.append(f"{source}: {seen} of {instances} instances seen")
    return bad


def _errors(got: torch.Tensor, ref: torch.Tensor):
    diff = got.float() - ref
    return diff.abs().max().item(), (diff.norm() / ref.norm()).item()


def _sdpa_inputs(qkv, b, s, h, d):
    q, k, v = qkv.view(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
    return q, k, v


def phase_kernel() -> dict:
    """Every kernel against its plain f32 version; returns rows by kernel."""
    log(f"== kernel: each kernel (bf16) against its plain f32 version; "
        f"out: max abs err <= {TOL}, rms err / rms out <= {REL_TOL}; lse: "
        f"max abs err <= {LSE_TOL} (log2 units); dq, dk, dv: max abs err <= "
        f"{TOL}, rms err / rms ref <= {BWD_REL_TOL}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {name: [] for name in fa.KERNELS}
    bad = []

    def check(name, shape, **errs):
        for key, (err, limit) in errs.items():
            if not err <= limit:  # NaN fails too
                bad.append(f"{name} {shape}: {key} {err} > {limit}")

    for b, s, h, d, causal in KERNEL_SHAPES:
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        scale = d ** -0.5
        shape = [b, s, h, d]
        flops = attn_flops(b, s, h, d, causal, 2)
        q, k, v = _sdpa_inputs(qkv, b, s, h, d)
        sdpa_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
        ref, lse_ref = fa.flash_fwd_lse_plain(qkv.float(), h, s, causal,
                                              scale)
        # inference forward
        fa.reset_launches()
        out = fa.flash_attention_fused_qkv(qkv, h, s, causal=causal)
        torch.cuda.synchronize()
        if dict(fa.launches) != {"flash_fwd": 1}:
            raise RuntimeError(f"flash_fwd launches {dict(fa.launches)}")
        err, rel = _errors(out, ref)
        check("flash_fwd", shape, max_abs_err=(err, TOL),
              rel_rms_err=(rel, REL_TOL))
        row = {"shape": shape, "causal": causal, "max_abs_err": err,
               "rel_rms_err": rel, "out_rms": ref.pow(2).mean().sqrt().item(),
               **_forward_times(lambda: fa.flash_attention_fused_qkv(
                   qkv, h, s, causal=causal), flops),
               "plain_ms": cuda_ms(lambda: fa.flash_attention_fused_qkv_plain(
                   qkv, h, s, causal=causal), iters=5),
               "library_ms": sdpa_ms}
        row["bound_ms"], row["bound_by"] = bound(b, s, h, d, causal)
        rows["flash_fwd"].append(row)
        log("flash_fwd " + json.dumps(row))
        # training forward, with lse
        fa.reset_launches()
        out, lse = fa.flash_fwd_lse(qkv, h, s, causal, scale)
        torch.cuda.synchronize()
        if dict(fa.launches) != {"flash_fwd_lse": 1}:
            raise RuntimeError(f"flash_fwd_lse launches {dict(fa.launches)}")
        err, rel = _errors(out, ref)
        lse_err = (lse - lse_ref).abs().max().item()
        check("flash_fwd_lse", shape, max_abs_err=(err, TOL),
              rel_rms_err=(rel, REL_TOL), lse_max_abs_err=(lse_err, LSE_TOL))
        row = {"shape": shape, "causal": causal, "max_abs_err": err,
               "rel_rms_err": rel, "lse_max_abs_err": lse_err,
               **_forward_times(lambda: fa.flash_fwd_lse(
                   qkv, h, s, causal, scale), flops),
               "plain_ms": cuda_ms(lambda: fa.flash_fwd_lse_plain(
                   qkv, h, s, causal, scale), iters=5),
               "library_ms": sdpa_ms}
        row["bound_ms"], row["bound_by"] = bound(b, s, h, d, causal, rows=1)
        rows["flash_fwd_lse"].append(row)
        log("flash_fwd_lse " + json.dumps(row))

    for b, s, h, d, causal, combined in BWD_SHAPES:
        fa._COMBINED_BWD = combined
        try:
            _check_backward(gen, rows, check, b, s, h, d, causal)
        finally:
            fa._COMBINED_BWD = None
    _deterministic_backward(gen)
    if bad:
        raise RuntimeError("kernels disagree with their plain versions: "
                           + "; ".join(bad))
    return rows


def phase_activation() -> dict:
    """The QuickGELU kernels at ACT_SHAPE against the formula in f32,
    timed beside their bytes bound and the plain chain; returns each
    kernel's row."""
    log(f"== activation: QuickGELU at {list(ACT_SHAPE)} bf16 against the "
        f"formula in f32; max abs err / max |ref| and rms err / rms ref <= "
        f"{ACT_TOL}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(ACT_SHAPE, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    dy = torch.randn(ACT_SHAPE, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    # each [tokens, 3072] bf16 tensor read or written once
    pass_bytes = x.numel() * x.element_size()
    bad, rows = [], {}
    xr = x.detach().requires_grad_()
    chain = act.quick_gelu_plain(xr)
    plain = {"quick_gelu_fwd": lambda: act.quick_gelu_plain(x),
             "quick_gelu_bwd": lambda: torch.autograd.grad(
                 chain, xr, dy, retain_graph=True)}
    kernel = {"quick_gelu_fwd": lambda: act.quick_gelu_op(x),
              "quick_gelu_bwd": lambda: act.quick_gelu_bwd(x, dy)}
    xf, dyf = x.float(), dy.float()
    s = torch.sigmoid(act.ALPHA * xf)
    refs = {"quick_gelu_fwd": xf * s,
            "quick_gelu_bwd": dyf * s * (1 + act.ALPHA * xf * (1 - s))}
    del s
    for name, passes in (("quick_gelu_fwd", 2), ("quick_gelu_bwd", 3)):
        act.reset_launches()
        got = kernel[name]()
        torch.cuda.synchronize()
        if dict(act.launches) != {name: 1}:
            raise RuntimeError(f"{name} launches {dict(act.launches)}")
        ref = refs.pop(name)
        diff = got.float() - ref
        err = (diff.abs().max() / ref.abs().max()).item()
        rel = (diff.norm() / ref.norm()).item()
        del got, diff, ref
        for key, value in (("max_abs_err", err), ("rel_rms_err", rel)):
            if not value <= ACT_TOL:  # NaN fails too
                bad.append(f"{name}: {key} {value} > {ACT_TOL}")
        bound_ms = passes * pass_bytes / H100_BYTES_PER_S * 1e3
        ms = cuda_ms(kernel[name])
        rows[name] = {
            "shape": list(ACT_SHAPE), "dtype": "bfloat16",
            "max_abs_err": err, "rel_rms_err": rel, "kernel_ms": ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": bound_ms / ms, "plain_ms": cuda_ms(plain[name]),
            "library_ms": None}
        log(f"{name} " + json.dumps(rows[name]))
    if bad:
        raise RuntimeError("QuickGELU kernels disagree with the formula: "
                           + "; ".join(bad))
    return rows


DET_SHAPE = (32, 785, 12, 64)  # a combined-route shape: ViT-B/16, 4 frames


def _deterministic_backward(gen) -> dict:
    """Under ``torch.use_deterministic_algorithms(True)``: two autograd
    backwards at DET_SHAPE, bit-equal in dq, dk and dv, each launching the
    split dq and dkv kernels and no combined one; the backward's time on
    the flag's route against the default (combined) route's, the same
    inputs."""
    b, s, h, d = DET_SHAPE
    w, scale = h * d, d ** -0.5
    qkv = torch.randn(b, s, 3 * w, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    do = torch.randn(b, s, w, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    out, lse = fa.flash_fwd_lse(qkv, h, s, False, scale)

    def bwd():
        return fa.flash_bwd(do, qkv, out, lse, h, s, False, scale)

    default_ms = cuda_ms(bwd)
    grads, launches = [], []
    with deterministic():
        for _ in range(2):
            x = qkv.detach().requires_grad_()
            fa.reset_launches()
            fa.flash_attention_fused_qkv(x, h, s).backward(do)
            torch.cuda.synchronize()
            launches.append(dict(fa.launches))
            grads.append(x.grad)
        flag_ms = cuda_ms(bwd)
    same = torch.equal(grads[0], grads[1])
    want = {"flash_fwd_lse": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    row = {"shape": [b, s, h, d], "bit_equal": same, "launches": launches,
           "default_route_ms": default_ms, "flag_route_ms": flag_ms,
           "flag_over_default": flag_ms / default_ms}
    log("deterministic backward " + json.dumps(row))
    if not same or launches != [want, want]:
        raise RuntimeError(f"the backward under the deterministic flag: "
                           f"bit-equal {same}, launches {launches}")
    return row


def _forward_times(fn, flops: float) -> dict:
    """A forward's time through the wrapper (CUDA events), its device time
    (torch.profiler: the host's checks, allocations, tensor map and launch
    are not in it) and the TFLOP/s of each."""
    kernel_ms = cuda_ms(fn)
    device_ms = sum(_device_ms_by_kernel(fn).values())
    return {"kernel_ms": kernel_ms, "device_ms": device_ms,
            "tflops": flops / kernel_ms / 1e9,
            "device_tflops": flops / device_ms / 1e9 if device_ms else None}


def _check_backward(gen, rows, check, b, s, h, d, causal):
    """The backward's route at this shape against the plain f32 backward
    of the plain f32 forward, with a seeded randn output gradient."""
    w, scale = h * d, d ** -0.5
    shape = [b, s, h, d]
    qkv = torch.randn(b, s, 3 * w, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    do = torch.randn(b, s, w, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    out, lse = fa.flash_fwd_lse(qkv, h, s, causal, scale)
    route = "combined" if fa.use_combined_bwd(s) else "split"
    names = (["flash_bwd_combined"] if route == "combined"
             else ["flash_bwd_dq", "flash_bwd_dkv"])
    fa.reset_launches()
    got = fa.flash_bwd(do, qkv, out, lse, h, s, causal, scale)
    torch.cuda.synchronize()
    if dict(fa.launches) != {n: 1 for n in names}:
        raise RuntimeError(f"{route} backward launches {dict(fa.launches)}")
    out_p, lse_p = fa.flash_fwd_lse_plain(qkv.float(), h, s, causal, scale)
    ref = fa.flash_bwd_plain(do.float(), qkv.float(), out_p, lse_p, h, s,
                             causal, scale)
    errs = {}
    for i, sec in enumerate(("dq", "dk", "dv")):
        err, rel = _errors(got[..., i * w:(i + 1) * w],
                           ref[..., i * w:(i + 1) * w])
        errs[sec] = {"max_abs_err": err, "rel_rms_err": rel}
        check(f"{route} backward", shape, **{
            f"{sec}_max_abs_err": (err, TOL),
            f"{sec}_rel_rms_err": (rel, BWD_REL_TOL)})
    del ref, out_p, lse_p
    # run to run: the combined route sums dq's shares by bulk reduce-add,
    # in an order that varies
    spread = (fa.flash_bwd(do, qkv, out, lse, h, s, causal, scale).float()
              - got.float()).abs()
    q, k, v = (t.detach().requires_grad_() for t in
               _sdpa_inputs(qkv, b, s, h, d))
    do_h = do.view(b, s, h, d).transpose(1, 2)

    def sdpa_fwd_bwd():
        o = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal)
        torch.autograd.grad(o, (q, k, v), do_h)

    with torch.no_grad():
        sdpa_fwd = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
    row = {"shape": shape, "causal": causal, "route": route, **errs,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "dq_run_to_run_max_abs": spread[..., :w].max().item(),
           "dq_run_to_run_share_differing":
               (spread[..., :w] > 0).float().mean().item(),
           "dkv_run_to_run_max_abs": spread[..., w:].max().item(),
           "kernel_ms": cuda_ms(lambda: fa.flash_bwd(
               do, qkv, out, lse, h, s, causal, scale)),
           "plain_ms": cuda_ms(lambda: fa.flash_bwd_plain(
               do, qkv, out, lse, h, s, causal, scale), iters=3),
           # SDPA's backward alone: its forward + backward less its forward
           "library_ms": cuda_ms(sdpa_fwd_bwd) - sdpa_fwd,
           "device_ms_by_kernel": _device_ms_by_kernel(
               lambda: fa.flash_bwd(do, qkv, out, lse, h, s, causal, scale))}
    # rowsum(dO * O) for the combined and dkv kernels (the dq kernel makes
    # its own rows' inside)
    row["delta_ms"] = sum(ms for name, ms in row["device_ms_by_kernel"].items()
                          if "delta_kernel" in name)
    if route == "combined":
        row["bound_ms"], row["bound_by"] = bound(
            b, s, h, d, causal, products=5, tensors=8, rows=2)
        row["tflops"] = attn_flops(b, s, h, d, causal, 5) / row["kernel_ms"] / 1e9
        rows["flash_bwd_combined"].append(row)
        log("flash_bwd_combined " + json.dumps(row))
        return
    # the split route: 7 products; each split kernel alone: q, k, v, do
    # (and out) read, its sections written, lse (and delta) read
    row["split_route_tflops"] = (attn_flops(b, s, h, d, causal, 7)
                                 / row["kernel_ms"] / 1e9)
    for name, part, products, tensors, nrows in (
            ("flash_bwd_dq", "dq", 3, 6, 1), ("flash_bwd_dkv", "dkv", 4, 6, 2)):
        r = dict(row, split_route_ms=row["kernel_ms"],
                 kernel_ms=cuda_ms(lambda: fa._bwd_cuda(
                     do, qkv, out, lse, h, s, causal, scale, route=part)))
        r["bound_ms"], r["bound_by"] = bound(b, s, h, d, causal, products,
                                             tensors, nrows)
        r["tflops"] = (attn_flops(b, s, h, d, causal, products)
                       / r["kernel_ms"] / 1e9)
        rows[name].append(r)
        log(f"{name} " + json.dumps(r))


def _device_ms_by_kernel(fn, calls: int = 3) -> dict:
    """Device time of one call of ``fn`` by kernel name (torch.profiler),
    after a warm-up call: each name's time summed over its launches within
    a call, then the median over ``calls`` calls, each profiled alone."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in _device_events(prof):
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + \
                e.time_range.elapsed_us() / 1e3
        per_call.append(by_name)
    names = {name for by_name in per_call for name in by_name}
    return {name: float(np.median([c.get(name, 0.0) for c in per_call]))
            for name in names}


def random_checkpoint(path: str, seed: int = 0) -> None:
    """A seeded random ``CLIP_VITB16`` state dict in the reference layout
    (what ``export_clip_to_pt`` writes), saved as ``{"state_dict": ...}``."""
    from avion_tpu_torch.models.registry import create_model

    with torch.device("meta"):
        shapes = {k: v.shape for k, v in create_model(
            MODEL, num_frames=FRAMES).state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in shapes.items():
        noise = torch.randn(shape, generator=gen)
        if k == "logit_scale":
            sd[k] = torch.tensor(math.log(1 / 0.07))
        elif ".ln_" in k:
            sd[k] = noise * 0.02 + (1.0 if k.endswith("weight") else 0.0)
        elif "embedding" in k or len(shape) == 1:
            sd[k] = noise * 0.02
        else:  # dense weights, conv1, projections: fan-in scaling
            fan_in = shape[0] if k.endswith("projection") else \
                math.prod(shape[1:])
            sd[k] = noise * fan_in ** -0.5
    torch.save({"state_dict": sd}, path)


def _post(url: str, path: str, obj: dict):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
    return body, time.perf_counter() - t0


def _get(url: str, path: str) -> dict:
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


def _frames(clips: np.ndarray) -> dict:
    return {"frames_b64": base64.b64encode(clips.tobytes()).decode(),
            "shape": list(clips.shape)}


def _unit_rows(name: str, arr, n: int, dim: int = 512) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if arr.shape != (n, dim) or not np.isfinite(arr).all():
        raise RuntimeError(f"{name}: bad embeddings {arr.shape}")
    norms = np.linalg.norm(arr, axis=-1)
    if np.abs(norms - 1).max() > 1e-3:
        raise RuntimeError(f"{name}: norms {norms}")
    return arr


def profile_request(url: str, clips: np.ndarray, requests: int = 5) -> None:
    """Wall time, device time and the card's idle share of ``requests``
    /v1/embed/video requests, each profiled alone (torch.profiler), and
    the median request's device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for _ in range(requests):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = _post(url, "/v1/embed/video", _frames(clips))[1] * 1e3
            torch.cuda.synchronize()
        by_name = _device_ms_by_name(prof)
        runs.append((sum(by_name.values()), wall, by_name))
    if not runs[0][0]:
        log("profile: the profiler saw no device time (not measured)")
        return
    for busy, wall, _ in runs:
        log(f"profile of one {len(clips)}-clip request: wall {wall:.2f} ms, "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.4f}")
    busy, wall, by_name = sorted(runs, key=lambda r: r[0])[requests // 2]
    log(f"median device busy {busy:.3f} ms of {requests} requests; by kernel:")
    log_device_time(by_name, top=8)


def phase_serve(tmp: str) -> dict:
    """Returns the kernel launches of the served main path, the p50 of its
    16-clip video requests and the served model's weight bytes."""
    from avion_tpu_torch.models.pt_import import load_clip_checkpoint
    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.serve.server import main

    log(f"== serve {MODEL} at {FRAMES} frames, batch {BATCH}")
    ckpt = os.path.join(tmp, "clip_vitb16_random.pt")
    t0 = time.perf_counter()
    random_checkpoint(ckpt)
    log(f"random checkpoint written in {time.perf_counter() - t0:.1f} s")

    ready: queue.Queue = queue.Queue()
    errors: list = []

    def run():
        try:
            main([f"model.name={MODEL}", f"data.clip_length={FRAMES}",
                  f"data.val_batch_size={BATCH}", f"pretrain_model={ckpt}",
                  "--port", "0"], on_ready=ready.put)
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller
            errors.append(e)
            ready.put(None)

    th = threading.Thread(target=run, name="serve-main")
    th.start()
    server = ready.get(timeout=600)
    if server is None:
        raise RuntimeError("server failed to start") from errors[0]
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = _get(url, "/health")
        log(f"health {health}")
        if health["platform"] != "gpu":
            raise RuntimeError(f"not serving on the GPU: {health}")
        rs = np.random.RandomState(0)
        clips = rs.randint(0, 256, (16, FRAMES, SIZE, SIZE, 3), np.uint8)
        texts = ["#C C cuts an onion", "#C C opens the fridge",
                 "a person washes the dishes"]
        labels = ["cut onion", "open fridge", "wash dishes"]
        _post(url, "/v1/embed/video", _frames(clips[:2]))  # warm up
        _post(url, "/v1/embed/text", {"texts": texts[:1]})

        # the main path, with the launch count set to 0 just before
        before = _get(url, "/metrics")["encoder"]
        fa.reset_launches()
        text_emb = _post(url, "/v1/embed/text", {"texts": texts})[0]
        video_emb, lat = [], []
        for _ in range(6):
            body, dt = _post(url, "/v1/embed/video", _frames(clips))
            video_emb.append(body["embeddings"])
            lat.append(dt)
        sim = _post(url, "/v1/similarity",
                    dict(_frames(clips[:4]), texts=texts))[0]
        cls = _post(url, "/v1/classify",
                    dict(_frames(clips[:2]), labels=labels))[0]
        launches = fa.launches["flash_fwd"]
        if set(fa.launches) != {"flash_fwd"}:
            raise RuntimeError(f"serving launched {dict(fa.launches)}")
        after = _get(url, "/metrics")["encoder"]
        weight_bytes = after["replicas"][0]["weight_bytes"]
        profile_request(url, clips)
    finally:
        server.shutdown()
        th.join(timeout=120)
    if th.is_alive():
        raise RuntimeError("server thread did not stop")
    if errors:
        raise errors[0]

    calls = {k: after[k] - before[k] for k in ("image_calls", "text_calls")}
    log(f"tower forwards {calls}, kernel launches {launches}")
    if min(calls.values()) < 1 or launches != LAYERS * sum(calls.values()):
        raise RuntimeError(f"{launches} launches for {calls} tower forwards; "
                           f"expected {LAYERS} per forward")
    t_emb = _unit_rows("text", text_emb["embeddings"], len(texts))
    v_emb = [_unit_rows("video", e, len(clips)) for e in video_emb]
    if max(np.abs(e - v_emb[0]).max() for e in v_emb) > 1e-2:
        raise RuntimeError("repeated video requests disagree")
    logits = np.asarray(sim["logits"])
    if logits.shape != (4, len(texts)) or not np.isfinite(logits).all():
        raise RuntimeError(f"similarity: bad logits {logits.shape}")
    probs = np.asarray(cls["probs"])
    if probs.shape != (2, len(labels)) or np.abs(probs.sum(-1) - 1).max() > 1e-4:
        raise RuntimeError(f"classify: bad probabilities {probs}")
    lat_ms = sorted(x * 1e3 for x in lat)
    p50 = lat_ms[len(lat) // 2]
    log(f"video requests of {len(clips)} clips: p50 {p50:.1f}"
        f" ms, {len(clips) * len(lat) / sum(lat):.1f} clips/s end to end; "
        f"bf16 weights {weight_bytes} bytes")

    log("== reference: the same weights on the CPU, plain path, f32")
    model = create_model(MODEL, num_frames=FRAMES, dtype=torch.float32)
    load_clip_checkpoint(model, ckpt)
    from avion_tpu_torch.data.tokenizer import tokenize
    from avion_tpu_torch.data.transforms import normalize_video

    with torch.inference_mode():
        ref_v = model.encode_image(normalize_video(
            torch.from_numpy(clips[:2]), dtype=torch.float32)).numpy()
        ref_t = model.encode_text(
            torch.from_numpy(tokenize(texts[:2])).long()).numpy()
    cos_v = (ref_v * v_emb[0][:2]).sum(-1)
    cos_t = (ref_t * t_emb[:2]).sum(-1)
    log(f"cosine to the CPU reference: video {cos_v}, text {cos_t}")
    if min(cos_v.min(), cos_t.min()) < 0.99:
        raise RuntimeError("served embeddings disagree with the CPU reference")
    return {"launches": launches, "p50_ms": p50, "weight_bytes": weight_bytes}


def _train_config(out_dir: str, *overrides: str, recipe=None):
    """``recipe`` (default TRAIN_RECIPE), then ``output_dir``, then the
    overrides."""
    from avion_tpu_torch.core.config import TrainConfig

    return TrainConfig().apply_overrides(
        [*(recipe or TRAIN_RECIPE), f"output_dir={out_dir}", *overrides])


def _train_batches(n: int, batch: int, frames: int) -> list:
    """Seeded batches in the VideoCaptionDataset collate contract: crop-size
    uint8 clips and token ids with an end-of-text token."""
    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        text = rng.integers(1, 49405, (batch, 77), dtype=np.int32)
        text[:, 0] = 49406
        text[np.arange(batch), rng.integers(5, 77, batch)] = 49407
        out.append({"video": rng.integers(0, 256, (batch, frames, SIZE, SIZE,
                                                   3), dtype=np.uint8),
                    "text": text})
    return out


def _to_device(batch: dict) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _model_flops(model, batch: int) -> float:
    """6 x parameters x tokens for each tower (the token-embedding table is
    a lookup and counts no flops) plus 12 B H S^2 D per attention layer
    (its forward's two products and the backward's four).  A classifier
    counts its visual tower (``fc_cls`` on the pooled vector left out)."""
    v = model.visual
    frames = 1 if v.temporal_embedding is None else \
        v.temporal_embedding.shape[0]
    s_v = (v.positional_embedding.shape[0] - 1) * frames + 1
    towers = [(v, s_v, sum(p.numel() for p in v.parameters()))]
    if hasattr(model, "textual"):
        t = model.textual
        towers[0] = (v, s_v, towers[0][2] + model.image_projection.numel())
        towers.append((t, t.positional_embedding.shape[0],
                       sum(p.numel() for n, p in t.named_parameters()
                           if not n.startswith("token_embedding"))
                       + model.text_projection.numel()))
    flops = 0
    for tower, s, params in towers:
        flops += 6 * params * batch * s
        for blk in tower.transformer.resblocks:
            width = blk.attn.Wqkv.in_features
            flops += 12 * batch * s * s * width
    return flops


# device kernels by kind, first match wins
KERNEL_GROUPS = (
    ("flash attention (this repo)", ("flash_fwd_kernel", "bwd_kv_kernel",
                                     "bwd_dq_kernel", "dq_convert_kernel",
                                     "delta_kernel")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("LayerNorm", ("layer_norm",)),
    ("optimizer (foreach / multi-tensor)", ("multi_tensor", "foreach")),
    ("host-device copies", ("Memcpy HtoD", "Memcpy DtoH")),
    ("copies and casts", ("copy", "Memcpy", "Memset")),
)


def _device_events(prof) -> list:
    """A profile's kernels and copies on the card, without the
    ``record_function`` ranges mirrored onto its timeline
    (``gpu_user_annotation``): such a range covers kernels already
    counted and the gaps between them."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _device_ms_by_name(prof) -> dict:
    """A profile's device time (ms) by kernel or copy name."""
    by_name: dict = {}
    for e in _device_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    return by_name


def log_device_time(by_name: dict, top: int = 15) -> None:
    """Logs device time by KERNEL_GROUPS, then the ``top`` names."""
    total = sum(by_name.values())
    groups: dict = {}
    for name, ms in by_name.items():
        group = next((g for g, keys in KERNEL_GROUPS if any(
            k in name for k in keys)), "other elementwise and reductions")
        groups[group] = groups.get(group, 0.0) + ms
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:9.3f} ms  {ms / total:6.1%}  [{group}]")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {ms:9.3f} ms  {ms / total:6.1%}  {name[:100]}")


def profile_step(run, batch: dict) -> dict:
    """Device busy time and idle share of one train step, by kernel;
    returns ``{"wall_ms", "busy_ms", "idle_share"}`` (empty when the
    profiler saw no device time).  Only the card's activity is recorded:
    the host's ops, which nothing here reads, are most of the events of a
    batch-896 step and of the profiler's time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.state, _ = run.step(run.state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = _device_ms_by_name(prof)
    busy = _device_busy_ms(prof)
    if not busy:
        log("profile: the profiler saw no device time (not measured)")
        return {}
    log(f"profile of one train step: wall {wall:.2f} ms, device busy "
        f"{busy:.3f} ms, idle share {1 - busy / wall:.4f}")
    log_device_time(by_name)
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall}


def _policy_forwards(tmp: str, policy: str, batch: dict) -> int:
    """Forward-with-lse launches of one train step under ``policy``."""
    from avion_tpu_torch.train.loop import setup_run
    from avion_tpu_torch.train.pretrain_clip import build_model_and_state
    from avion_tpu_torch.train.steps import make_clip_train_step

    cfg = _train_config(os.path.join(tmp, policy),
                        f"model.remat_policy={policy}",
                        f"data.batch_size={POLICY_BATCH}")
    model, opt, _ = build_model_and_state(cfg, TRAIN_STEPS)
    run = setup_run(cfg, model, opt, make_clip_train_step(model))
    fa.reset_launches()
    run.state, metrics = run.step(run.state, batch)
    torch.cuda.synchronize()
    if metrics["step_ok"] != 1.0:
        raise RuntimeError(f"{policy}: step not applied")
    return fa.launches["flash_fwd_lse"]


def _reference_grads(model_gpu, cpu, batch: dict, loss_fn, label: str,
                     **bounds) -> None:
    """Loss and gradient of one batch on the card (bf16 compute, kernels)
    and on the CPU through the plain path in f32 (``cpu``: the same model
    built in f32 on the CPU), from the same weights; ``loss_fn(model,
    batch on the model's device)`` gives the loss; ``bounds`` are
    :func:`check_against_cpu`'s."""
    cpu.load_state_dict({k: v.cpu() for k, v in
                         model_gpu.state_dict().items()})
    results = []
    card = next(model_gpu.parameters()).device
    for model, device in ((model_gpu, card), (cpu, "cpu")):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, {k: torch.from_numpy(v).to(device)
                               for k, v in batch.items()})
        loss.backward()
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters() if p.grad is not None}
        results.append((loss.item(), grads))
    model_gpu.zero_grad(set_to_none=True)
    check_against_cpu(results, label, **bounds)


def _clip_loss(model, b: dict) -> torch.Tensor:
    from avion_tpu_torch.losses.losses import clip_loss
    from avion_tpu_torch.train.steps import prep_video

    out = model(prep_video(b["video"], dtype=model.dtype), b["text"].long(),
                deterministic=False)
    return clip_loss(out["image_embed"], out["text_embed"],
                     out["logit_scale"])["loss"]


def check_against_cpu(results, label: str, loss_tol: float = 2e-2,
                      cos_tol: float = 0.99) -> None:
    """``results``: (loss, gradients by name) on the card, then on the CPU
    in f32.  Relative loss difference at most ``loss_tol``, cosine of the
    whole gradient at least ``cos_tol``."""
    (l_gpu, g_gpu), (l_cpu, g_cpu) = results

    def dots(a, b):  # f64: f32 sums over 1.5e8 terms drift past 1e-2
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        return torch.stack([a @ b, a @ a, b @ b])

    names = sorted(g_cpu)
    per_dots = {n: dots(g_gpu[n], g_cpu[n]) for n in names}
    ab, aa, bb = sum(per_dots.values()).tolist()
    cos = ab / math.sqrt(aa * bb)
    per = {n: (d[0] / (d[1] * d[2]).sqrt()).item()
           for n, d in per_dots.items()}
    worst = min(per, key=per.get)
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    log(f"{label}: loss card {l_gpu:.6f}, CPU f32 {l_cpu:.6f}, relative "
        f"difference {rel:.3e} (bound {loss_tol}); gradient cosine "
        f"{cos:.6f} (bound {cos_tol}); smallest per-tensor cosine "
        f"{per[worst]:.6f} ({worst})")
    if not (rel <= loss_tol and cos >= cos_tol):
        raise RuntimeError(f"{label}: the card disagrees with the CPU "
                           f"reference")


def _timed_epoch(run, loader) -> dict:
    """``train_one_epoch`` over ``loader``: each step's time and metrics,
    the epoch's summary, the kernel launches (counted from the epoch's
    start; QuickGELU's under ``act``) and the peak memory."""
    from avion_tpu_torch.train.loop import train_one_epoch

    ends, seen, inner = [], [], run.step

    def timed(state, batch):
        state, metrics = inner(state, batch)
        seen.append({k: float(v) for k, v in metrics.items()})
        ends.append(time.perf_counter())
        return state, metrics

    run.step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # the path's launches, counted from here
    act.reset_launches()
    start = time.perf_counter()
    try:
        summary = train_one_epoch(run, loader, 0)
        torch.cuda.synchronize()
    finally:
        run.step = inner
    return {"launches": dict(fa.launches), "act": dict(act.launches),
            "metrics": seen,
            "summary": summary, "peak": torch.cuda.max_memory_allocated(),
            "step_ms": np.diff([start] + ends) * 1e3}


def _same_state(state, saved: dict, saved_opt: dict) -> bool:
    """The model's state dict, the optimizer's count and its state (AdamW's
    moments, SGD's momentum) equal ``saved`` / ``saved_opt``, bit for
    bit."""
    name = state.optimizer.name
    got = state.optimizer.state_dict()
    return (all(torch.equal(v, saved[k])
                for k, v in state.model.state_dict().items())
            and got["count"] == saved_opt["count"]
            and len(got[name]["state"]) == len(saved_opt[name]["state"]) > 0
            and all(torch.equal(v, saved_opt[name]["state"][i][k])
                    for i, s in got[name]["state"].items()
                    for k, v in s.items()))


def phase_train(tmp: str) -> dict:
    """The training slice's main path at full width, fed seeded batches;
    returns the kernel launches of its 8-step epoch and its p50 step ms."""
    from avion_tpu_torch.models.layers import saved_attn_layers
    from avion_tpu_torch.train.loop import save_epoch, setup_run
    from avion_tpu_torch.train.pretrain_clip import (build_model,
                                                     build_model_and_state)
    from avion_tpu_torch.train.steps import make_clip_train_step

    log(f"== train {MODEL} at {FRAMES} frames, batch {TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps over {len(TRAIN_SEEDS)} distinct batches")
    out_dir = os.path.join(tmp, "train")
    cfg = _train_config(out_dir)
    t0 = time.perf_counter()
    model, opt, schedule = build_model_and_state(cfg, TRAIN_STEPS)
    run = setup_run(cfg, model, opt, make_clip_train_step(model))
    batches = _train_batches(len(TRAIN_SEEDS), TRAIN_BATCH, FRAMES)
    log(f"model, optimizer and batches ready in "
        f"{time.perf_counter() - t0:.1f} s; lr at the last step "
        f"{schedule(TRAIN_STEPS - 1):.3e} (warmup to {cfg.optim.lr:.1e} "
        f"over {TRAIN_STEPS} steps)")

    # the main path's launches, counted from the epoch's start
    res = _timed_epoch(run, [batches[i % len(batches)]
                             for i in range(TRAIN_STEPS)])
    launches, peak, per_step = res["launches"], res["peak"], res["step_ms"]
    losses = [m["loss"] for m in res["metrics"]]
    oks = [m["step_ok"] for m in res["metrics"]]
    metrics = res["summary"]
    log(f"losses {losses}; step_ok {oks}")
    log(f"step ms {[round(float(x), 3) for x in per_step]}")
    if (len(losses) != TRAIN_STEPS or not np.isfinite(losses).all()
            or oks != [1.0] * TRAIN_STEPS):
        raise RuntimeError("a train step failed")
    want = {"flash_fwd_lse": 2 * LAYERS * TRAIN_STEPS,
            "flash_bwd_combined": 2 * LAYERS * TRAIN_STEPS}
    log(f"kernel launches in {TRAIN_STEPS} steps: {launches} "
        f"(per step: 24 forward-with-lse, 24 combined backward, 0 others)")
    if launches != want:
        raise RuntimeError(f"launches {launches}, expected {want}")
    _check_act("train", res["act"], _act_launches(model), TRAIN_STEPS)
    launches = {**launches, **res["act"]}
    steady = per_step[2:]
    p50 = float(np.median(steady))
    flops = _model_flops(model, TRAIN_BATCH)
    log(f"steps 3-{TRAIN_STEPS}: p50 {p50:.3f} ms, "
        f"{TRAIN_BATCH * len(steady) / steady.sum() * 1e3:.2f} clips/s; "
        f"peak memory allocated {peak / 2**30:.3f} GiB")
    log(f"model flops per step {flops:.4e} = 6 x parameters x tokens per "
        f"tower (token-embedding table excluded) + 12 B H S^2 D per "
        f"attention layer, remat's extra forward not counted; at the p50 "
        f"step {flops / (p50 * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{flops / (p50 * 1e-3) / H100_BF16_FLOPS:.4f} of 989 TFLOP/s")
    det = _deterministic_steps(run, batches)
    profile_step(run, _to_device(batches[0]))

    small = _to_device({k: v[:POLICY_BATCH] for k, v in batches[0].items()})
    counts = {}
    for policy in ("full", "save_attn_k10"):
        # per tower: one forward per layer, one more for each unsaved layer
        want_fwd = 2 * (2 * LAYERS - min(saved_attn_layers(policy, LAYERS),
                                         LAYERS))
        counts[policy] = _policy_forwards(tmp, policy, small)
        if counts[policy] != want_fwd:
            raise RuntimeError(f"{policy}: {counts[policy]} forward-with-lse "
                               f"launches, expected {want_fwd}")
    log(f"forward-with-lse launches of one batch-{POLICY_BATCH} step: "
        f"save_attn {2 * LAYERS} (above), {counts}")

    _reference_grads(model, build_model(cfg, torch.float32).to_empty(
        device="cpu"), {k: v[:REF_BATCH] for k, v in batches[1].items()},
        _clip_loss, f"reference step at batch {REF_BATCH}")

    save_epoch(run, 0, metrics)
    saved = {k: v.detach().clone() for k, v in
             run.state.model.state_dict().items()}
    saved_opt = run.state.optimizer.state_dict()
    step = run.state.step
    del run, model, opt
    torch.cuda.empty_cache()
    model2, opt2, _ = build_model_and_state(_train_config(out_dir, "seed=1"),
                                            TRAIN_STEPS)
    run2 = setup_run(cfg, model2, opt2, make_clip_train_step(model2))
    same = run2.state.step == step and _same_state(run2.state, saved,
                                                   saved_opt)
    log(f"checkpoint at step {step} restored into a model built from another "
        f"seed: step, parameters and AdamW moments bit for bit: {same}")
    if not same:
        raise RuntimeError("resume did not restore the train state exactly")
    return launches, p50, det


DET_STEPS = 4  # seeded steps under the deterministic flag, 2 of them timed


def _deterministic_steps(run, batches: list) -> dict:
    """DET_STEPS more steps of the seeded run under
    ``torch.use_deterministic_algorithms(True)``: finite losses, every
    backward on the split kernels (24 + 24 + 24 launches a step), the p50
    of the steps after the first two beside the default route's."""
    with deterministic():
        res = _timed_epoch(run, [batches[i % len(batches)]
                                 for i in range(DET_STEPS)])
    launches = res["launches"]
    want = {name: 2 * LAYERS * DET_STEPS for name in (
        "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")}
    losses = [m["loss"] for m in res["metrics"]]
    p50 = float(np.median(res["step_ms"][2:]))
    log(f"{DET_STEPS} steps under the deterministic flag: losses {losses}, "
        f"step ms {[round(float(x), 3) for x in res['step_ms']]}, p50 of "
        f"steps 3-{DET_STEPS} {p50:.3f} ms, launches {launches}")
    if launches != want or not np.isfinite(losses).all():
        raise RuntimeError(f"deterministic steps: launches {launches}, "
                           f"expected {want}; losses {losses}")
    return {"p50_ms": p50, "launches": launches}


def phase_train_long(tmp: str) -> dict:
    """The config's default clip length, 16 frames (3137 visual tokens,
    past the combined backward's 1024): a few steps through the same entry
    points; the visual tower takes the split dq / dkv kernels, the text
    tower the combined one.  Returns the run's launches."""
    from avion_tpu_torch.train.loop import setup_run, train_one_epoch
    from avion_tpu_torch.train.pretrain_clip import build_model_and_state
    from avion_tpu_torch.train.steps import make_clip_train_step

    log(f"== train {MODEL} at {LONG_FRAMES} frames, batch {LONG_BATCH}, "
        f"{LONG_STEPS} steps")
    cfg = _train_config(os.path.join(tmp, "long"),
                        f"data.clip_length={LONG_FRAMES}",
                        f"data.batch_size={LONG_BATCH}")
    model, opt, _ = build_model_and_state(cfg, LONG_STEPS)
    run = setup_run(cfg, model, opt, make_clip_train_step(model))
    loader = _train_batches(LONG_STEPS, LONG_BATCH, LONG_FRAMES)
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    metrics = train_one_epoch(run, loader, 0)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    log(f"{LONG_STEPS} steps in {(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"mean loss {metrics['loss']:.6f}, step_ok {metrics['step_ok']}; "
        f"launches {launches}")
    want = {"flash_fwd_lse": 2 * LAYERS * LONG_STEPS,
            "flash_bwd_combined": LAYERS * LONG_STEPS,
            "flash_bwd_dq": LAYERS * LONG_STEPS,
            "flash_bwd_dkv": LAYERS * LONG_STEPS}
    if not (np.isfinite(metrics["loss"]) and metrics["step_ok"] == 1.0):
        raise RuntimeError("a 16-frame train step failed")
    if launches != want:
        raise RuntimeError(f"launches {launches}, expected {want}")
    return launches


# the data slice: a synthetic Ego4D layout in AVION's cut (15 s chunks at a
# 288 px short side, 30 fps), 8 videos of 2 chunks, and 2048 narration rows
# of 1-4 s windows; run A trains on every 2nd row with host crop for one
# 4-step epoch, run B with device crop for 2 steps over every 4th row
DATA_VIDEOS, DATA_CHUNKS, DATA_ROWS = 8, 2, 2048
DATA_W, DATA_H, DATA_FPS, DATA_CHUNK_S = 512, 288, 30, 15
# run A reads every 2nd of the layout's rows, run B every 4th
DATA_STEPS, DEVICE_CROP_STEPS = 4, 2
CROP_TOL = 1e-3  # card against CPU, f32, normalized values
CROP_BATCH = 64  # clips of the crop check's batch (run B's: 256)
VERBS = ("opens", "closes", "picks up", "puts down", "cuts", "washes",
         "stirs", "pours", "holds", "moves")
NOUNS = ("the drawer", "a knife", "the onion", "the cup", "the pan",
         "a plate", "the tap", "the lid", "a bowl", "the towel")


def video_io_check(tmp: str) -> None:
    """cv2's "Video I/O" build section, and an mp4v write read back."""
    import cv2

    info = cv2.getBuildInformation()
    section = info[info.find("Video I/O"):].split("\n\n")[0]
    log(f"cv2 {cv2.__version__} {section.strip()}")
    path = os.path.join(tmp, "probe.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), DATA_FPS,
                         (64, 48))
    if not vw.isOpened():
        raise RuntimeError("cv2 cannot write mp4v on this machine")
    for i in range(10):
        vw.write(np.full((48, 64, 3), 20 * i, np.uint8))
    vw.release()
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    ok, frame = cap.read()
    cap.release()
    if not (ok and n == 10 and frame.shape == (48, 64, 3)):
        raise RuntimeError(f"cv2 cannot read mp4v back: {n} frames, {ok}")


def _write_chunk(path: str, canvas: np.ndarray, first: int,
                 frames: int = DATA_CHUNK_S * DATA_FPS,
                 fps: int = DATA_FPS) -> None:
    """One chunk (15 s by default): a window of the canvas's height and a
    third of its width, sliding one pixel a frame (seeded, smooth, so the
    codec sees motion as in real video)."""
    import cv2

    h, w = canvas.shape[0], canvas.shape[1] // 3
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for t in range(first, first + frames):
        x = t % (canvas.shape[1] - w)
        vw.write(np.ascontiguousarray(canvas[:, x:x + w]))
    vw.release()


def _canvas(rs, w: int, h: int) -> np.ndarray:
    """A seeded smooth texture three frames wide."""
    import cv2

    small = rs.randint(0, 256, (9, 48, 3)).astype(np.uint8)
    return cv2.resize(small, (w * 3, h), interpolation=cv2.INTER_CUBIC)


def write_ego4d_fixture(root: str, seed: int = 0) -> str:
    """``root/vid<k>.mp4/<chunk_start>.mp4`` and an ego4d metadata pickle
    of DATA_ROWS (vid, start, end, narration) rows; returns its path."""
    rs = np.random.RandomState(seed)
    jobs = []
    for v in range(DATA_VIDEOS):
        canvas = _canvas(rs, DATA_W, DATA_H)
        os.makedirs(os.path.join(root, f"vid{v}.mp4"))
        for c in range(DATA_CHUNKS):
            start = c * DATA_CHUNK_S
            jobs.append((os.path.join(root, f"vid{v}.mp4", f"{start}.mp4"),
                         canvas, start * DATA_FPS))
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(lambda job: _write_chunk(*job), jobs))
    span = DATA_CHUNKS * DATA_CHUNK_S
    rows = []
    for _ in range(DATA_ROWS):
        dur = rs.uniform(1.0, 4.0)
        start = rs.uniform(0.0, span - dur)
        rows.append((f"vid{rs.randint(DATA_VIDEOS)}", start, start + dur,
                     f"#C C {VERBS[rs.randint(len(VERBS))]} "
                     f"{NOUNS[rs.randint(len(NOUNS))]}"))
    meta = os.path.join(root, "train.pkl")
    with open(meta, "wb") as f:
        pickle.dump(rows, f)
    return meta


def write_k400_fixture(root: str, seed: int = 0, *, videos: int = 64,
                       frames: int = 96, w: int = 340, h: int = 256,
                       fps: int = 30, classes: int = 8) -> str:
    """``root/vid<k>.mp4`` (mp4v, a seeded texture sliding one pixel a
    frame) and a Kinetics ``path label`` list; returns the list's path."""
    rs = np.random.RandomState(seed)
    jobs = [(os.path.join(root, f"vid{k}.mp4"), _canvas(rs, w, h), 0,
             frames, fps) for k in range(videos)]
    os.makedirs(root, exist_ok=True)
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(lambda job: _write_chunk(*job), jobs))
    path = os.path.join(root, "list.txt")
    with open(path, "w") as f:
        f.write("".join(f"vid{k}.mp4 {k % classes}\n" for k in range(videos)))
    return path


def _device_busy_ms(prof) -> float:
    """Union of the device's activity intervals (kernels, copies) in a
    profile: the copy stream's transfers overlap the step's kernels."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in _device_events(prof))
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


class _ProfileLastSteps:
    """Wraps an entry's step maker (``make_clip_train_step`` and the like)
    so that the profiler
    covers the last ``window`` steps of the run together with the waits
    for their batches: it starts when the step before them returns and
    stops when the last returns.  Two steps: with ``prefetch_depth=2`` the batches land in
    pairs, a long wait and then a short one."""

    def __init__(self, make_step, steps: int, window: int = 2):
        self.make_step, self.steps, self.window = make_step, steps, window
        self.prof, self.t0, self.wall_ms, self.busy_ms = None, 0.0, 0.0, 0.0

    def __call__(self, *args, **kwargs):
        from torch.profiler import ProfilerActivity, profile

        inner = self.make_step(*args, **kwargs)
        calls = [0]

        def step(*step_args):
            out = inner(*step_args)
            calls[0] += 1
            torch.cuda.synchronize()
            if calls[0] == self.steps - self.window:
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            elif calls[0] == self.steps:
                self.wall_ms = (time.perf_counter() - self.t0) * 1e3
                self.prof.__exit__(None, None, None)
                self.busy_ms = _device_busy_ms(self.prof)
            return out

        return step


def _data_args(out_dir: str, root: str, meta: str, fused: bool,
               *overrides: str) -> list:
    return [*TRAIN_RECIPE, f"output_dir={out_dir}", f"data.root={root}",
            f"data.train_metadata={meta}", "data.dataset=ego4d",
            f"data.fused_decode_crop={str(fused).lower()}",
            f"data.num_workers={min(8, os.cpu_count() or 1)}",
            "optim.epochs=1", *overrides]


def _train_log(out_dir: str) -> list:
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _check_data_run(name: str, res: dict, launches: dict, steps: int,
                    out_dir: str):
    """Finite losses, every step applied, 24 + 24 launches a step; returns
    the per-step (batch ms, data ms) of the run's log."""
    recs = [r for r in _train_log(out_dir) if "train/loss" in r]
    losses = [r["train/loss"] for r in recs]
    oks = [r["train/step_ok"] for r in recs]
    log(f"{name}: {res['steps']} steps, losses {losses}, step_ok {oks}, "
        f"launches {launches}, decode backend {res['decode_backend']}, "
        f"transfers {res['transfers']}")
    want = {"flash_fwd_lse": 2 * LAYERS * steps,
            "flash_bwd_combined": 2 * LAYERS * steps}
    if (res["steps"] != steps or len(losses) != steps
            or not np.isfinite(losses).all() or oks != [1.0] * steps):
        raise RuntimeError(f"{name}: a data-fed train step failed")
    if launches != want:
        raise RuntimeError(f"{name}: launches {launches}, expected {want}")
    return ([r["perf/batch_time_win"] * 1e3 for r in recs],
            [r["perf/data_time_win"] * 1e3 for r in recs])


def _check_device_crop(cfg_args: list) -> dict:
    """``crop_resize_flip_normalize`` on the card against the CPU, f32, on
    one decoded device-crop batch with its own flips and with every second
    clip flipped; and its time on the card (bf16 out, as the step runs
    it)."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.ops.fused_input import crop_resize_flip_normalize
    from avion_tpu_torch.train.pretrain_clip import build_loaders

    cfg = TrainConfig().apply_overrides(cfg_args)
    _, loader = build_loaders(cfg)
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    args = [torch.from_numpy(np.ascontiguousarray(batch[k]))
            for k in ("video", "crop", "hflip")]
    size = (cfg.data.crop_size, cfg.data.crop_size)
    # the batch's own flips (none under the recipe), then every second
    # clip flipped
    err = 0.0
    for flips in (args[2], torch.arange(len(args[2])) % 2 == 1):
        ref = crop_resize_flip_normalize(*args[:2], flips, out_size=size,
                                         dtype=torch.float32)
        got = crop_resize_flip_normalize(
            args[0].cuda(), args[1].cuda(), flips.cuda(), out_size=size,
            dtype=torch.float32).cpu()
        err = max(err, (got - ref).abs().max().item())
        del ref, got
    dev = [a.cuda() for a in args]
    ms = cuda_ms(lambda: crop_resize_flip_normalize(*dev, out_size=size),
                 iters=5)
    row = {"batch": list(batch["video"].shape), "max_abs_err": err,
           "ms_bf16_out": ms, "flipped": int(batch["hflip"].sum())}
    log(f"device crop on the card against the CPU (f32): {row} "
        f"(bound {CROP_TOL})")
    if not err <= CROP_TOL:
        raise RuntimeError(f"device crop disagrees with the CPU: {err}")
    return row


def _decode_ms_per_clip(cfg_args: list, clips: int = 16) -> float:
    """Wall ms of one dataset item (decode, crop, tokenize) in this
    process: what one loader worker spends a clip."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.train.pretrain_clip import build_loaders

    ds, _ = build_loaders(TrainConfig().apply_overrides(cfg_args))
    ds[0]  # open the first reader
    t0 = time.perf_counter()
    for i in range(1, clips + 1):
        ds[i]
    return (time.perf_counter() - t0) / clips * 1e3


def phase_data(tmp: str, echo_p50: float) -> dict:
    """The data slice's main path: ``pretrain_clip.main`` on decoded video
    at full width, host crop (run A) then device crop (run B), then a
    resume; returns run A's launches."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.data.loader import shm_free_bytes
    from avion_tpu_torch.data.video_reader import default_backend
    from avion_tpu_torch.train import pretrain_clip

    log(f"== data: {MODEL} trained by pretrain_clip.main on decoded video")
    t_phase = time.perf_counter()
    video_io_check(tmp)
    root = os.path.join(tmp, "ego4d")
    t0 = time.perf_counter()
    meta = write_ego4d_fixture(root)
    log(f"fixture: {DATA_VIDEOS} videos x {DATA_CHUNKS} chunks of "
        f"{DATA_CHUNK_S} s, {DATA_W}x{DATA_H} at {DATA_FPS} fps (mp4v), "
        f"{DATA_ROWS} rows, written in {time.perf_counter() - t0:.2f} s")
    log(f"decode backend {default_backend()}, os.cpu_count() "
        f"{os.cpu_count()}, /dev/shm free {shm_free_bytes() / 2**20:.1f} MiB")

    out_a = os.path.join(tmp, "data_host_crop")
    args_a = _data_args(out_a, root, meta, True, "data.subsample_stride=2")
    out_b = os.path.join(tmp, "data_device_crop")
    args_b = _data_args(out_b, root, meta, False, "data.subsample_stride=4")
    per_clip = {"host crop": _decode_ms_per_clip(args_a),
                "device crop": _decode_ms_per_clip(args_b)}
    log("one item (decode, crop, tokenize) in one process, ms a clip: "
        + ", ".join(f"{k} {v:.3f} ({TRAIN_BATCH * v / 1e3:.2f} s a batch)"
                    for k, v in per_clip.items()))
    profiler = _ProfileLastSteps(pretrain_clip.make_clip_train_step,
                                 DATA_STEPS)
    pretrain_clip.make_clip_train_step = profiler
    try:
        torch.cuda.synchronize()
        fa.reset_launches()  # run A's main path, counted from here
        act.reset_launches()
        t0 = time.perf_counter()
        res_a = pretrain_clip.main(args_a)
        torch.cuda.synchronize()
        launches_a, act_a = dict(fa.launches), dict(act.launches)
        wall_a = time.perf_counter() - t0
    finally:
        pretrain_clip.make_clip_train_step = profiler.make_step
    batch_ms, data_ms = _check_data_run("run A (host crop)", res_a,
                                        launches_a, DATA_STEPS, out_a)
    _check_act("run A (host crop)", act_a, _act_launches(
        pretrain_clip.build_model(pretrain_clip.env_defaults(
            TrainConfig().apply_overrides(args_a)))), DATA_STEPS)
    launches_a = {**launches_a, **act_a}
    steady = np.array(batch_ms[2:])
    p50 = float(np.median(steady))
    log(f"run A per-step ms {[round(x, 3) for x in batch_ms]}, data wait ms "
        f"{[round(x, 3) for x in data_ms]}; main() wall {wall_a:.2f} s")
    log(f"run A steps 3-{DATA_STEPS}: p50 step {p50:.3f} ms, p50 data_time "
        f"{float(np.median(data_ms[2:])):.3f} ms, "
        f"{TRAIN_BATCH * len(steady) / steady.sum() * 1e3:.2f} clips/s; "
        f"echo-fed train p50 {echo_p50:.3f} ms, gap {p50 - echo_p50:.3f} ms "
        f"({p50 / echo_p50:.3f}x)")
    if profiler.busy_ms:
        log(f"profile of data-fed steps {DATA_STEPS - profiler.window + 1}-"
            f"{DATA_STEPS} with their batch waits: wall "
            f"{profiler.wall_ms:.2f} ms, device busy {profiler.busy_ms:.3f} "
            f"ms, idle share {1 - profiler.busy_ms / profiler.wall_ms:.4f}")
    else:
        log("profile: the profiler saw no device time (not measured)")

    torch.cuda.synchronize()
    fa.reset_launches()  # run B's main path
    t0 = time.perf_counter()
    res_b = pretrain_clip.main(args_b)
    torch.cuda.synchronize()
    launches_b = dict(fa.launches)
    wall_b = time.perf_counter() - t0
    batch_ms_b, data_ms_b = _check_data_run(
        "run B (device crop)", res_b, launches_b, DEVICE_CROP_STEPS, out_b)
    log(f"run B per-step ms {[round(x, 3) for x in batch_ms_b]}, data wait "
        f"ms {[round(x, 3) for x in data_ms_b]}; main() wall {wall_b:.2f} s; "
        f"steps 2-{DEVICE_CROP_STEPS}: p50 step "
        f"{float(np.median(batch_ms_b[1:])):.3f} ms")
    crop = _check_device_crop([*args_b, f"data.batch_size={CROP_BATCH}"])

    fa.reset_launches()
    again = pretrain_clip.main(args_a)
    if again["steps"] != 0 or again["step"] != res_a["step"] or fa.launches:
        raise RuntimeError(f"resume of run A trained again: {again}, "
                           f"launches {dict(fa.launches)}")
    log(f"resume of run A: restored step {again['step']}, 0 steps, "
        f"0 launches")
    log(f"data phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"host_crop": launches_a, "device_crop": launches_b,
            "crop": crop, "fixture": (root, meta)}


# the eval slice: seeded synthetic layouts of the five zero-shot suites in
# their datasets' formats, at the data phase's 512x288 and 30 fps
# the suites' sizes keep the phase's host decode (most of its time) short
# MIR's 32 clips (of the test split's 9668) are also the CLS suite's; with
# 128 MIR clips and 32 of EGTEA and EgoMCQ the phase took 126-146 s of the
# script's 1200
EVAL_SIZES = dict(mir_clips=32, egtea_clips=16,
                  charades_videos=16, charades_classes=24, mcq_items=16)
EVAL_CLIP_S = 3  # seconds of each EGTEA clip and Charades-Ego video


def _ts(sec: float) -> str:
    """Seconds as EPIC-Kitchens' HH:MM:SS.ss."""
    return f"{int(sec // 3600):02d}:{int(sec % 3600 // 60):02d}:" \
        f"{sec % 60:05.2f}"


def _caption(combo) -> tuple:
    """(verb class, noun class, caption) of one of the 100 actions."""
    v, n = divmod(int(combo), len(NOUNS))
    return v, n, f"{VERBS[v]} {NOUNS[n]}"


def _write_csv(path: str, header: list, rows: list) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


def _write_ek100(ek: str, rs, video, clips: dict, chunk_s: int, fps: int):
    """EPIC-Kitchens' layout under ``ek``: ``PXX/PXX_YY.MP4/<chunk_start>.
    MP4`` (4 videos of 2 chunks, queued through ``video(path, frames)``);
    for each split of ``clips`` (name: rows) ``EPIC_100_retrieval_<split>
    .csv`` of narrated windows (verb x noun captions, each of the 100 once
    before any repeats), its ``_sentence.csv`` (each distinct caption once,
    under the id of its first clip, in a seeded order) and the graded
    relevancy pkl (1 for the same verb and noun, 0.5 for one of them, else
    0), so that every clip and sentence has a relevant match; and an
    ``actions.csv`` of the 100 verb-noun actions.  Returns (the captions'
    seeded order, the chunk files)."""
    combos = len(VERBS) * len(NOUNS)
    vids = [("P01", "P01_01"), ("P01", "P01_02"), ("P02", "P02_01"),
            ("P02", "P02_02")]
    chunks = []
    for pid, vid in vids:
        for c in range(2):
            path = os.path.join(ek, pid, f"{vid}.MP4", f"{c * chunk_s}.MP4")
            video(path, chunk_s * fps)
            chunks.append(path)
    order = rs.permutation(combos)
    header = ["narration_id", "participant_id", "video_id",
              "narration_timestamp", "start_timestamp", "stop_timestamp",
              "start_frame", "stop_frame", "narration", "verb", "verb_class",
              "noun", "noun_class", "all_nouns", "all_noun_classes"]
    os.makedirs(os.path.join(ek, "relevancy"))
    for split, n_clips in clips.items():
        rows, parts = [], []
        for k in range(n_clips):
            pid, vid = vids[rs.randint(len(vids))]
            dur = rs.uniform(1.0, min(4.0, chunk_s))
            start = rs.uniform(0.0, 2 * chunk_s - dur)
            v, n, text = _caption(order[k % combos])
            parts.append((v, n))
            rows.append([f"{vid}_{k}", pid, vid, _ts(start), _ts(start),
                         _ts(start + dur), int(start * fps),
                         int((start + dur) * fps), text, VERBS[v], v,
                         NOUNS[n], n, f"['{NOUNS[n]}']", f"[{n}]"])
        _write_csv(os.path.join(ek, f"EPIC_100_retrieval_{split}.csv"),
                   header, rows)
        sent = rs.permutation(np.unique([r[8] for r in rows],
                                        return_index=True)[1])
        _write_csv(os.path.join(ek, f"EPIC_100_retrieval_{split}_sentence"
                                    f".csv"),
                   ["narration_id", "narration"],
                   [[rows[i][0], rows[i][8]] for i in sent])
        p = np.asarray(parts)
        rel = ((p[:, None, 0] == p[None, sent, 0]).astype(np.float64)
               + (p[:, None, 1] == p[None, sent, 1])) / 2
        with open(os.path.join(ek, "relevancy", f"caption_relevancy_EPIC_"
                                                f"100_retrieval_{split}.pkl"),
                  "wb") as f:
            pickle.dump(rel, f)
    _write_csv(os.path.join(ek, "actions.csv"),
               ["id", "verb", "noun", "action"],
               [[i, *_caption(i)[:2], _caption(i)[2].replace(" ", "_")]
                for i in range(combos)])
    return order, chunks


def write_eval_fixtures(root: str, seed: int = 0, *, w: int = DATA_W,
                        h: int = DATA_H, fps: int = DATA_FPS,
                        chunk_s: int = DATA_CHUNK_S, clip_s: int = EVAL_CLIP_S,
                        mir_clips: int = EVAL_SIZES["mir_clips"],
                        egtea_clips: int = EVAL_SIZES["egtea_clips"],
                        charades_videos: int = EVAL_SIZES["charades_videos"],
                        charades_classes: int = EVAL_SIZES["charades_classes"],
                        mcq_items: int = EVAL_SIZES["mcq_items"]) -> dict:
    """Write the five suites' layouts under ``root`` with cv2 (mp4v):

    - EK100 MIR and CLS: :func:`_write_ek100`'s layout under ``ek100``
      with the test split of ``mir_clips`` narrated windows;
    - EGTEA: ``egtea/data/<video>/<clip>.mp4``, ``action_idx.txt`` and
      ``test_split1.txt`` over 20 actions;
    - Charades-Ego: ``charades/data/<id>.mp4``, the classes txt and the
      test csv, 1-3 labelled actions a video;
    - EgoMCQ: ``mcq/<uid>.mp4/0.mp4`` (4 videos of one chunk) and
      ``egomcq.json``: a query, 5 candidate windows, the answer, intra- or
      inter-video.

    Returns ``{"data": DataConfig overrides, "env": the suites' variables,
    "mir_videos": the MIR chunk files}``."""
    rs = np.random.RandomState(seed)
    jobs = []

    def video(path, frames):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jobs.append((path, _canvas(rs, w, h), 0, frames, fps))

    combos = len(VERBS) * len(NOUNS)
    ek = os.path.join(root, "ek100")
    order, mir_videos = _write_ek100(ek, rs, video, {"test": mir_clips},
                                     chunk_s, fps)
    val = os.path.join(ek, "EPIC_100_retrieval_test.csv")
    rel_path = os.path.join(
        ek, "relevancy", "caption_relevancy_EPIC_100_retrieval_test.pkl")
    actions = os.path.join(ek, "actions.csv")

    # EGTEA: 20 actions, clips of clip_s seconds
    eg = os.path.join(root, "egtea")
    os.makedirs(os.path.join(eg, "meta"))
    with open(os.path.join(eg, "meta", "action_idx.txt"), "w") as f:
        f.writelines(f"{_caption(order[i])[2].replace(' ', '_')} {i + 1}\n"
                     for i in range(20))
    with open(os.path.join(eg, "meta", "test_split1.txt"), "w") as f:
        for k in range(egtea_clips):
            video_id = f"P{k % 4 + 1:02d}-R01-Kitchen"
            clip_id = f"{video_id}-{k:04d}"
            video(os.path.join(eg, "data", video_id, f"{clip_id}.mp4"),
                  clip_s * fps)
            f.write(f"{clip_id} {rs.randint(20) + 1} 0\n")

    # Charades-Ego: untrimmed test videos with 1-3 actions each
    ch = os.path.join(root, "charades")
    os.makedirs(os.path.join(ch, "meta"))
    with open(os.path.join(ch, "meta", "Charades_v1_classes.txt"), "w") as f:
        f.writelines(f"c{i:03d} {_caption(order[-1 - i])[2]}\n"
                     for i in range(charades_classes))
    rows = []
    for k in range(charades_videos):
        vid = f"V{k:04d}EGO"
        video(os.path.join(ch, "data", f"{vid}.mp4"), clip_s * fps)
        acts = rs.choice(charades_classes,
                         rs.randint(1, min(3, charades_classes) + 1),
                         replace=False)
        rows.append([vid] + [""] * 8 + [";".join(
            f"c{a:03d} {rs.uniform(0, clip_s / 2):.2f} "
            f"{rs.uniform(clip_s / 2, clip_s):.2f}" for a in acts),
            f"{clip_s:.2f}"])
    _write_csv(os.path.join(ch, "meta", "CharadesEgo_v1_test_only1st.csv"),
              ["id", "subject", "scene", "quality", "relevance", "verified",
               "script", "objects", "descriptions", "actions", "length"],
              rows)

    # EgoMCQ: 4 one-chunk videos; a query and 5 candidate windows
    mq = os.path.join(root, "mcq")
    uids = [f"uid{u}" for u in range(4)]
    for uid in uids:
        video(os.path.join(mq, f"{uid}.mp4", "0.mp4"), chunk_s * fps)
    items = {}
    for k in range(mcq_items):
        intra = k % 2 == 0
        choices = {}
        for c in range(5):
            dur = rs.uniform(1.0, min(3.0, chunk_s))
            start = rs.uniform(0.0, chunk_s - dur)
            choices[str(c)] = {
                "video_uid": uids[k % 4] if intra else uids[rs.randint(4)],
                "clip_start": start, "clip_end": start + dur,
                "clip_text": _caption(order[(k * 5 + c) % combos])[2]}
        query = f"#C C {_caption(order[-1 - k % combos])[2]} {k}"
        items[str(k)] = {"query": {"clip_text": query}, "choices": choices,
                         "answer": int(rs.randint(5)),
                         "types": 1 if intra else 2}
    with open(os.path.join(mq, "egomcq.json"), "w") as f:
        json.dump(items, f)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(lambda job: _write_chunk(*job), jobs))
    return {"data": {"val_metadata": val, "relevancy_path": rel_path,
                     "root_val": ek, "chunk_len": chunk_s},
            "env": {"EK100_ACTIONS_CSV": actions, "EK100_VAL": val,
                    "EK100_VIDEO_DIR": ek,
                    "EGTEA_DATA_DIR": os.path.join(eg, "data"),
                    "EGTEA_META_DIR": os.path.join(eg, "meta"),
                    "CHARADES_DATA_DIR": os.path.join(ch, "data"),
                    "CHARADES_META_DIR": os.path.join(ch, "meta"),
                    "EGO4D_MCQ_DATA_DIR": mq, "EGO4D_MCQ_META_DIR": mq},
            "mir_videos": mir_videos}


def write_ek100_fixture(root: str, seed: int = 0, *, w: int = DATA_W,
                        h: int = DATA_H, fps: int = DATA_FPS,
                        chunk_s: int = DATA_CHUNK_S, train_clips: int = 128,
                        test_clips: int = 64) -> dict:
    """The finetunes' EPIC-Kitchens layout under ``root`` with cv2 (mp4v):
    :func:`_write_ek100`'s videos, train and test splits (csvs, sentence
    csvs, relevancy pkls) and ``actions.csv``.  Returns the paths: ``root``,
    ``train``, ``test`` (csvs), ``relevancy`` (the test split's) and
    ``actions``."""
    rs = np.random.RandomState(seed)
    jobs = []

    def video(path, frames):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jobs.append((path, _canvas(rs, w, h), 0, frames, fps))

    _write_ek100(root, rs, video, {"train": train_clips, "test": test_clips},
                 chunk_s, fps)
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(lambda job: _write_chunk(*job), jobs))
    csv_path = os.path.join(root, "EPIC_100_retrieval_{}.csv").format
    return {"root": root, "train": csv_path("train"), "test": csv_path("test"),
            "relevancy": os.path.join(
                root, "relevancy",
                "caption_relevancy_EPIC_100_retrieval_test.pkl"),
            "actions": os.path.join(root, "actions.csv")}


EVAL_BATCH = 128  # data.val_batch_size's default
EVAL_EPOCHS = 2  # of the in-training drive, one step each
EMBED_CLIPS = 8


class _Captured:
    """Replaces ``module.CLIPEncoders`` by a subclass that keeps every
    instance made, until ``restore``."""

    def __init__(self, module):
        self.module, self.orig, self.made = module, module.CLIPEncoders, []
        made = self.made

        class Capturing(self.orig):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        module.CLIPEncoders = Capturing

    def forwards(self) -> int:
        return sum(e.image_calls + e.text_calls for e in self.made)

    def restore(self) -> None:
        self.module.CLIPEncoders = self.orig


def _eval_args(fx: dict, ckpt: str) -> list:
    return [f"model.name={MODEL}", f"data.clip_length={FRAMES}",
            f"data.crop_size={SIZE}", f"data.val_batch_size={EVAL_BATCH}",
            f"data.num_workers={min(8, os.cpu_count() or 1)}",
            *(f"data.{k}={v}" for k, v in fx["data"].items()),
            f"pretrain_model={ckpt}"]


def _eval_in_training(tmp: str, fx: dict, fixture: tuple) -> dict:
    """(a) ``pretrain_clip.main`` with ``eval_freq=1`` and the MIR suite,
    EVAL_EPOCHS one-step epochs on the data phase's Ego4D layout (every
    eighth row): the epoch -1 and per-epoch metrics, ``is_best`` on
    ``test_ek100_mir_avg_map``, the training model bit-equal (weights,
    dtypes, modes) across every eval pass, and the launches."""
    from avion_tpu_torch.eval import validate
    from avion_tpu_torch.train import pretrain_clip

    out = os.path.join(tmp, "data_with_eval")
    d = fx["data"]
    args = _data_args(out, *fixture, True, f"optim.epochs={EVAL_EPOCHS}",
                      "data.subsample_stride=8", "eval_freq=1",
                      f"data.val_batch_size={EVAL_BATCH}",
                      f"data.val_metadata={d['val_metadata']}",
                      f"data.relevancy_path={d['relevancy_path']}",
                      f"data.root_val={d['root_val']}")
    inner, passes = pretrain_clip.run_validation, []

    def checked(model, data_cfg, env=None, strict=False, group=None):
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        modes = [m.training for m in model.modules()]
        res = inner(model, data_cfg, env, strict, group)
        after = model.state_dict()
        passes.append(modes == [m.training for m in model.modules()] and all(
            after[k].dtype == v.dtype and torch.equal(after[k], v)
            for k, v in before.items()))
        return res

    pretrain_clip.run_validation = checked
    captured = _Captured(validate)
    try:
        torch.cuda.synchronize()
        fa.reset_launches()  # the path, counted from here
        t0 = time.perf_counter()
        res = pretrain_clip.main(args)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
    finally:
        pretrain_clip.run_validation = inner
        captured.restore()
    wall = time.perf_counter() - t0
    steps = res["steps"]
    log(f"(a) main with eval_freq=1: {steps} steps in {EVAL_EPOCHS} epochs, "
        f"{len(passes)} eval passes, main() wall {wall:.2f} s; the training "
        f"model bit-equal and in its modes after each pass: {passes}")
    for epoch, metrics in sorted(res["eval"].items()):
        log(f"  epoch {epoch}: {metrics}")
    want = {"flash_fwd": LAYERS * captured.forwards(),
            "flash_fwd_lse": 2 * LAYERS * steps,
            "flash_bwd_combined": 2 * LAYERS * steps}
    log(f"  launches {launches} for {captured.forwards()} eval tower "
        f"forwards and {steps} steps (expected {want})")
    if len(passes) != EVAL_EPOCHS + 1 or not all(passes):
        raise RuntimeError("an eval pass changed the training model")
    if sorted(res["eval"]) != list(range(-1, EVAL_EPOCHS)) or not all(
            len(m) == 6 and all(k.startswith("test_ek100_mir_")
                                and np.isfinite(v) for k, v in m.items())
            for m in res["eval"].values()):
        raise RuntimeError(f"bad in-training eval metrics {res['eval']}")
    if steps != EVAL_EPOCHS or launches != want:
        raise RuntimeError(f"(a): {steps} steps, launches {launches}")
    logged = [r["step"] for r in _train_log(out)
              if "test_ek100_mir_avg_map" in r]
    maps = [res["eval"][e]["test_ek100_mir_avg_map"]
            for e in range(EVAL_EPOCHS)]
    best, bests = -1.0, []
    for m in maps:
        bests.append(m > best)
        best = max(best, m)
    got = []
    for step in range(1, EVAL_EPOCHS + 1):
        with open(os.path.join(out, "ckpt", str(step), "extra.json")) as f:
            extra = json.load(f)
        got.append((extra["is_best"],
                    extra["metrics"]["test_ek100_mir_avg_map"]))
    log(f"  eval logged at steps {logged}; checkpoints (is_best, avg_map) "
        f"{got}")
    if logged != list(range(EVAL_EPOCHS + 1)) or got != list(zip(bests,
                                                                  maps)):
        raise RuntimeError("eval logging or is_best does not follow "
                           "test_ek100_mir_avg_map")
    return launches


def _embed_check(tmp: str, fx: dict, ckpt: str) -> None:
    """(d) ``tools.embed_videos`` on the card (bf16 weights) for
    EMBED_CLIPS MIR chunk files and as many sentences, against the same
    clips and sentences through the plain path on the CPU in f32."""
    from avion_tpu_torch.data.sampling import get_frame_ids
    from avion_tpu_torch.data.tokenizer import tokenize
    from avion_tpu_torch.data.transforms import (center_crop_spec,
                                                 normalize_video)
    from avion_tpu_torch.data.video_reader import VideoReader
    from avion_tpu_torch.models.pt_import import load_clip_checkpoint
    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.tools import embed_videos

    paths = fx["mir_videos"][:EMBED_CLIPS]
    with open(os.path.join(tmp, "embed_videos.txt"), "w") as f:
        f.write("\n".join(paths))
    with open(fx["data"]["val_metadata"].replace("test", "test_sentence"),
              newline="") as f:
        texts = [row[1] for row in list(csv.reader(f))[1:EMBED_CLIPS + 1]]
    with open(os.path.join(tmp, "embed_texts.txt"), "w") as f:
        f.write("\n".join(texts))
    t0 = time.perf_counter()
    out = embed_videos.main(["--ckpt", ckpt, "--model", MODEL,
                             "--videos", os.path.join(tmp, "embed_videos.txt"),
                             "--texts", os.path.join(tmp, "embed_texts.txt"),
                             "--out", os.path.join(tmp, "embeds.npz"),
                             "--clip-length", str(FRAMES),
                             "--crop-size", str(SIZE)])
    wall = time.perf_counter() - t0
    v_emb = _unit_rows("embed video", out["video_embeds"], len(paths))
    t_emb = _unit_rows("embed text", out["text_embeds"], len(texts))

    model = create_model(MODEL, num_frames=FRAMES, dtype=torch.float32)
    load_clip_checkpoint(model, ckpt)
    clips = []
    for path in paths:
        vr = VideoReader(path)
        clips.append(vr.get_batch(
            get_frame_ids(0, len(vr), FRAMES, jitter=False),
            center_crop_spec(vr.width, vr.height), (SIZE, SIZE)))
    with torch.inference_mode():
        ref_v = model.encode_image(normalize_video(
            torch.from_numpy(np.stack(clips)), dtype=torch.float32)).numpy()
        ref_t = model.encode_text(torch.from_numpy(tokenize(texts)).long()
                                  ).numpy()
    cos_v, cos_t = (ref_v * v_emb).sum(-1), (ref_t * t_emb).sum(-1)
    log(f"(d) embed_videos on the card ({wall:.2f} s, {len(paths)} clips, "
        f"{len(texts)} texts) against the CPU plain path in f32: cosine "
        f"video min {cos_v.min():.6f}, text min {cos_t.min():.6f} (bound "
        f"0.99)")
    if min(cos_v.min(), cos_t.min()) < 0.99:
        raise RuntimeError("embed_videos disagrees with the CPU reference")


def _profile_sweep(enc, cfg, suite: str = "ek100_mir") -> None:
    """(e) One suite's sweep under torch.profiler: wall, device busy (the
    union of the device's intervals), idle share, and the device time by
    kind of kernel."""
    from torch.profiler import ProfilerActivity, profile

    from avion_tpu_torch.eval.validate import build_suites, validate_all

    suites = build_suites(cfg.data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        validate_all(enc, {suite: suites[suite]}, strict=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = _device_busy_ms(prof)
    st = enc.suite_stats[suite]
    if not busy:
        log("(e) profile: the profiler saw no device time (not measured)")
        return
    log(f"(e) profile of one {suite} sweep ({st['image_rows']} clips, "
        f"{st['text_rows']} texts, {st['image_calls']} + {st['text_calls']} "
        f"tower forwards): wall {wall:.2f} ms, device busy {busy:.3f} ms, "
        f"idle share {1 - busy / wall:.4f}, data wait "
        f"{st['data_wait_s'] * 1e3:.2f} ms; device time by kind:")
    log_device_time(_device_ms_by_name(prof))


def _check_eval_shapes(shapes: list) -> list:
    """The inference forward (bf16) against its plain f32 version on seeded
    randn inputs at every shape the eval paths gave it, with the tolerances
    of phase_kernel; returns the rows."""
    rows, bad = [], []
    for i, (b, s, h, d, causal) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(i)
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        fa.reset_launches()
        with torch.inference_mode():
            out = fa.flash_attention_fused_qkv(qkv, h, s, causal=causal)
        torch.cuda.synchronize()
        if dict(fa.launches) != {"flash_fwd": 1}:
            raise RuntimeError(f"flash_fwd launches {dict(fa.launches)}")
        ref = fa.flash_attention_fused_qkv_plain(qkv.float(), h, s,
                                                 causal=causal)
        err, rel = _errors(out, ref)
        del ref
        row = {"shape": [b, s, h, d], "causal": causal, "path": "eval",
               "max_abs_err": err, "rel_rms_err": rel,
               "kernel_ms": cuda_ms(lambda: fa.flash_attention_fused_qkv(
                   qkv, h, s, causal=causal))}
        row["bound_ms"], row["bound_by"] = bound(b, s, h, d, causal)
        rows.append(row)
        log("flash_fwd at an eval shape " + json.dumps(row))
        if not (err <= TOL and rel <= REL_TOL):  # NaN fails too
            bad.append(f"{[b, s, h, d]} causal={causal}: max abs err {err}, "
                       f"rms err / rms out {rel}")
    if bad:
        raise RuntimeError("flash_fwd disagrees with its plain version at "
                           "eval shapes: " + "; ".join(bad))
    return rows


def phase_eval(tmp: str, fixture: tuple, ckpt: str) -> dict:
    """The eval slice's main paths at full width: (a) evals inside
    ``pretrain_clip.main``; (b) ``eval.validate.main``, strict, on the
    serve phase's seeded checkpoint over the five suites, each with its
    wall time, clips/s, data-wait share and metrics; (c) its launches
    against its tower forwards; (d) ``tools.embed_videos`` against the
    CPU; (e) the idle share of a profiled sweep; then the inference
    forward against its plain version at every shape (a) and (b) gave it.
    Returns the launches of (a) and (b) and those checks' rows."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.eval import validate

    log(f"== eval: the five zero-shot suites on {MODEL} at {FRAMES} frames, "
        f"val batch {EVAL_BATCH}")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fx = write_eval_fixtures(os.path.join(tmp, "eval"))
    log(f"fixtures ({EVAL_SIZES}) written in {time.perf_counter() - t0:.2f} s")
    # the inference forward's shapes on (a) and (b), ragged chunks included
    fwd_shapes, fwd = set(), fa._fwd_cuda

    def recording(qkv, heads, s, causal, sm_scale, with_lse):
        if not with_lse:
            fwd_shapes.add((qkv.shape[0], s, heads,
                            qkv.shape[-1] // (3 * heads), bool(causal)))
        return fwd(qkv, heads, s, causal, sm_scale, with_lse)

    args = _eval_args(fx, ckpt)
    saved_env = {k: os.environ.get(k) for k in fx["env"]}
    captured = None
    fa._fwd_cuda = recording
    try:
        with_eval = _eval_in_training(tmp, fx, fixture)
        os.environ.update(fx["env"])
        captured = _Captured(validate)
        torch.cuda.synchronize()
        fa.reset_launches()  # (b)'s main path, counted from here
        t0 = time.perf_counter()
        res = validate.main(args)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        wall = time.perf_counter() - t0
        (enc,) = captured.made
        forwards = captured.forwards()
        log(f"(b) validate.main wall {wall:.2f} s (model build and load "
            f"included)")
        for name, st in enc.suite_stats.items():
            log(f"  {name}: wall {st['wall_s']:.3f} s, {st['image_rows']} "
                f"clips ({st['image_rows'] / st['wall_s']:.2f} clips/s), "
                f"{st['text_rows']} texts, data-wait share "
                f"{st['data_wait_s'] / st['wall_s']:.4f}, tower forwards "
                f"{st['image_calls']} + {st['text_calls']}; " + ", ".join(
                    f"{k[len(name) + 6:]}={v:.4f}" for k, v in res.items()
                    if k.startswith(f"test_{name}_")))
        log(f"(c) launches {launches} for {forwards} tower forwards "
            f"(expected {LAYERS} per forward)")
        if set(enc.suite_stats) != {"ek100_mir", "ek100_cls", "egtea",
                                    "charades_ego", "egomcq"}:
            raise RuntimeError(f"suites run: {sorted(enc.suite_stats)}")
        if not res or not all(np.isfinite(v) for v in res.values()):
            raise RuntimeError(f"bad eval metrics {res}")
        if launches != {"flash_fwd": LAYERS * forwards}:
            raise RuntimeError(f"eval launched {launches} for {forwards} "
                               f"tower forwards")
        _profile_sweep(enc, TrainConfig().apply_overrides(args))
        del enc
        captured.made.clear()
    finally:
        fa._fwd_cuda = fwd
        if captured is not None:
            captured.restore()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    checks = _check_eval_shapes(sorted(fwd_shapes))
    _embed_check(tmp, fx, ckpt)
    log(f"eval phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"with_eval": with_eval, "eval": launches, "checks": checks}


# the VideoMAE slice: ViT-B/16 at 16 frames and 224 px, batch 128 (the JAX
# package's bench_videomae batch; the recipe's 512 is four cards' share),
# trained with the recipes of scripts/examples/videomae_{pretrain,
# finetune}_k400.sh
VMAE_MODEL, VMAE_FT_MODEL, VMAE_H128 = ("VIDEOMAE_VITB16", "VIDEOMAE_VITB16_FT",
                                        "VIDEOMAE_VITB16_H128")
VMAE_FRAMES, VMAE_BATCH, VMAE_STEPS, VMAE_FT_STEPS = 16, 128, 8, 5
VMAE_CHECK_BATCH, VMAE_REF_BATCH, VMAE_SHORT_STEPS = 8, 2, 2
VMAE_PRETRAIN_RECIPE = [
    f"model.name={VMAE_MODEL}", "model.use_grad_checkpointing=true",
    f"data.clip_length={VMAE_FRAMES}", "data.clip_stride=4",
    "data.mask_ratio=0.9", "optim.optimizer=adamw", "optim.lr=1.5e-4",
    "optim.wd=0.05", "optim.betas=0.9,0.95", "optim.warmup_epochs=40",
    "optim.epochs=800", "print_freq=1"]
VMAE_FINETUNE_RECIPE = [
    f"model.name={VMAE_FT_MODEL}", "model.use_grad_checkpointing=true",
    f"data.clip_length={VMAE_FRAMES}", "optim.optimizer=adamw",
    "optim.lr=1e-3", "optim.wd=0.05", "optim.layer_decay=0.75",
    "optim.warmup_epochs=5", "optim.epochs=75", "mixup=0.8", "cutmix=1.0",
    "smoothing=0.1", "use_ema=true", "data.rand_aug=true",
    "data.erase_prob=0.25", "data.repeated_aug=2", "print_freq=1"]
# (tower, S, heads, head_dim): the encoder on the 160 visible tokens, the
# decoder and the finetune ViT on all 1568, and VIDEOMAE_VITB16_H128's
VMAE_SHAPES = [("encoder", 160, 12, 64, False),
               ("decoder", 1568, 6, 64, False),
               ("finetune", 1568, 12, 64, False),
               ("encoder_h128", 160, 6, 128, False),
               ("decoder_h128", 1568, 3, 128, False)]
# a synthetic Kinetics layout: 340x256 at 30 fps (the short side Kinetics
# is usually resized to), 96 frames (the 16-frame stride-4 span is 64)
K400_VIDEOS, K400_FRAMES, K400_W, K400_H, K400_FPS = 256, 96, 340, 256, 30
VMAE_DATA_BATCH, VMAE_DATA_STEPS = 64, 4
VMAE_FT_BATCH, VMAE_FT_VAL_VIDEOS, VMAE_FT_VIEWS = 8, 8, (5, 3)


def _slice_kernel_rows(shapes, check_batch: int, time_batch: int,
                       seed: int, what: str,
                       forward_only: bool = False) -> dict:
    """Every kernel at a slice's ``shapes`` ((tower, S, heads, head_dim,
    causal)): errors against the plain f32 version at ``check_batch``
    (phase 3's tolerances; the plain f32 scores at batch 128 and S 1568
    alone are 7.5 GB), the plain version's time there, and the kernel's,
    its bound's and SDPA's at ``time_batch``; the forward kernels alone
    with ``forward_only``.  Returns rows by kernel."""
    rows = {name: [] for name in fa.KERNELS}
    bad = []
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def check(name, tower, **errs):
        for key, (err, limit) in errs.items():
            if not err <= limit:  # NaN fails too
                bad.append(f"{name} {tower}: {key} {err} > {limit}")

    def launched(fn, want):
        fa.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        if dict(fa.launches) != want:
            raise RuntimeError(f"launches {dict(fa.launches)}, want {want}")
        return out

    for tower, s, h, d, causal in shapes:
        w, scale, b = h * d, d ** -0.5, check_batch
        qkv = torch.randn(b, s, 3 * w, generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        do = torch.randn(b, s, w, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        ref, lse_ref = fa.flash_fwd_lse_plain(qkv.float(), h, s, causal,
                                              scale)
        out_i = launched(lambda: fa.flash_attention_fused_qkv(
            qkv, h, s, causal=causal), {"flash_fwd": 1})
        err_i = _errors(out_i, ref)
        out, lse = launched(lambda: fa.flash_fwd_lse(qkv, h, s, causal,
                                                     scale),
                            {"flash_fwd_lse": 1})
        err_l = _errors(out, ref)
        lse_err = (lse - lse_ref).abs().max().item()
        combined = fa.use_combined_bwd(s)
        names = (["flash_bwd_combined"] if combined
                 else ["flash_bwd_dq", "flash_bwd_dkv"])
        errs = {}
        if not forward_only:
            got = launched(lambda: fa.flash_bwd(do, qkv, out, lse, h, s,
                                                causal, scale),
                           {n: 1 for n in names})
            gref = fa.flash_bwd_plain(do.float(), qkv.float(), ref, lse_ref,
                                      h, s, causal, scale)
            errs = {sec: _errors(got[..., i * w:(i + 1) * w],
                                 gref[..., i * w:(i + 1) * w])
                    for i, sec in enumerate(("dq", "dk", "dv"))}
            del got, gref
        del ref, lse_ref
        check("flash_fwd", tower, max_abs_err=(err_i[0], TOL),
              rel_rms_err=(err_i[1], REL_TOL))
        check("flash_fwd_lse", tower, max_abs_err=(err_l[0], TOL),
              rel_rms_err=(err_l[1], REL_TOL), lse_max_abs_err=(lse_err,
                                                                LSE_TOL))
        for sec, (err, rel) in errs.items():
            check("backward", tower, **{
                f"{sec}_max_abs_err": (err, TOL),
                f"{sec}_rel_rms_err": (rel, BWD_REL_TOL)})
        plain = {"fwd": cuda_ms(lambda: fa.flash_fwd_lse_plain(
            qkv, h, s, causal, scale), iters=3)}
        if not forward_only:
            plain["bwd"] = cuda_ms(lambda: fa.flash_bwd_plain(
                do, qkv, out, lse, h, s, causal, scale), iters=3)
        del qkv, do, out, lse
        # the full batch: times only
        bb = time_batch
        qkv = torch.randn(bb, s, 3 * w, generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        do = torch.randn(bb, s, w, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        out, lse = fa.flash_fwd_lse(qkv, h, s, causal, scale)
        q, k, v = (t.detach().requires_grad_() for t in
                   _sdpa_inputs(qkv, bb, s, h, d))
        do_h = do.view(bb, s, h, d).transpose(1, 2)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal)

        with torch.no_grad():
            sdpa_fwd = cuda_ms(sdpa)
        base = {"tower": tower, "shape": [bb, s, h, d], "causal": causal,
                "check_batch": b}
        for name, err, fn, nrows in (
                ("flash_fwd", err_i, lambda: fa.flash_attention_fused_qkv(
                    qkv, h, s, causal=causal), 0),
                ("flash_fwd_lse", err_l,
                 lambda: fa.flash_fwd_lse(qkv, h, s, causal, scale), 1)):
            row = dict(base, max_abs_err=err[0], rel_rms_err=err[1],
                       kernel_ms=cuda_ms(fn), plain_ms=plain["fwd"],
                       library_ms=sdpa_fwd)
            if name == "flash_fwd_lse":
                row["lse_max_abs_err"] = lse_err
            row["bound_ms"], row["bound_by"] = bound(bb, s, h, d, causal,
                                                     rows=nrows)
            rows[name].append(row)
            log(f"{name} " + json.dumps(row))
        if forward_only:
            del qkv, do, out, lse, q, k, v
            torch.cuda.empty_cache()
            continue
        sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
            sdpa(), (q, k, v), do_h)) - sdpa_fwd
        bwd = dict(base, max_abs_err=max(e[0] for e in errs.values()),
                   **{f"{sec}_max_abs_err": e[0] for sec, e in errs.items()},
                   **{f"{sec}_rel_rms_err": e[1] for sec, e in errs.items()},
                   plain_ms=plain["bwd"], library_ms=sdpa_bwd,
                   route_ms=cuda_ms(lambda: fa.flash_bwd(
                       do, qkv, out, lse, h, s, causal, scale)))
        parts = ([("flash_bwd_combined", None, 5, 8, 2)] if combined else
                 [("flash_bwd_dq", "dq", 3, 6, 1),
                  ("flash_bwd_dkv", "dkv", 4, 6, 2)])
        for name, part, products, tensors, nrows in parts:
            row = dict(bwd, kernel_ms=bwd["route_ms"] if part is None else
                       cuda_ms(lambda: fa._bwd_cuda(do, qkv, out, lse, h, s,
                                                    causal, scale,
                                                    route=part)))
            row["bound_ms"], row["bound_by"] = bound(
                bb, s, h, d, causal, products, tensors, nrows)
            rows[name].append(row)
            log(f"{name} " + json.dumps(row))
        del qkv, do, out, lse, q, k, v
        torch.cuda.empty_cache()
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"{what}: " + "; ".join(bad))
    return rows


def _vmae_batches(model, n: int, batch: int, mask_ratio: float) -> list:
    """Seeded batches in the Kinetics datasets' collate contract: uint8
    clips at the model's size, tube masks and labels."""
    from avion_tpu_torch.data.transforms import tube_mask_batch

    size, g = model.image_size, model.image_size // model.patch_size
    out = []
    for seed in range(n):
        rng = np.random.default_rng(100 + seed)
        out.append({
            "video": rng.integers(0, 256, (batch, model.num_frames, size,
                                           size, 3), dtype=np.uint8),
            "mask": tube_mask_batch(np.random.RandomState(seed), batch,
                                    model.num_frames // model.tubelet_size,
                                    g, g, mask_ratio),
            "label": rng.integers(0, 400, batch)})
    return out


def _vmae_flops(model, batch: int) -> float:
    """6 x parameters x tokens for each tower on its own tokens (the
    encoder with patch_embed, its norm and encoder_to_decoder on the
    visible tokens; the decoder with its norm and head on all of them; the
    finetune ViT's head on the pooled vector is left out) plus 12 B H S^2 D
    per attention layer."""
    params = dict(model.named_parameters())
    prefixes = ([("patch_embed", "encoder.", "encoder_norm",
                  "encoder_to_decoder"),
                 ("decoder.", "decoder_norm", "decoder_head")]
                if hasattr(model, "decoder") else [("patch_embed", "encoder.")])
    towers = [(p, s, tower) for p, (tower, s) in
              zip(prefixes, _vmae_towers(model))]
    flops = 0
    for prefixes, s, tower in towers:
        n = sum(p.numel() for k, p in params.items() if k.startswith(prefixes))
        width = tower.resblocks[0].attn.Wqkv.in_features
        flops += 6 * n * batch * s \
            + 12 * batch * s * s * width * len(tower.resblocks)
    return flops


def _vmae_towers(model) -> list:
    """(tower, its sequence length): the encoder on the visible tokens and
    the decoder on all of them, or the finetune ViT on all."""
    if hasattr(model, "decoder"):
        return [(model.encoder, model.n_visible),
                (model.decoder, model.num_patches)]
    return [(model.encoder, model.pos_embed.shape[0])]


def _step_launches(towers) -> dict:
    """Per train step with save_attn, for ``towers`` ((transformer, S)): a
    forward with lse per attention layer, and its backward, combined while
    S <= 1024, else split."""
    want: dict = {}
    for tower, s in towers:
        for name in (["flash_fwd_lse", "flash_bwd_combined"]
                     if fa.use_combined_bwd(s) else
                     ["flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"]):
            want[name] = want.get(name, 0) + len(tower.resblocks)
    return want


def _vmae_launches(model) -> dict:
    return _step_launches(_vmae_towers(model))


def _act_launches(model) -> dict:
    """QuickGELU's launches a train step: in each tower whose MLP takes it,
    a forward and a backward per layer, and one more forward per layer
    where remat re-runs the block in the backward."""
    from avion_tpu_torch.models.layers import Transformer

    want: dict = {}
    for tower in model.modules():
        if not (isinstance(tower, Transformer) and getattr(
                getattr(tower.resblocks[0], "mlp", None), "act",
                None) is act.quick_gelu):
            continue
        n = len(tower.resblocks)
        for name, k in (("quick_gelu_fwd", 2 if tower.remat else 1),
                        ("quick_gelu_bwd", 1)):
            want[name] = want.get(name, 0) + k * n
    return want


def _check_act(label: str, got: dict, per_step: dict, steps: int,
               forwards: int = 0) -> None:
    """``got``, the QuickGELU launches of a path, against ``steps`` train
    steps of ``per_step`` and ``forwards`` inference forwards of one
    LAYERS-deep tower."""
    want = {k: v * steps for k, v in per_step.items()}
    if want and forwards:
        want["quick_gelu_fwd"] += LAYERS * forwards
    log(f"{label}: QuickGELU launches {got} (expected {want}; a train step "
        f"{per_step})")
    if got != want:
        raise RuntimeError(f"{label}: QuickGELU launches {got}, expected "
                           f"{want}")


def _report_run(label: str, res: dict, batch: int, steps: int,
                per_step: dict, flops: float) -> dict:
    """Finite losses, every step applied, the launches of ``steps`` steps
    (``per_step`` each); logs and returns p50 (from the third step),
    clips/s, share of 989 TFLOP/s (``flops`` a step) and peak memory."""
    losses = [m["loss"] for m in res["metrics"]]
    oks = [m["step_ok"] for m in res["metrics"]]
    want = {k: v * steps for k, v in per_step.items()}
    log(f"{label}: losses {losses}; step_ok {oks}; step ms "
        f"{[round(float(x), 3) for x in res['step_ms']]}; launches "
        f"{res['launches']} (expected {want})")
    if (len(losses) != steps or not np.isfinite(losses).all()
            or oks != [1.0] * steps):
        raise RuntimeError(f"{label}: a train step failed")
    if res["launches"] != want:
        raise RuntimeError(f"{label}: launches {res['launches']}, "
                           f"expected {want}")
    # from the third step; a two-step run, its second
    steady = res["step_ms"][2:] if steps > 2 else res["step_ms"][1:]
    p50 = float(np.median(steady))
    out = {"p50_ms": p50, "clips_per_s": batch * len(steady) / steady.sum()
           * 1e3, "share_of_989": flops / (p50 * 1e-3) / H100_BF16_FLOPS,
           "peak_gib": res["peak"] / 2 ** 30, "model_flops": flops}
    log(f"{label}: p50 of steps {steps - len(steady) + 1}-{steps} "
        f"{p50:.3f} ms, {out['clips_per_s']:.2f} clips/s, "
        f"model flops a step {flops:.4e} ({flops / (p50 * 1e-3) / 1e12:.2f} "
        f"TFLOP/s, {out['share_of_989']:.4f} of 989; remat's extra forward "
        f"not counted), peak memory allocated {out['peak_gib']:.3f} GiB")
    return out


def _vmae_reference(model_gpu, cfg, batch: dict) -> None:
    """One pretraining loss and gradient on the card (bf16, kernels) and on
    the CPU through the plain path in f32, from the same weights and mask
    (DropPath off)."""
    from avion_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from avion_tpu_torch.losses.losses import videomae_loss
    from avion_tpu_torch.train.steps import prep_video
    from avion_tpu_torch.train.videomae_pretrain import build_model

    def loss(model, b):
        video = prep_video(b["video"], model.dtype, mean=IMAGENET_MEAN,
                           std=IMAGENET_STD)
        pred, idx = model(video, b["mask"])
        return videomae_loss(pred, video, idx, model.patch_size,
                             model.tubelet_size)["loss"]

    cpu = build_model(cfg, torch.float32).to_empty(device="cpu")
    cpu.init_weights()  # the sincos tables
    _reference_grads(model_gpu, cpu, batch, loss,
                     f"VideoMAE reference step at batch {VMAE_REF_BATCH}")


def _vmae_seeded_pretrain(tmp: str) -> dict:
    """(b): seeded pretraining through ``build_model_and_state`` and
    ``train.loop``: 8 steps, a profiled step, a step against the CPU, an
    exact resume; two H128 steps; an echoed batch with regen_mask."""
    from avion_tpu_torch.train.loop import save_epoch, setup_run
    from avion_tpu_torch.train.steps import make_videomae_train_step
    from avion_tpu_torch.train.videomae_pretrain import build_model_and_state

    out_dir = os.path.join(tmp, "vmae_seeded")
    cfg = _train_config(out_dir, f"data.batch_size={VMAE_BATCH}",
                        recipe=VMAE_PRETRAIN_RECIPE)
    cfg.optim.lr *= VMAE_BATCH / 256  # as videomae_pretrain.main does
    log(f"== (b) {VMAE_MODEL} pretraining, {VMAE_FRAMES} frames, batch "
        f"{VMAE_BATCH}, {VMAE_STEPS} steps (lr {cfg.optim.lr:.3e}, betas "
        f"{cfg.optim.betas}, wd {cfg.optim.wd}, save_attn)")
    t0 = time.perf_counter()
    model, opt, _ = build_model_and_state(cfg, VMAE_STEPS)
    step_fn = make_videomae_train_step(model, model.patch_size,
                                       model.tubelet_size, seed=cfg.seed + 1)
    run = setup_run(cfg, model, opt, step_fn)
    batches = _vmae_batches(model, 3, VMAE_BATCH, cfg.data.mask_ratio)
    log(f"model and batches ready in {time.perf_counter() - t0:.1f} s; "
        f"{model.n_visible} visible of {model.num_patches} tokens")
    res = _timed_epoch(run, [batches[i % 3] for i in range(VMAE_STEPS)])
    report = _report_run("(b) seeded pretraining", res, VMAE_BATCH,
                         VMAE_STEPS, _vmae_launches(model),
                         _vmae_flops(model, VMAE_BATCH))
    report["launches"] = res["launches"]
    profile_step(run, _to_device(batches[0]))
    _vmae_reference(model, cfg, {k: v[:VMAE_REF_BATCH]
                                 for k, v in batches[1].items()})
    save_epoch(run, 0, {})
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    saved_opt = opt.state_dict()
    del run, model, opt, step_fn
    torch.cuda.empty_cache()
    model2, opt2, _ = build_model_and_state(_train_config(
        out_dir, "seed=1", recipe=VMAE_PRETRAIN_RECIPE), VMAE_STEPS)
    run2 = setup_run(cfg, model2, opt2, make_videomae_train_step(model2))
    same = run2.state.step == VMAE_STEPS + 1 and _same_state(
        run2.state, saved, saved_opt)
    log(f"resume into a model built from another seed: step, parameters "
        f"and AdamW moments bit for bit: {same}")
    if not same:
        raise RuntimeError("VideoMAE resume did not restore the state")
    del run2, model2, opt2, saved, saved_opt
    torch.cuda.empty_cache()

    # VIDEOMAE_VITB16_H128: both towers at head_dim 128
    cfg_h = _train_config(os.path.join(tmp, "vmae_h128"),
                          f"model.name={VMAE_H128}",
                          f"data.batch_size={VMAE_BATCH}",
                          recipe=VMAE_PRETRAIN_RECIPE)
    model, opt, _ = build_model_and_state(cfg_h, VMAE_SHORT_STEPS)
    run = setup_run(cfg_h, model, opt, make_videomae_train_step(model))
    dims, fwd, bwd = set(), fa._fwd_cuda, fa._bwd_cuda

    def fwd_rec(qkv, heads, *a, **k):
        dims.add(qkv.shape[-1] // (3 * heads))
        return fwd(qkv, heads, *a, **k)

    def bwd_rec(do, qkv, out, lse, heads, *a, **k):
        dims.add(qkv.shape[-1] // (3 * heads))
        return bwd(do, qkv, out, lse, heads, *a, **k)

    fa._fwd_cuda, fa._bwd_cuda = fwd_rec, bwd_rec
    try:
        res_h = _timed_epoch(run, batches[:VMAE_SHORT_STEPS])
    finally:
        fa._fwd_cuda, fa._bwd_cuda = fwd, bwd
    report["h128"] = _report_run(f"(b) {VMAE_H128}", res_h, VMAE_BATCH,
                                 VMAE_SHORT_STEPS, _vmae_launches(model),
                                 _vmae_flops(model, VMAE_BATCH))
    report["h128"]["launches"] = res_h["launches"]
    want_dims = {blk.attn.Wqkv.in_features // blk.attn.heads
                 for tower, _ in _vmae_towers(model)
                 for blk in tower.resblocks}
    log(f"(b) {VMAE_H128} head dims launched: {sorted(dims)} (the model's "
        f"{sorted(want_dims)})")
    if dims != want_dims:
        raise RuntimeError(f"H128 launched head dims {sorted(dims)}")

    # an echoed batch: each repeat draws its own tube masks on the device
    cfg_e = _train_config(os.path.join(tmp, "vmae_echo"),
                          f"model.name={VMAE_H128}", "data.echo_factor=2",
                          recipe=VMAE_PRETRAIN_RECIPE)
    masks = []
    hook = model.register_forward_pre_hook(
        lambda m, args: masks.append(args[1].detach().cpu()))
    run = setup_run(cfg_e, model, opt, make_videomae_train_step(
        model, regen_mask=True, seed=cfg_e.seed + 1))
    try:
        res_e = _timed_epoch(run, batches[:1])
    finally:
        hook.remove()
    per_frame = (model.image_size // model.patch_size) ** 2
    frames = model.num_frames // model.tubelet_size
    counts = {int(c) for m in masks
              for c in m.view(len(m), frames, per_frame).sum(-1).unique()}
    differ = len(masks) == 2 and not torch.equal(masks[0], masks[1])
    log(f"(b) echo_factor=2: {len(masks)} steps on one batch, masks differ "
        f"{differ}, masked a frame {sorted(counts)}, losses "
        f"{[m['loss'] for m in res_e['metrics']]}")
    if not differ or counts != {int(per_frame * cfg_e.data.mask_ratio)} \
            or torch.equal(masks[0], torch.from_numpy(batches[0]["mask"])):
        raise RuntimeError("the echoed repeats did not draw new masks")
    report["echo_launches"] = res_e["launches"]
    del run, model, opt
    torch.cuda.empty_cache()
    return report, batches


def _vmae_data_pretrain(tmp: str, root: str, meta: str) -> dict:
    """(c): ``videomae_pretrain.main`` on the decoded Kinetics layout, with
    the idle share of its last two steps and their batch waits; a resume."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.data.datasets import AugmentSpec, KineticsDataset
    from avion_tpu_torch.train import videomae_pretrain

    out = os.path.join(tmp, "vmae_data")
    args = [*VMAE_PRETRAIN_RECIPE, f"output_dir={out}", f"data.root={root}",
            f"data.train_metadata={meta}",
            f"data.batch_size={VMAE_DATA_BATCH}",
            f"data.num_workers={min(8, os.cpu_count() or 1)}",
            "optim.epochs=1"]
    cfg = TrainConfig().apply_overrides(args)
    d = cfg.data
    ds = KineticsDataset(root, meta, clip_length=d.clip_length,
                         clip_stride=d.clip_stride, crop_size=224,
                         mask_ratio=d.mask_ratio,
                         augment=AugmentSpec(crop_size=224, mode="msc",
                                             hflip_prob=0.5))
    t0 = time.perf_counter()
    for i in range(16):
        ds[i % len(ds)]
    decode_ms = (time.perf_counter() - t0) / 16 * 1e3
    log(f"(c) one KineticsDataset item ({d.clip_length} frames at stride "
        f"{d.clip_stride}, msc crop, tube mask) in one process: "
        f"{decode_ms:.3f} ms ({VMAE_DATA_BATCH * decode_ms / 1e3:.2f} s a "
        f"batch)")
    profiler = _ProfileLastSteps(videomae_pretrain.make_videomae_train_step,
                                 VMAE_DATA_STEPS)
    videomae_pretrain.make_videomae_train_step = profiler
    try:
        torch.cuda.synchronize()
        fa.reset_launches()  # (c)'s main path, counted from here
        t0 = time.perf_counter()
        res = videomae_pretrain.main(args)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        wall = time.perf_counter() - t0
    finally:
        videomae_pretrain.make_videomae_train_step = profiler.make_step
    recs = [r for r in _train_log(out) if "train/loss" in r]
    losses = [r["train/loss"] for r in recs]
    with torch.device("meta"):
        model = videomae_pretrain.build_model(cfg)
    want = {k: v * VMAE_DATA_STEPS for k, v in _vmae_launches(model).items()}
    batch_ms = [r["perf/batch_time_win"] * 1e3 for r in recs]
    data_ms = [r["perf/data_time_win"] * 1e3 for r in recs]
    log(f"(c) {res['steps']} steps, losses {losses}, launches {launches}, "
        f"decode backend {res['decode_backend']}, transfers "
        f"{res['transfers']}; main() wall {wall:.2f} s; step ms "
        f"{[round(x, 3) for x in batch_ms]}, data wait ms "
        f"{[round(x, 3) for x in data_ms]}")
    if (res["steps"] != VMAE_DATA_STEPS or len(losses) != VMAE_DATA_STEPS
            or not np.isfinite(losses).all()):
        raise RuntimeError("(c) a data-fed VideoMAE step failed")
    if launches != want:
        raise RuntimeError(f"(c) launches {launches}, expected {want}")
    report = {"p50_ms": float(np.median(batch_ms[2:])),
              "p50_data_ms": float(np.median(data_ms[2:])),
              "decode_ms_a_clip": decode_ms, "launches": launches}
    if profiler.busy_ms:
        report["idle_share"] = 1 - profiler.busy_ms / profiler.wall_ms
        log(f"(c) profile of steps {VMAE_DATA_STEPS - 1}-{VMAE_DATA_STEPS} "
            f"with their batch waits: wall {profiler.wall_ms:.2f} ms, device "
            f"busy {profiler.busy_ms:.3f} ms, idle share "
            f"{report['idle_share']:.4f}")
    log(f"(c) steps 3-{VMAE_DATA_STEPS}: p50 step {report['p50_ms']:.3f} ms, "
        f"p50 data_time {report['p50_data_ms']:.3f} ms")
    fa.reset_launches()
    again = videomae_pretrain.main(args)
    if again["steps"] != 0 or again["step"] != res["step"] or fa.launches:
        raise RuntimeError(f"(c) the resume trained again: {again}")
    return report


def random_videomae_checkpoint(path: str, seed: int = 0) -> None:
    """A seeded random finetune checkpoint in the reference layout: fused
    ``attn.qkv.weight`` with split ``q_bias`` / ``v_bias`` (no key bias),
    ``patch_embed.proj`` as a [width, C, ts, p, p] Conv3d, ``blocks.N``,
    ``fc_norm`` and ``head``."""
    from avion_tpu_torch.models.registry import create_model

    with torch.device("meta"):
        m = create_model(VMAE_FT_MODEL, num_frames=VMAE_FRAMES)
    gen = torch.Generator().manual_seed(seed)
    width = m.head.in_features

    def r(*shape, scale=None):
        noise = torch.randn(*shape, generator=gen)
        return noise * (scale if scale is not None else
                        (math.prod(shape[1:]) ** -0.5 if len(shape) > 1
                         else 0.02))

    sd = {"patch_embed.proj.weight": r(width, 3, m.tubelet_size,
                                       m.patch_size, m.patch_size),
          "patch_embed.proj.bias": r(width), "fc_norm.weight": 1 + r(width),
          "fc_norm.bias": r(width), "head.weight": r(m.head.out_features,
                                                     width),
          "head.bias": r(m.head.out_features)}
    for i in range(len(m.encoder.resblocks)):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": 1 + r(width), p + "norm1.bias": r(width),
                   p + "norm2.weight": 1 + r(width), p + "norm2.bias": r(width),
                   p + "attn.qkv.weight": r(3 * width, width),
                   p + "attn.q_bias": r(width), p + "attn.v_bias": r(width),
                   p + "attn.proj.weight": r(width, width),
                   p + "attn.proj.bias": r(width),
                   p + "mlp.fc1.weight": r(4 * width, width),
                   p + "mlp.fc1.bias": r(4 * width),
                   p + "mlp.fc2.weight": r(width, 4 * width),
                   p + "mlp.fc2.bias": r(width)})
    torch.save({"model": sd}, path)


def _vmae_data_finetune(tmp: str, root: str, meta: str) -> dict:
    """(d), data-fed: ``videomae_finetune.main`` with the recipe's
    augmentation on a random reference-layout checkpoint, 2 steps, and the
    multi-view test on the EMA weights."""
    from avion_tpu_torch.train import videomae_finetune

    lines = open(meta).read().splitlines()
    n_train = 2 * VMAE_FT_BATCH
    lists = {}
    for name, part in (("train", lines[:n_train]),
                       ("val", lines[n_train:n_train + VMAE_FT_VAL_VIDEOS])):
        lists[name] = os.path.join(tmp, f"k400_{name}.txt")
        with open(lists[name], "w") as f:
            f.write("\n".join(part) + "\n")
    ckpt = os.path.join(tmp, "videomae_ft_random.pt")
    random_videomae_checkpoint(ckpt)
    out = os.path.join(tmp, "vmae_ft_data")
    clips, crops = VMAE_FT_VIEWS
    args = [*VMAE_FINETUNE_RECIPE, f"output_dir={out}", f"data.root={root}",
            f"data.train_metadata={lists['train']}",
            f"data.val_metadata={lists['val']}",
            f"data.batch_size={VMAE_FT_BATCH}",
            f"data.val_batch_size={VMAE_FT_VAL_VIDEOS}",
            f"data.num_clips={clips}", f"data.num_crops={crops}",
            f"data.num_workers={min(8, os.cpu_count() or 1)}",
            "optim.epochs=1", "eval_freq=1", f"pretrain_model={ckpt}"]
    torch.cuda.synchronize()
    fa.reset_launches()  # (d)'s data-fed path, training and test
    t0 = time.perf_counter()
    res = videomae_finetune.main(args)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    wall = time.perf_counter() - t0
    with torch.device("meta"):
        model = videomae_finetune.build_model(
            videomae_finetune.TrainConfig().apply_overrides(args))
    layers = len(model.encoder.resblocks)
    steps = len(lines[:n_train]) // VMAE_FT_BATCH
    forwards = -(-VMAE_FT_VAL_VIDEOS // VMAE_FT_VAL_VIDEOS)
    want = {k: v * steps for k, v in _vmae_launches(model).items()}
    want["flash_fwd"] = layers * forwards
    test = [r for r in _train_log(out) if "acc1" in r and "acc5" in r]
    log(f"(d) finetune main: {res['steps']} steps of {VMAE_FT_BATCH} videos "
        f"x 2 views (repeated_aug), epochs {res['epochs']}, test {res['eval']}, logged "
        f"{test}, launches {launches} (expected {want}), wall {wall:.2f} s")
    if res["steps"] != steps or not test or not all(
            np.isfinite(m["loss"]) for m in res["epochs"]):
        raise RuntimeError("(d) the data-fed finetune failed")
    if launches != want:
        raise RuntimeError(f"(d) launches {launches}, expected {want}")
    return {"launches": launches, "test": res["eval"], "wall_s": wall}


def _vmae_seeded_finetune(tmp: str, batches: list) -> dict:
    """(d), seeded: the finetune step (mixup, DropPath, layer decay, EMA) at
    batch 128 through ``build_model_and_state`` and ``train.loop``; then
    the EMA against its formula on the parameters the card produced."""
    from avion_tpu_torch.optim.factory import apply_batch_lr_scale
    from avion_tpu_torch.train.loop import setup_run
    from avion_tpu_torch.train.steps import make_cls_train_step
    from avion_tpu_torch.train.videomae_finetune import (build_model_and_state,
                                                         make_mixup)

    cfg = _train_config(os.path.join(tmp, "vmae_ft_seeded"),
                        f"data.batch_size={VMAE_BATCH}",
                        recipe=VMAE_FINETUNE_RECIPE)
    apply_batch_lr_scale(cfg.optim, VMAE_BATCH, default_base=256)
    model, opt, _ = build_model_and_state(cfg, VMAE_FT_STEPS)
    step_fn = make_cls_train_step(model, label_smoothing=cfg.smoothing,
                                  ema_decay=cfg.ema_decay,
                                  mixup_fn=make_mixup(cfg, 400),
                                  seed=cfg.seed + 1)
    run = setup_run(cfg, model, opt, step_fn, use_ema=True)
    log(f"== (d) {VMAE_FT_MODEL} finetune steps, batch {VMAE_BATCH}, "
        f"{VMAE_FRAMES} frames, remat, lr {cfg.optim.lr:.3e}, layer decay "
        f"{cfg.optim.layer_decay}, mixup {cfg.mixup} / cutmix {cfg.cutmix}, "
        f"EMA {cfg.ema_decay}")
    loader = [{k: b[k] for k in ("video", "label")}
              for b in (batches * 2)[:VMAE_FT_STEPS]]
    res = _timed_epoch(run, loader)
    report = _report_run("(d) seeded finetune", res, VMAE_BATCH,
                         VMAE_FT_STEPS, _vmae_launches(model),
                         _vmae_flops(model, VMAE_BATCH))
    report["launches"] = res["launches"]
    # two more steps, keeping what the EMA is made from
    names = list(run.state.ema)
    params = dict(model.named_parameters())
    ema0 = [run.state.ema[n].clone() for n in names]
    after = []
    for b in loader[:2]:
        run.state, metrics = run.step(run.state, _to_device(b))
        if metrics["step_ok"] != 1.0:
            raise RuntimeError("(d) a finetune step was skipped")
        after.append([params[n].detach().clone() for n in names])
    want = ema0
    d = cfg.ema_decay
    for ps in after:
        want = [e * d + p * (1.0 - d) for e, p in zip(want, ps)]
    same = all(torch.equal(run.state.ema[n], w) for n, w in zip(names, want))
    moved = not all(torch.equal(run.state.ema[n], e)
                    for n, e in zip(names, ema0))
    log(f"(d) EMA after 2 more steps equals e * {d} + (1 - {d}) * p on the "
        f"card's parameters, bit for bit: {same}; it moved: {moved}")
    if not (same and moved):
        raise RuntimeError("(d) the EMA does not follow its formula")
    del run, model, opt, after, ema0, want
    torch.cuda.empty_cache()
    return report


def phase_videomae(tmp: str) -> dict:
    """The VideoMAE slice's paths at full width: (a) the kernels at its
    shapes; (b) seeded pretraining; (c) data-fed pretraining through
    ``videomae_pretrain.main``; (d) data-fed finetuning through
    ``videomae_finetune.main`` with its test, and seeded finetune steps.
    Returns the kernel rows and every path's launches."""
    t_phase = time.perf_counter()
    log(f"== videomae (a): kernels at the VideoMAE shapes, errors at batch "
        f"{VMAE_CHECK_BATCH}, times at batch {VMAE_BATCH}")
    rows = _slice_kernel_rows(VMAE_SHAPES, VMAE_CHECK_BATCH, VMAE_BATCH, 7,
                              "the VideoMAE shapes")
    pre, batches = _vmae_seeded_pretrain(tmp)
    root = os.path.join(tmp, "k400")
    t0 = time.perf_counter()
    meta = write_k400_fixture(root, videos=K400_VIDEOS, frames=K400_FRAMES,
                              w=K400_W, h=K400_H, fps=K400_FPS)
    log(f"== (c) Kinetics layout: {K400_VIDEOS} videos of {K400_FRAMES} "
        f"frames at {K400_W}x{K400_H}, {K400_FPS} fps (mp4v), written in "
        f"{time.perf_counter() - t0:.2f} s")
    data = _vmae_data_pretrain(tmp, root, meta)
    ft_data = _vmae_data_finetune(tmp, root, meta)
    ft = _vmae_seeded_finetune(tmp, batches)
    del batches
    summary = {"pretrain_seeded": {k: v for k, v in pre.items()
                                   if k not in ("launches", "h128",
                                                "echo_launches")},
               "pretrain_h128": {k: v for k, v in pre["h128"].items()
                                 if k != "launches"},
               "pretrain_data": {k: v for k, v in data.items()
                                 if k != "launches"},
               "finetune_seeded": {k: v for k, v in ft.items()
                                   if k != "launches"},
               "finetune_test": ft_data["test"]}
    log(f"videomae summary {json.dumps(summary)}")
    log(f"videomae phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "paths": {
        "videomae_pretrain_seeded": pre["launches"],
        "videomae_pretrain_h128": pre["h128"]["launches"],
        "videomae_pretrain_echo": pre["echo_launches"],
        "videomae_pretrain_data": data["launches"],
        "videomae_finetune_data_with_test": ft_data["launches"],
        "videomae_finetune_seeded": ft["launches"]}}


# the CLIP finetune slice: the recipes of scripts/examples/finetune_{mir,
# cls}_ek100.sh at one card's share (64) of their batch 512 over 8 cards, at
# 16 frames (3137 visual tokens), from a CLIP_VITB16 reference-layout .pt
FT_FRAMES, FT_BATCH, FT_STEPS, FT_SHORT_STEPS = 16, 64, 8, 2
FT_CHECK_BATCH, FT_REF_BATCH, FT_OPT_BATCH = 4, 2, 16
# the CLS reference's batch: the CPU pass at 3137 tokens takes about 26 s
# a clip; MIR's max-margin loss needs 2 rows
FT_CLS_REF_BATCH = 1
# the CPU references' clips: the first half of the 16 frames (1569 tokens,
# still the split backward on the card); at 16 frames the two f32 CPU
# steps took 76 s of the script's 1200
FT_REF_FRAMES = 8
FT_CLASSES = 3806  # EPIC-Kitchens-100's actions
FT_MIR_RECIPE = [
    f"model.name={MODEL}", "model.use_grad_checkpointing=true",
    f"data.clip_length={FT_FRAMES}", f"data.batch_size={FT_BATCH}",
    f"data.crop_size={SIZE}", "optim.optimizer=adamw", "optim.lr=1e-5",
    "optim.wd=0.05", "optim.warmup_epochs=1", "optim.epochs=100",
    "print_freq=1"]
FT_CLS_RECIPE = [
    f"model.name={MODEL}", "model.use_grad_checkpointing=true",
    "data.dataset=ek100_cls", f"data.clip_length={FT_FRAMES}",
    f"data.batch_size={FT_BATCH}", f"data.crop_size={SIZE}",
    "optim.optimizer=sgd", "optim.lr=0.012", "optim.wd=4e-5",
    "optim.warmup_epochs=2", "optim.epochs=100", "mixup=0.8",
    "print_freq=1"]
# (tower, S, heads, head_dim, causal): the visual tower at 16 frames, the
# text tower
FT_SHAPES = [("visual", 3137, 12, 64, False), ("text", 77, 8, 64, True)]
# the data-fed runs: 2 steps of the train split, the test split in one
# validation batch (MIR) or one batch of 2 views a clip (CLS)
EK_TRAIN_CLIPS, EK_TEST_CLIPS, FT_VIEWS = 2 * FT_BATCH, FT_BATCH, 2


def _ft_launches(model) -> dict:
    """A CLIP's or a classifier's launches a train step: the visual tower
    at its tokens, and the text tower."""
    v = model.visual
    towers = [(v.transformer, 1 + (v.positional_embedding.shape[0] - 1)
               * v.temporal_embedding.shape[0])]
    if hasattr(model, "textual"):
        towers.append((model.textual.transformer,
                       model.textual.positional_embedding.shape[0]))
    return _step_launches(towers)


def _cls_batches(n: int, batch: int) -> list:
    """Seeded uint8 clips and action labels."""
    out = []
    for seed in range(n):
        rng = np.random.default_rng(200 + seed)
        out.append({"video": rng.integers(0, 256, (batch, FT_FRAMES, SIZE,
                                                   SIZE, 3), dtype=np.uint8),
                    "label": rng.integers(0, FT_CLASSES, batch)})
    return out


def _mir_loss(model, b: dict) -> torch.Tensor:
    from avion_tpu_torch.losses.losses import max_margin_ranking_loss
    from avion_tpu_torch.train.steps import prep_video

    out = model(prep_video(b["video"], dtype=model.dtype), b["text"].long())
    return max_margin_ranking_loss(out["image_embed"],
                                   out["text_embed"])["loss"]


def _cls_loss(model, b: dict) -> torch.Tensor:
    from avion_tpu_torch.losses.losses import softmax_cross_entropy
    from avion_tpu_torch.train.steps import prep_video

    return softmax_cross_entropy(
        model(prep_video(b["video"], dtype=model.dtype)), b["label"].long(),
        0.1)


def _ft_seeded(tmp: str, name: str, label: str) -> dict:
    """(b) MIR / (c) CLS: the recipe at batch FT_BATCH through the entry's
    ``build_model_and_state`` and ``train.loop``: FT_STEPS steps over 3
    seeded batches, a profiled step, a step against the CPU in f32 (batch
    FT_REF_BATCH for MIR, FT_CLS_REF_BATCH for CLS, FT_REF_FRAMES of the
    clips' frames), and an exact resume
    into a model built from another seed."""
    from avion_tpu_torch.optim.factory import apply_batch_lr_scale
    from avion_tpu_torch.train import finetune_cls, finetune_mir
    from avion_tpu_torch.train.loop import save_epoch, setup_run
    from avion_tpu_torch.train.steps import (make_cls_train_step,
                                             make_mir_finetune_step)
    from avion_tpu_torch.train.videomae_finetune import make_mixup

    out_dir = os.path.join(tmp, f"ft_{name}")
    mir = name == "mir"
    recipe = FT_MIR_RECIPE if mir else FT_CLS_RECIPE

    def build(cfg):
        if mir:
            model, opt, _ = finetune_mir.build_model_and_state(cfg, FT_STEPS)
            return model, opt, make_mir_finetune_step(model,
                                                      seed=cfg.seed + 1)
        apply_batch_lr_scale(cfg.optim, FT_BATCH, default_base=128)
        model, opt, _ = finetune_cls.build_model_and_state(cfg, FT_CLASSES,
                                                           FT_STEPS)
        return model, opt, make_cls_train_step(
            model, label_smoothing=cfg.smoothing,
            mixup_fn=make_mixup(cfg, FT_CLASSES), seed=cfg.seed + 1)

    cfg = _train_config(out_dir, recipe=recipe)
    t0 = time.perf_counter()
    model, opt, step_fn = build(cfg)
    run = setup_run(cfg, model, opt, step_fn)
    batches = (_train_batches(3, FT_BATCH, FT_FRAMES) if mir
               else _cls_batches(3, FT_BATCH))
    log(f"== {label}: {MODEL}, {FT_FRAMES} frames, batch {FT_BATCH}, "
        f"{FT_STEPS} steps, {cfg.optim.optimizer} lr {cfg.optim.lr:.3e} wd "
        f"{cfg.optim.wd}" + ("" if mir else f", mixup {cfg.mixup}, "
                                            f"{FT_CLASSES} classes")
        + f"; ready in {time.perf_counter() - t0:.1f} s")
    res = _timed_epoch(run, [batches[i % 3] for i in range(FT_STEPS)])
    report = _report_run(label, res, FT_BATCH, FT_STEPS, _ft_launches(model),
                         _model_flops(model, FT_BATCH))
    report["launches"] = res["launches"]
    report["profile"] = profile_step(run, _to_device(batches[0]))
    cpu = (finetune_mir.build_model(cfg, torch.float32) if mir else
           finetune_cls.build_classifier(cfg, FT_CLASSES, torch.float32))
    t0 = time.perf_counter()
    ref = FT_REF_BATCH if mir else FT_CLS_REF_BATCH
    _reference_grads(model, cpu.to_empty(device="cpu"),
                     {k: v[:ref, :FT_REF_FRAMES] if k == "video" else v[:ref]
                      for k, v in batches[1].items()},
                     _mir_loss if mir else _cls_loss,
                     f"{label}: reference step at batch {ref}, "
                     f"{FT_REF_FRAMES} frames")
    log(f"{label}: the CPU reference took {time.perf_counter() - t0:.1f} s")
    del cpu
    save_epoch(run, 0, {})
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    saved_opt = opt.state_dict()
    step = run.state.step
    del run, model, opt, step_fn
    torch.cuda.empty_cache()
    cfg2 = _train_config(out_dir, "seed=1", recipe=recipe)
    model2, opt2, step2 = build(cfg2)
    run2 = setup_run(cfg2, model2, opt2, step2)
    same = run2.state.step == step and _same_state(run2.state, saved,
                                                   saved_opt)
    log(f"{label}: resume at step {step} into a model built from another "
        f"seed: step, parameters and {opt2.name} state bit for bit: {same}")
    if not same:
        raise RuntimeError(f"{label}: resume did not restore the state")
    del run2, model2, opt2, saved, saved_opt
    torch.cuda.empty_cache()
    return report


def _ft_optimizers(tmp: str) -> dict:
    """(e) Lion, and AdamW with a cosine weight decay to ``wd_end``: the CLS
    recipe's classifier, FT_SHORT_STEPS seeded steps each at batch
    FT_OPT_BATCH, every step applied, finite, the parameters moved; the
    decayed groups hold the scheduled decay of the last update."""
    from avion_tpu_torch.optim.factory import build_wd_schedule
    from avion_tpu_torch.train import finetune_cls
    from avion_tpu_torch.train.loop import setup_run
    from avion_tpu_torch.train.steps import make_cls_train_step

    batches = [{k: v[:FT_OPT_BATCH] for k, v in b.items()}
               for b in _cls_batches(FT_SHORT_STEPS, FT_OPT_BATCH)]
    paths = {}
    for name, extra in (("lion", ["optim.optimizer=lion", "optim.lr=1e-5",
                                  "optim.wd=0.5", "optim.betas=0.9,0.99"]),
                        ("adamw_wd_end", ["optim.optimizer=adamw",
                                          "optim.lr=1e-4", "optim.wd=0.05",
                                          "optim.wd_end=0.2"])):
        cfg = _train_config(os.path.join(tmp, f"ft_{name}"), *extra,
                            "optim.warmup_epochs=0", "optim.epochs=1",
                            "mixup=0", recipe=FT_CLS_RECIPE)
        model, opt, _ = finetune_cls.build_model_and_state(
            cfg, FT_CLASSES, FT_SHORT_STEPS)
        before = [p.detach().clone() for p in model.parameters()]
        run = setup_run(cfg, model, opt, make_cls_train_step(model))
        res = _timed_epoch(run, batches)
        losses = [m["loss"] for m in res["metrics"]]
        oks = [m["step_ok"] for m in res["metrics"]]
        moved = sum(not torch.equal(a, p)
                    for a, p in zip(before, model.parameters()))
        wds = sorted({g["weight_decay"] for g in opt.inner.param_groups
                      if g["decays"]})
        wd_schedule = build_wd_schedule(cfg.optim, FT_SHORT_STEPS)
        want_wd = [wd_schedule(FT_SHORT_STEPS - 1) if wd_schedule
                   else cfg.optim.wd]
        log(f"(e) {name}: losses {losses}, step_ok {oks}, {moved} of "
            f"{len(before)} parameters moved, decayed groups' wd {wds} "
            f"(want {want_wd}), launches {res['launches']}")
        if (not np.isfinite(losses).all() or oks != [1.0] * FT_SHORT_STEPS
                or moved != len(before) or wds != want_wd):
            raise RuntimeError(f"(e) {name}: the optimizer did not apply")
        paths[f"finetune_{name}"] = res["launches"]
        del run, model, opt, before
        torch.cuda.empty_cache()
    return paths


def _ft_data(tmp: str, ckpt: str) -> dict:
    """(d) ``finetune_mir.main`` and ``finetune_cls.main`` (SGD, mixup) on a
    synthetic EK100 layout from the serve phase's random reference-layout
    checkpoint: FT_SHORT_STEPS steps each, then the MIR validation
    (``avg_map``, ``is_best``) or the CLS multi-view test (``acc1``, verb
    and noun top-1), with their launches; p50 step and data wait, decode
    ms a clip."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.train import finetune_cls, finetune_mir

    t0 = time.perf_counter()
    fx = write_ek100_fixture(os.path.join(tmp, "ek100_ft"),
                             train_clips=EK_TRAIN_CLIPS,
                             test_clips=EK_TEST_CLIPS)
    log(f"== (d) EK100 layout: {EK_TRAIN_CLIPS} train and {EK_TEST_CLIPS} "
        f"test windows over 4 videos of 2 chunks at {DATA_W}x{DATA_H}, "
        f"{DATA_FPS} fps (mp4v), written in "
        f"{time.perf_counter() - t0:.2f} s")
    common = [f"data.root={fx['root']}", f"data.train_metadata={fx['train']}",
              f"data.val_metadata={fx['test']}",
              f"data.chunk_len={DATA_CHUNK_S}",
              f"data.val_batch_size={FT_BATCH}",
              f"data.num_workers={min(8, os.cpu_count() or 1)}",
              "optim.epochs=1", "eval_freq=1", f"pretrain_model={ckpt}"]
    runs = {
        "mir": (finetune_mir, [*FT_MIR_RECIPE, *common,
                               f"data.relevancy_path={fx['relevancy']}"]),
        "cls": (finetune_cls, [*FT_CLS_RECIPE, *common,
                               f"data.label_map={fx['actions']}",
                               f"data.num_clips={FT_VIEWS}"])}
    ds, _ = finetune_mir.build_loader(finetune_mir.env_defaults(
        TrainConfig().apply_overrides(runs["mir"][1])))
    ds[0]
    t0 = time.perf_counter()
    for i in range(1, 9):
        ds[i % len(ds)]
    decode_ms = (time.perf_counter() - t0) / 8 * 1e3
    log(f"(d) one EK100 MIR training item ({FT_FRAMES} frames, rrc crop, "
        f"relevancy-sampled caption) in one process: {decode_ms:.3f} ms")
    report = {"decode_ms_a_clip": decode_ms}
    for name, (entry, args) in runs.items():
        out = os.path.join(tmp, f"ft_{name}_data")
        args = [*args, f"output_dir={out}"]
        torch.cuda.synchronize()
        fa.reset_launches()  # this entry's path, training and validation
        act.reset_launches()
        t0 = time.perf_counter()
        res = entry.main(args)
        torch.cuda.synchronize()
        launches, wall = dict(fa.launches), time.perf_counter() - t0
        act_launches = dict(act.launches)
        cfg = entry.env_defaults(TrainConfig().apply_overrides(args))
        if name == "mir":
            model = finetune_mir.build_model(cfg)
            forwards = 2 * -(-EK_TEST_CLIPS // FT_BATCH)  # video and text
            keys = ("avg_map", "avg_ndcg")
        else:
            model = finetune_cls.build_classifier(cfg, 100)
            forwards = -(-EK_TEST_CLIPS // FT_BATCH)
            keys = ("acc1", "verb_acc1", "noun_acc1")
        want = {k: v * FT_SHORT_STEPS for k, v in _ft_launches(model).items()}
        want["flash_fwd"] = LAYERS * forwards
        recs = [r for r in _train_log(out) if "train/loss" in r]
        step_ms = [r["perf/batch_time_win"] * 1e3 for r in recs]
        data_ms = [r["perf/data_time_win"] * 1e3 for r in recs]
        metrics = res["eval"].get(0, {})
        with open(os.path.join(out, "ckpt", str(res["step"]),
                               "extra.json")) as f:
            extra = json.load(f)
        log(f"(d) {name} main: {res['steps']} steps, losses "
            f"{[r['train/loss'] for r in recs]}, step ms "
            f"{[round(x, 3) for x in step_ms]}, data wait ms "
            f"{[round(x, 3) for x in data_ms]}, validation {metrics}, "
            f"is_best {extra['is_best']}, launches {launches} (expected "
            f"{want}), wall {wall:.2f} s")
        if (res["steps"] != FT_SHORT_STEPS
                or not all(np.isfinite(r["train/loss"]) for r in recs)
                or not all(np.isfinite(metrics.get(k, np.nan))
                           for k in keys) or not extra["is_best"]):
            raise RuntimeError(f"(d) the data-fed {name} finetune failed")
        if launches != want:
            raise RuntimeError(f"(d) {name}: launches {launches}, expected "
                               f"{want}")
        _check_act(f"(d) {name} main", act_launches, _act_launches(model),
                   FT_SHORT_STEPS, forwards)
        launches = {**launches, **act_launches}
        report[name] = {"p50_ms": float(np.median(step_ms)),
                        "p50_data_ms": float(np.median(data_ms)),
                        "wall_s": wall, "launches": launches,
                        "validation": {k: metrics[k] for k in keys}}
    return report


def phase_finetune(tmp: str, ckpt: str) -> dict:
    """The CLIP finetune slice's paths at full width, 16 frames: (a) the
    kernels at its shapes; (b) seeded MIR finetuning and (c) seeded CLS
    finetuning through the entries' builders and ``train.loop``; (d) both
    entries' ``main`` on decoded EK100 video with their validation; (e)
    Lion and AdamW with ``wd_end``.  Returns the kernel rows and every
    path's launches."""
    t_phase = time.perf_counter()
    log(f"== finetune (a): kernels at the finetune shapes, errors at batch "
        f"{FT_CHECK_BATCH}, times at batch {FT_BATCH}")
    rows = _slice_kernel_rows(FT_SHAPES, FT_CHECK_BATCH, FT_BATCH, 11,
                              "the finetune shapes")
    mir = _ft_seeded(tmp, "mir", "(b) seeded MIR finetune")
    cls = _ft_seeded(tmp, "cls", "(c) seeded CLS finetune")
    data = _ft_data(tmp, ckpt)
    paths = _ft_optimizers(tmp)
    summary = {"mir_seeded": {k: v for k, v in mir.items()
                              if k != "launches"},
               "cls_seeded": {k: v for k, v in cls.items()
                              if k != "launches"},
               "data": {k: ({kk: vv for kk, vv in v.items()
                             if kk != "launches"}
                            if isinstance(v, dict) else v)
                        for k, v in data.items()}}
    log(f"finetune summary {json.dumps(summary)}")
    log(f"finetune phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "paths": {
        "finetune_mir_seeded": mir["launches"],
        "finetune_cls_seeded": cls["launches"],
        "finetune_mir_data_with_validation": data["mir"]["launches"],
        "finetune_cls_data_with_test": data["cls"]["launches"], **paths}}


# the contrastive-extras slice: CLIP ViT-L/14 at 4 frames (1025 visual
# tokens), scripts/examples/pretrain_vitb_ego4d.sh with model.name=
# CLIP_VITL14 at the reference's global batch 896 (docs/TRAINING.md:23,
# 112 clips on each of 8 GPUs): on one card 8 cached microbatches of 112,
# bf16 optimizer state
CL_MODEL, CL_H128 = "CLIP_VITL14", "CLIP_VITL14_H128"
CL_BATCH, CL_MICRO, CL_STEPS = 896, 8, 2
CL_RECIPE = [*TRAIN_RECIPE, f"model.name={CL_MODEL}",
             f"data.batch_size={CL_BATCH}", f"optim.update_freq={CL_MICRO}",
             "optim.accum=cached", "optim.state_dtype=bfloat16"]
# (tower, S, heads, head_dim, causal): the visual tower (split backward,
# a last tile of one row), its head_dim-128 twin, the causal text tower;
# the 336 px visual tower (2305 tokens) forward only
CL_SHAPES = [("visual", 1025, 16, 64, False),
             ("visual_h128", 1025, 8, 128, False),
             ("text", 77, 12, 64, True)]
CL_FWD_SHAPES = [("visual_336px", 2305, 16, 64, False)]
CL_CHECK_BATCH, CL_TIME_BATCH = 4, 112
# (c) cached against one shot; (e), (f) the options and the entry at two
# microbatches of 112
CL_ACCUM_BATCH, CL_ACCUM_MICRO = 32, 4
CL_SHORT_BATCH, CL_SHORT_STEPS = 224, 2
CL_LOSS_RTOL, CL_COSINE = 1e-3, 0.99


def _accum_launches(model, micro: int) -> dict:
    """A cached-accumulation step's launches: for each of ``micro``
    microbatches, pass 1's inference forward in every attention layer of
    both towers, and pass 2's forward with lse and backward."""
    want = {k: v * micro for k, v in _ft_launches(model).items()}
    want["flash_fwd"] = micro * (len(model.visual.transformer.resblocks)
                                 + len(model.textual.transformer.resblocks))
    return want


def _cl_build(cfg, steps: int):
    """The configured CLIP, its optimizer and step, as the entry builds
    them."""
    from avion_tpu_torch.train.pretrain_clip import (build_model_and_state,
                                                     make_step)

    model, opt, _ = build_model_and_state(cfg, steps)
    return model, opt, make_step(cfg, model)


def _moment_dtypes(opt) -> set:
    return {v.dtype for s in opt.inner.state.values() for v in s.values()}


def _cl_accum_check(tmp: str, model) -> dict:
    """(c) ``update_freq=CL_ACCUM_MICRO`` cached against one step on the same
    weights and batch, both bf16 through the kernels (an AdamW at lr 0 and
    no clip keeps the weights and leaves each gradient in ``.grad``): loss
    within CL_LOSS_RTOL, gradient cosine at least CL_COSINE; and pass 1's
    cached embeddings (``flash_fwd``) against pass 2's live ones
    (``flash_fwd_lse``) of one microbatch."""
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.train.loop import microbatch_major
    from avion_tpu_torch.train.pretrain_clip import make_step
    from avion_tpu_torch.train.steps import prep_video, step_seed

    batch = _to_device(_train_batches(1, CL_ACCUM_BATCH, FRAMES)[0])
    results = {}
    for name, micro in (("cached", CL_ACCUM_MICRO), ("one shot", 1)):
        cfg = _train_config(os.path.join(tmp, "vitl_accum"),
                            f"data.batch_size={CL_ACCUM_BATCH}",
                            f"optim.update_freq={micro}", "optim.lr=0",
                            "optim.fix_lr=true", "optim.grad_clip_norm=null",
                            "optim.state_dtype=float32", recipe=CL_RECIPE)
        opt, _ = build_optimizer(cfg.optim, model, 1)
        state = TrainState.create(model, opt)
        state, metrics = make_step(cfg, model)(
            state, microbatch_major(batch, micro) if micro > 1 else batch)
        torch.cuda.synchronize()
        if metrics["step_ok"] != 1.0:
            raise RuntimeError(f"(c) {name}: the step was not applied")
        results[name] = (float(metrics["loss"]), {
            n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None})
        model.zero_grad(set_to_none=True)
        del opt, state
    (l_acc, g_acc), (l_one, g_one) = results["cached"], results["one shot"]
    device = next(model.parameters()).device
    dots = torch.zeros(3, dtype=torch.float64, device=device)
    for n in g_one:
        a, b = g_acc[n].double().reshape(-1), g_one[n].double().reshape(-1)
        dots += torch.stack([a @ b, a @ a, b @ b])
    ab, aa, bb = dots.tolist()
    cos = ab / math.sqrt(aa * bb)
    rel = abs(l_acc - l_one) / abs(l_one)
    del results, g_acc, g_one

    mb = {k: v[:CL_ACCUM_BATCH // CL_ACCUM_MICRO] for k, v in batch.items()}
    video = prep_video(mb["video"], dtype=model.dtype, model=model)
    embeds, launched = [], []
    for grad in (False, True):
        fa.reset_launches()
        with torch.set_grad_enabled(grad):
            out = model(video, mb["text"].long(), deterministic=False,
                        generator=torch.Generator(device).manual_seed(
                            step_seed(1, 0)))
        torch.cuda.synchronize()
        launched.append(dict(fa.launches))
        embeds.append({k: out[k].detach() for k in ("image_embed",
                                                   "text_embed")})
        del out
    diff = {k: (embeds[0][k] - embeds[1][k]).abs().max().item()
            for k in embeds[0]}
    log(f"(c) {CL_MODEL} at batch {CL_ACCUM_BATCH}: cached over "
        f"{CL_ACCUM_MICRO} microbatches loss {l_acc:.6f}, one step "
        f"{l_one:.6f}, relative difference {rel:.3e} (bound {CL_LOSS_RTOL}); "
        f"gradient cosine {cos:.6f} (bound {CL_COSINE}); pass 1 (launches "
        f"{launched[0]}) against pass 2 (launches {launched[1]}), largest "
        f"embedding difference {diff}")
    if not (rel <= CL_LOSS_RTOL and cos >= CL_COSINE):
        raise RuntimeError("(c) cached accumulation disagrees with one step")
    return {"loss_rel_diff": rel, "grad_cosine": cos,
            "cached_vs_live_max_abs": diff}


def _cl_seeded(tmp: str) -> dict:
    """(b) the recipe at batch CL_BATCH through ``build_model_and_state``,
    ``make_step`` and ``train.loop``: CL_STEPS steps on seeded batches and
    a profiled step; (c) on its weights; (d) peak memory of the same steps
    with f32 optimizer state against (b)'s bf16."""
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.train.loop import microbatch_major, setup_run
    from avion_tpu_torch.train.pretrain_clip import make_step

    cfg = _train_config(os.path.join(tmp, "vitl"), recipe=CL_RECIPE)
    t0 = time.perf_counter()
    model, opt, step = _cl_build(cfg, CL_STEPS)
    run = setup_run(cfg, model, opt, step)
    batches = _train_batches(CL_STEPS, CL_BATCH, FRAMES)
    log(f"== contrastive (b): {CL_MODEL}, {FRAMES} frames, batch {CL_BATCH} "
        f"as {CL_MICRO} cached microbatches, bf16 AdamW state, remat; ready "
        f"in {time.perf_counter() - t0:.1f} s")
    res = _timed_epoch(run, batches)
    report = _report_run(f"(b) {CL_MODEL} batch {CL_BATCH}", res, CL_BATCH,
                         CL_STEPS, _accum_launches(model, CL_MICRO),
                         _model_flops(model, CL_BATCH))
    report["launches"] = res["launches"]
    report["profile"] = profile_step(run, microbatch_major(
        _to_device(batches[0]), CL_MICRO))
    if _moment_dtypes(opt) != {torch.bfloat16}:
        raise RuntimeError(f"(b) moments {_moment_dtypes(opt)}, not bf16")
    del run, opt
    torch.cuda.empty_cache()
    report["accum"] = _cl_accum_check(tmp, model)
    torch.cuda.empty_cache()

    cfg32 = _train_config(os.path.join(tmp, "vitl_f32"),
                          "optim.state_dtype=float32", recipe=CL_RECIPE)
    opt32, _ = build_optimizer(cfg32.optim, model, CL_STEPS)
    run = setup_run(cfg32, model, opt32, make_step(cfg32, model))
    # (b)'s batches and steps, so that as many batches are in flight
    res32 = _timed_epoch(run, batches)
    report["peak_gib_f32_state"] = res32["peak"] / 2 ** 30
    log(f"(d) peak memory allocated over {CL_STEPS} steps: f32 state "
        f"{report['peak_gib_f32_state']:.3f} GiB, bf16 state "
        f"{report['peak_gib']:.3f} GiB (moments {_moment_dtypes(opt32)} "
        f"against bf16), step ms "
        f"{[round(float(x), 3) for x in res32['step_ms']]}")
    del run, opt32, model, batches
    torch.cuda.empty_cache()
    return report


def _cl_options(tmp: str) -> dict:
    """(e) a step of ``CLIP_VITL14_H128`` (head_dim 128 launched) and
    CL_SHORT_STEPS each of ``loss=siglip`` (``logit_bias`` learned) and
    ``accum=multistep`` with ``update_freq=2`` (one update in two calls);
    finite losses and the expected launches."""
    # siglip's bias moves by the warmup's first rate (1e-6) in its first
    # step, and multistep needs 2 calls for an update
    runs = {
        "h128": ([f"model.name={CL_H128}"], CL_SHORT_BATCH, 2, 1),
        "siglip": (["loss=siglip", "model.use_logit_bias=true"],
                   CL_SHORT_BATCH, 2, CL_SHORT_STEPS),
        "multistep": (["optim.accum=multistep"], CL_TIME_BATCH, 1,
                      CL_SHORT_STEPS)}
    from avion_tpu_torch.train.loop import setup_run

    paths = {}
    for name, (extra, batch, micro, steps) in runs.items():
        cfg = _train_config(os.path.join(tmp, f"vitl_{name}"), *extra,
                            f"data.batch_size={batch}",
                            "optim.update_freq=2", recipe=CL_RECIPE)
        model, opt, step = _cl_build(cfg, CL_SHORT_STEPS)
        run = setup_run(cfg, model, opt, step)
        dims, fwd, bwd = set(), fa._fwd_cuda, fa._bwd_cuda

        def fwd_rec(qkv, heads, *a, **k):
            dims.add(qkv.shape[-1] // (3 * heads))
            return fwd(qkv, heads, *a, **k)

        def bwd_rec(do, qkv, out, lse, heads, *a, **k):
            dims.add(qkv.shape[-1] // (3 * heads))
            return bwd(do, qkv, out, lse, heads, *a, **k)

        fa._fwd_cuda, fa._bwd_cuda = fwd_rec, bwd_rec
        try:
            res = _timed_epoch(run, _train_batches(steps, batch,
                                                   FRAMES))
        finally:
            fa._fwd_cuda, fa._bwd_cuda = fwd, bwd
        per_step = (_accum_launches(model, micro) if micro > 1
                    else _ft_launches(model))
        want = {k: v * steps for k, v in per_step.items()}
        losses = [m["loss"] for m in res["metrics"]]
        oks = [m["step_ok"] for m in res["metrics"]]
        want_dims = {blk.attn.Wqkv.in_features // blk.attn.heads
                     for tower in (model.visual, model.textual)
                     for blk in tower.transformer.resblocks}
        if name == "h128":
            extra_ok = dims == want_dims
        elif name == "siglip":
            bias = model.logit_bias.item()
            extra_ok = bias != -10.0 and math.isfinite(bias)
        else:
            extra_ok = opt.count == 1 and opt.mini_step == 0
        log(f"(e) {name}: batch {batch}, losses {losses}, step_ok {oks}, "
            f"step ms {[round(float(x), 3) for x in res['step_ms']]}, "
            f"launches {res['launches']} (expected {want}), head dims "
            f"{sorted(dims)} (the model's {sorted(want_dims)}), updates "
            f"{opt.count}"
            + (f", logit_bias {model.logit_bias.item():.6f}"
               if name == "siglip" else ""))
        if (not np.isfinite(losses).all() or oks != [1.0] * steps
                or res["launches"] != want or not extra_ok):
            raise RuntimeError(f"(e) {name} failed")
        paths[f"contrastive_{name}"] = res["launches"]
        del run, model, opt, step
        torch.cuda.empty_cache()
    return paths


def _cl_entry(tmp: str, fixture: tuple) -> dict:
    """(f) ``pretrain_clip.main`` on the data phase's Ego4D layout with
    ``CLIP_VITL14`` at batch CL_SHORT_BATCH as 2 cached microbatches, bf16
    state, CL_SHORT_STEPS steps: each step's time and data wait from
    ``log.jsonl``; then the checkpoint restored into a model drawn from
    another seed, bit for bit, the moments bf16."""
    from avion_tpu_torch.train import pretrain_clip
    from avion_tpu_torch.train.loop import setup_run

    root, meta = fixture
    out = os.path.join(tmp, "vitl_data")
    # 2048 rows at stride 4: two batches of 224
    args = _data_args(out, root, meta, True, f"model.name={CL_MODEL}",
                      f"data.batch_size={CL_SHORT_BATCH}",
                      "data.subsample_stride=4", "optim.update_freq=2",
                      "optim.accum=cached", "optim.state_dtype=bfloat16")
    torch.cuda.synchronize()
    fa.reset_launches()  # the entry's path, counted from here
    t0 = time.perf_counter()
    res = pretrain_clip.main(args)
    torch.cuda.synchronize()
    launches, wall = dict(fa.launches), time.perf_counter() - t0
    recs = [r for r in _train_log(out) if "train/loss" in r]
    step_ms = [r["perf/batch_time_win"] * 1e3 for r in recs]
    data_ms = [r["perf/data_time_win"] * 1e3 for r in recs]
    cfg = _train_config(out, *args[len(TRAIN_RECIPE):])
    model, opt, step = _cl_build(_train_config(out, *args[len(TRAIN_RECIPE):],
                                               "seed=1"), CL_SHORT_STEPS)
    want = {k: v * CL_SHORT_STEPS for k, v in _accum_launches(model,
                                                              2).items()}
    log(f"(f) pretrain_clip.main, {CL_MODEL} batch {CL_SHORT_BATCH} (2 "
        f"cached microbatches, bf16 state): {res['steps']} steps, losses "
        f"{[r['train/loss'] for r in recs]}, step ms "
        f"{[round(x, 3) for x in step_ms]}, data wait ms "
        f"{[round(x, 3) for x in data_ms]}, launches {launches} (expected "
        f"{want}), wall {wall:.2f} s")
    if (res["steps"] != CL_SHORT_STEPS
            or not all(np.isfinite(r["train/loss"]) for r in recs)):
        raise RuntimeError("(f) the data-fed ViT-L run failed")
    if launches != want:
        raise RuntimeError(f"(f) launches {launches}, expected {want}")
    saved = torch.load(os.path.join(out, "ckpt", str(res["step"]),
                                    "state.pt"), weights_only=True)
    run = setup_run(cfg, model, opt, step)
    got = opt.state_dict()
    same = (run.state.step == saved["step"] == res["step"]
            and all(torch.equal(v.cpu(), saved["model"][k])
                    for k, v in model.state_dict().items())
            and got["count"] == saved["optimizer"]["count"]
            and all(torch.equal(v.cpu(), saved["optimizer"]["adamw"][
                "state"][i][k]) for i, s in got["adamw"]["state"].items()
                    for k, v in s.items())
            and _moment_dtypes(opt) == {torch.bfloat16})
    log(f"(f) resume at step {run.state.step} into a model built from "
        f"another seed: parameters and bf16 AdamW moments bit for bit: "
        f"{same}")
    if not same:
        raise RuntimeError("(f) resume did not restore the state")
    del run, model, opt, step, saved, got
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "data_ms": data_ms, "wall_s": wall,
            "launches": launches}


def phase_contrastive(tmp: str, fixture: tuple) -> dict:
    """The contrastive-extras slice's paths at ViT-L/14's full width: (a)
    the kernels at its shapes; (b) seeded steps of the batch-896 recipe
    through cached accumulation and bf16 state, (c) cached against one
    step, (d) peak memory of f32 against bf16 state; (e) H128, SigLIP and
    multistep; (f) ``pretrain_clip.main`` on decoded video.  Returns the
    kernel rows and every path's launches."""
    t_phase = time.perf_counter()
    log(f"== contrastive (a): kernels at the ViT-L shapes, errors at batch "
        f"{CL_CHECK_BATCH}, times at batch {CL_TIME_BATCH}")
    rows = _slice_kernel_rows(CL_SHAPES, CL_CHECK_BATCH, CL_TIME_BATCH, 13,
                              "the ViT-L shapes")
    fwd = _slice_kernel_rows(CL_FWD_SHAPES, CL_CHECK_BATCH, CL_TIME_BATCH,
                             17, "the 336 px ViT-L shape", forward_only=True)
    for name in rows:
        rows[name] += fwd[name]
    seeded = _cl_seeded(tmp)
    paths = _cl_options(tmp)
    entry = _cl_entry(tmp, fixture)
    summary = {"seeded": {k: v for k, v in seeded.items()
                          if k != "launches"},
               "entry": {k: v for k, v in entry.items() if k != "launches"}}
    log(f"contrastive summary {json.dumps(summary)}")
    log(f"contrastive phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "paths": {
        "contrastive_vitl_seeded": seeded["launches"], **paths,
        "contrastive_vitl_data": entry["launches"]}}


# (batch, tokens a shard, heads, head_dim): ViT-B/16 at 16 frames with gap
# pooling (3136 tokens) over sp = 4, and the head_dim-128 geometry
PAR_SHAPES = [(16, 784, 12, 64), (16, 784, 6, 128)]
PAR_BIASES = (0.0, -1e30)  # a visible hop, a hop voided by the mask value
RING_SP = 4
RING_REF_ROWS = 2  # clips a plain f32 reference pass takes: 0.94 GB of scores
# (d) decodes its clips in the script's process
PAR_BATCH, PAR_STEPS = 64, 2
HOP_KERNELS = ("flash_hop_fwd", "flash_hop_bwd_dq", "flash_hop_bwd_dkv")


def _build_rows(sources=(fa.SOURCE, fa.BWD_SOURCE)) -> list:
    """(a) The instances a ring hop launches, from the build check's lines:
    the forward with lse, bwd_dq and the dkv route's bwd_kv<dq=0>."""
    hop = re.compile(r"flash_fwd_kernel<\d+, causal=0, lse=1>|bwd_dq_kernel"
                     r"<\d+, causal=0>|bwd_kv_kernel<\d+, causal=0, dq=0>")
    rows = [line for line in _BUILD_LINES if hop.search(line)]
    log("(a) the hop instances passed the build check (0 spill bytes, no "
        "wgmma serialized, HGMMA and UTMALDG in the SASS):")
    for line in rows:
        log("  " + line)
    if len(rows) != 6:
        raise RuntimeError(f"(a) {len(rows)} hop instances checked, not 6")
    return rows


def _hop_rows(gen, check) -> dict:
    """(b) Each hop kernel against its plain f32 version at PAR_SHAPES with
    k / v from a [B, S, 2W] buffer other than q's, at every bias of
    PAR_BIASES: the forward (out, lse) and the backward on the global out
    and lse of a bias-0 forward (dq, dk, dv; exactly 0 on a voided hop);
    times at bias 0 beside the bound and SDPA's."""
    rows = {name: [] for name in HOP_KERNELS}
    for b, s, h, d in PAR_SHAPES:
        w, scale, shape = h * d, d ** -0.5, [b, s, h, d]
        q = torch.randn(b, s, w, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        kv = torch.randn(b, s, 2 * w, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        do = torch.randn(b, s, w, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        k, v = kv[..., :w], kv[..., w:]
        out, lse = fa.flash_hop_fwd(q, k, v, h, False, scale, 0.0)
        qh, kh, vh = (x.reshape(b, s, h, d).transpose(1, 2) for x in (q, k, v))
        sdpa_fwd = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh))
        qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))
        do_h = do.view(b, s, h, d).transpose(1, 2)

        def sdpa_fwd_bwd():
            o = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
            torch.autograd.grad(o, (qg, kg, vg), do_h)

        sdpa_bwd = cuda_ms(sdpa_fwd_bwd) - sdpa_fwd
        for bias in PAR_BIASES:
            fa.reset_launches()
            o, l = fa.flash_hop_fwd(q, k, v, h, False, scale, bias)
            torch.cuda.synchronize()
            if dict(fa.launches) != {"flash_hop_fwd": 1}:
                raise RuntimeError(f"hop forward launches {dict(fa.launches)}")
            ref_o, ref_l = fa.flash_hop_fwd_plain(q.float(), k.float(),
                                                  v.float(), h, s, False,
                                                  scale, bias)
            err, rel = _errors(o, ref_o)
            lse_err = (l - ref_l).abs().max().item()
            check("flash_hop_fwd", shape + [bias], max_abs_err=(err, TOL),
                  rel_rms_err=(rel, REL_TOL),
                  lse_max_abs_err=(lse_err, LSE_TOL))
            row = {"shape": shape, "bias": bias, "max_abs_err": err,
                   "rel_rms_err": rel, "lse_max_abs_err": lse_err,
                   "lse_min": l.min().item()}
            if not bias:
                row.update(kernel_ms=cuda_ms(lambda: fa.flash_hop_fwd(
                    q, k, v, h, False, scale, 0.0)),
                    plain_ms=cuda_ms(lambda: fa.flash_hop_fwd_plain(
                        q, k, v, h, s, False, scale, 0.0), iters=3),
                    library_ms=sdpa_fwd)
                row["bound_ms"], row["bound_by"] = bound(b, s, h, d, False,
                                                         rows=1)
            rows["flash_hop_fwd"].append(row)
            log("flash_hop_fwd " + json.dumps(row))
            fa.reset_launches()
            got = fa.flash_hop_bwd(do, q, k, v, out, lse, h, False, scale,
                                   bias)
            torch.cuda.synchronize()
            if dict(fa.launches) != {"flash_hop_bwd_dq": 1,
                                     "flash_hop_bwd_dkv": 1}:
                raise RuntimeError(f"hop backward launches "
                                   f"{dict(fa.launches)}")
            ref = fa.flash_hop_bwd_plain(do.float(), q.float(), k.float(),
                                         v.float(), out.float(), lse, h, s,
                                         False, scale, bias)
            errs = {}
            for i, sec in enumerate(("dq", "dk", "dv")):
                g, r = got[..., i * w:(i + 1) * w], ref[..., i * w:(i + 1) * w]
                if bias:  # a voided hop: every term exactly 0
                    err = g.float().abs().max().item()
                    check("flash_hop_bwd", shape + [bias],
                          **{f"{sec}_max_abs": (err, 0.0)})
                    errs[sec] = {"max_abs_err": err}
                    continue
                err, rel = _errors(g, r)
                check("flash_hop_bwd", shape + [bias], **{
                    f"{sec}_max_abs_err": (err, TOL),
                    f"{sec}_rel_rms_err": (rel, BWD_REL_TOL)})
                errs[sec] = {"max_abs_err": err, "rel_rms_err": rel}
            base = {"shape": shape, "bias": bias, **errs,
                    "max_abs_err": max(e["max_abs_err"] for e in
                                       errs.values())}
            if bias:
                for name in HOP_KERNELS[1:]:
                    rows[name].append(dict(base))
                log("flash_hop_bwd " + json.dumps(base))
                continue
            plain_ms = cuda_ms(lambda: fa.flash_hop_bwd_plain(
                do, q, k, v, out, lse, h, s, False, scale, 0.0), iters=3)
            # bf16-sized tensors: q, k, v, dO and out read, the f32
            # gradients written (two each); f32 rows: lse (and delta)
            for name, part, products, tensors, nrows in (
                    ("flash_hop_bwd_dq", "dq", 3, 7, 1),
                    ("flash_hop_bwd_dkv", "dkv", 4, 9, 2)):
                r = dict(base, plain_ms=plain_ms, library_ms=sdpa_bwd,
                         kernel_ms=cuda_ms(lambda: fa._bwd_launch(
                             do, q, k, v, out, lse, h, s, False, scale,
                             route=part, bias=0.0, prefix="flash_hop_bwd",
                             out_f32=True)))
                r["bound_ms"], r["bound_by"] = bound(b, s, h, d, False,
                                                     products, tensors, nrows)
                rows[name].append(r)
                log(f"{name} " + json.dumps(r))
        del q, kv, do, out, lse, qg, kg, vg
    return rows


def _ring_check(gen, check) -> dict:
    """(c) RING_SP shards of (B, 3136 tokens, 12 x 64) on one card: each
    shard's hops played in turn through the hop ops and the f32 merge
    (``ring_attention.run_ring_local``, the bodies the process-group ring
    runs), forward and backward, against the plain f32 attention over the
    whole sequence on the same inputs (out, dq, dk, dv; RING_REF_ROWS clips
    at a time), causal and not, within phase 3's tolerances.  Returns the
    hop kernels' launches over the two ring drives."""
    from avion_tpu_torch.ops import ring_attention as ra

    b, s_loc, h, d = PAR_SHAPES[0]
    s, w, scale = s_loc * RING_SP, h * d, d ** -0.5
    qkv = torch.randn(b, s, 3 * w, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    do = torch.randn(b, s, w, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    total = {}
    for causal in (False, True):
        shards = [qkv[:, i * s_loc:(i + 1) * s_loc] for i in range(RING_SP)]
        qs, ks, vs = ([x[..., j * w:(j + 1) * w].contiguous() for x in shards]
                      for j in range(3))
        torch.cuda.synchronize()
        fa.reset_launches()
        fwd = ra.run_ring_local([
            ra.ring_forward_body(qs[i], ks[i], vs[i], h, causal, scale, i,
                                 RING_SP) for i in range(RING_SP)])
        outs = [o for o, _ in fwd]
        grads = ra.run_ring_local([
            ra.ring_backward_body(do[:, i * s_loc:(i + 1) * s_loc]
                                  .contiguous(), qs[i], ks[i], vs[i], *fwd[i],
                                  h, causal, scale, i, RING_SP)
            for i in range(RING_SP)])
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        want = {"flash_hop_fwd": RING_SP ** 2, "flash_hop_bwd_dq": RING_SP ** 2,
                "flash_hop_bwd_dkv": RING_SP ** 2}
        if launches != want:
            raise RuntimeError(f"(c) ring launches {launches}, want {want}")
        got = {"out": torch.cat(outs, 1)}
        for j, sec in enumerate(("dq", "dk", "dv")):
            got[sec] = torch.cat([g[j] for g in grads], 1)
        del fwd, grads, outs, qs, ks, vs, shards
        ref = {sec: torch.empty(b, s, w, device="cuda")
               for sec in ("out", "dq", "dk", "dv")}
        for r0 in range(0, b, RING_REF_ROWS):
            rows = slice(r0, r0 + RING_REF_ROWS)
            x = qkv[rows].float()
            o, lse = fa.flash_fwd_lse_plain(x, h, s, causal, scale)
            g = fa.flash_bwd_plain(do[rows].float(), x, o, lse, h, s, causal,
                                   scale)
            ref["out"][rows] = o
            for j, sec in enumerate(("dq", "dk", "dv")):
                ref[sec][rows] = g[..., j * w:(j + 1) * w]
            del x, o, lse, g
        row = {"shape": [b, s, h, d], "sp": RING_SP, "causal": causal,
               "launches": launches}
        for sec in ("out", "dq", "dk", "dv"):
            err, rel = _errors(got[sec], ref[sec])
            row[sec] = {"max_abs_err": err, "rel_rms_err": rel,
                        "ref_max_abs": ref[sec].abs().max().item()}
            check("ring", [b, s, h, d, causal], **{
                f"{sec}_max_abs_err": (err, TOL),
                f"{sec}_rel_rms_err": (rel, REL_TOL if sec == "out"
                                       else BWD_REL_TOL)})
        log("(c) ring " + json.dumps(row))
        del got, ref
    return total


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _alone_and_nccl(label: str, main, args: list, out_dir: str,
                    steps: int, want: dict) -> dict:
    """``main(args)`` under ``torch.use_deterministic_algorithms(True)``
    twice, without a process group and under a one-rank NCCL group
    (torchrun's environment; DDP), each writing under ``out_dir``_<run> (a
    last ``output_dir`` argument, so it overrides one in ``args``):
    ``steps`` steps and the launches ``want`` in each, the logged losses,
    the launches and the final checkpoint's parameters (and EMA) bit for
    bit.  Every item draws from seed 0 and the loader decodes in this
    process, so both runs see the same batches.  Returns the launches of
    the run under the group."""
    orig = np.random.RandomState
    runs = {}
    np.random.RandomState = lambda seed=None: orig(0 if seed is None
                                                    else seed)
    try:
        for name in ("alone", "nccl"):
            group_env = {} if name == "alone" else {
                "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
            out = f"{out_dir}_{name}"
            os.environ.update(group_env)
            try:
                torch.cuda.synchronize()
                fa.reset_launches()  # this run's path, counted from here
                t0 = time.perf_counter()
                with deterministic():
                    res = main([*args, f"output_dir={out}"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                for k in group_env:
                    os.environ.pop(k, None)
            launches = dict(fa.launches)
            if torch.distributed.is_initialized():
                raise RuntimeError(f"{label} main left its process group")
            losses = [r["train/loss"] for r in _train_log(out)
                      if "train/loss" in r]
            log(f"{label} main {name}: {res['steps']} steps, losses {losses}, "
                f"launches {launches}, wall {wall:.2f} s")
            if (res["steps"] != steps or launches != want
                    or not np.isfinite(losses).all()):
                raise RuntimeError(f"{label} {name}: {res['steps']} steps, "
                                   f"losses {losses}, launches {launches}, "
                                   f"want {want}")
            state = torch.load(os.path.join(out, "ckpt", str(res["step"]),
                                            "state.pt"), weights_only=True)
            runs[name] = (losses, {p: state[p] for p in ("model", "ema")
                                   if p in state}, launches)
            torch.cuda.empty_cache()
    finally:
        np.random.RandomState = orig
    (la, sa, _), (ln, sn, launches) = runs["alone"], runs["nccl"]
    same = la == ln and sa.keys() == sn.keys() and all(
        sa[p].keys() == sn[p].keys()
        and all(torch.equal(v, sn[p][k]) for k, v in sa[p].items())
        for p in sa)
    log(f"{label} losses, launches and {' and '.join(sa)} under the "
        f"one-rank NCCL group equal the run without a group bit for bit: "
        f"{same}")
    if not same:
        raise RuntimeError(f"{label} the one-rank NCCL run differs")
    return launches


def _nccl_entry(tmp: str, fixture: tuple) -> dict:
    """(d) ``pretrain_clip.main`` at ViT-B/16 batch PAR_BATCH for PAR_STEPS
    seeded steps (``mesh.data=1 mesh.tensor=1 mesh.dcn_data=1``: the
    tensor and multi-node axes' mesh and group code on the card) through
    :func:`_alone_and_nccl`.  The
    visual tower is the sequence-parallel one (gap pooling; a ring of one
    shard, so its attention runs the hop kernels); under the deterministic
    flag the text tower takes the split backward: the combined route sums
    dq in an order that varies from run to run, which no two runs could
    match bit for bit."""
    from avion_tpu_torch.train import pretrain_clip

    root, meta = fixture
    want = {name: PAR_STEPS * LAYERS for name in (
        "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv", *HOP_KERNELS)}
    args = _data_args(os.path.join(tmp, "parallel"), root, meta, True,
                      f"data.batch_size={PAR_BATCH}",
                      "data.subsample_stride="
                      f"{DATA_ROWS // (PAR_BATCH * PAR_STEPS)}",
                      "data.num_workers=0",
                      "eval_freq=0", "mesh.data=1", "mesh.tensor=1",
                      "mesh.dcn_data=1", "model.sequence_parallel=true",
                      "model.pooling=gap")
    return _alone_and_nccl("(d) pretrain_clip", pretrain_clip.main, args,
                           os.path.join(tmp, "parallel"), PAR_STEPS, want)


ENTRY_BATCH, ENTRY_STEPS = 4, 2


def _entry_runs(tmp: str) -> dict:
    """(e)'s four entries at full width, 16 frames, by name: (module, its
    arguments, its model on the meta device) on the layouts and random
    checkpoints that the finetune and VideoMAE phases wrote, cut to
    ENTRY_STEPS steps of ENTRY_BATCH clips: MIR takes every
    ``subsample_stride``-th row of the EK100 train split, the others the
    first rows of a copy of their list; no validation."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.train import (finetune_cls, finetune_mir,
                                       videomae_finetune, videomae_pretrain)

    rows = ENTRY_BATCH * ENTRY_STEPS
    ek = os.path.join(tmp, "ek100_ft")
    train_csv = os.path.join(ek, "EPIC_100_retrieval_train.csv")
    cls_csv = os.path.join(ek, "entry_cls_train.csv")
    with open(train_csv) as f, open(cls_csv, "w") as g:
        g.writelines(f.readlines()[:1 + rows])  # the header and 16 rows
    k400 = os.path.join(tmp, "k400")
    k400_list = os.path.join(tmp, "k400_entry.txt")
    with open(os.path.join(k400, "list.txt")) as f, open(k400_list, "w") as g:
        g.writelines(f.readlines()[:rows])
    common = [f"data.batch_size={ENTRY_BATCH}", "data.num_workers=0",
              "optim.epochs=1", "eval_freq=0", "mesh.data=1", "mesh.fsdp=1"]
    ek_args = [f"data.root={ek}", f"data.chunk_len={DATA_CHUNK_S}",
               f"pretrain_model={os.path.join(tmp, 'clip_vitb16_random.pt')}"]
    k_args = [f"data.root={k400}", f"data.train_metadata={k400_list}"]
    runs = {
        "finetune_mir": (finetune_mir, [
            *FT_MIR_RECIPE, *ek_args, f"data.train_metadata={train_csv}",
            f"data.subsample_stride={EK_TRAIN_CLIPS // rows}", *common]),
        "finetune_cls": (finetune_cls, [
            *FT_CLS_RECIPE, *ek_args, f"data.train_metadata={cls_csv}",
            f"data.label_map={os.path.join(ek, 'actions.csv')}", *common]),
        "videomae_pretrain": (videomae_pretrain, [
            *VMAE_PRETRAIN_RECIPE, *k_args, *common]),
        "videomae_finetune": (videomae_finetune, [
            *VMAE_FINETUNE_RECIPE, *k_args, *common, "pretrain_model="
            + os.path.join(tmp, "videomae_ft_random.pt")])}
    out = {}
    for name, (module, args) in runs.items():
        cfg = TrainConfig().apply_overrides(args)
        with torch.device("meta"):
            model = (module.build_classifier(cfg, 100)
                     if name == "finetune_cls" else module.build_model(cfg))
        out[name] = (module, args, model)
    return out


def _entries_under_flag(tmp: str) -> dict:
    """(e) each of the four entries' ``main`` (``_entry_runs``,
    ``mesh.data=1 mesh.fsdp=1``) through :func:`_alone_and_nccl`, every
    backward on the split kernels.  Returns each entry's launches."""
    t_e = time.perf_counter()
    report = {}
    for entry, (module, args, model) in _entry_runs(tmp).items():
        with deterministic():
            per_step = (_ft_launches(model) if entry.startswith("fine")
                        else _vmae_launches(model))
        report[entry] = _alone_and_nccl(
            f"(e) {entry}", module.main, args,
            os.path.join(tmp, f"entry_{entry}"), ENTRY_STEPS,
            {k: v * ENTRY_STEPS for k, v in per_step.items()})
    log(f"(e) the four entries, 8 runs: wall {time.perf_counter() - t_e:.1f}"
        f" s")
    return report


def phase_parallel(tmp: str, fixture: tuple) -> dict:
    """The parallel slices on one card: (a) the hop instances' build check;
    (b) the hop kernels against their plain versions; (c) the ring over
    RING_SP shards against attention over the whole sequence; (d)
    ``pretrain_clip.main`` and (e) the four other entries' ``main`` under a
    one-rank NCCL group against the run without one, under the
    deterministic flag.  Returns the hop kernels' rows and the launches."""
    log("== parallel")
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(10)
    bad = []

    def check(name, shape, **errs):
        for key, (err, limit) in errs.items():
            if not err <= limit:  # NaN fails too
                bad.append(f"{name} {shape}: {key} {err} > {limit}")

    _build_rows()
    rows = _hop_rows(gen, check)
    ring = _ring_check(gen, check)
    if bad:
        raise RuntimeError("parallel: " + "; ".join(bad))
    nccl = _nccl_entry(tmp, fixture)
    entries = _entries_under_flag(tmp)
    log(f"parallel phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "ring": ring, "nccl": nccl, "entries": entries}


# the narrator slice: VCLM_VITB16 (ViT-B/16 at 4 frames, 224 px, and a
# 12 x 512 causal decoder with gated cross-attention on every 2nd block).
# The config's batch 256 in one call keeps more activations than one card
# holds (no remat: the JAX VCLM has none; phase (a) logs the bytes a clip);
# it runs as 2 calls of 128 whose gradients optim.accum=multistep averages
# into one update
NR_MODEL = "VCLM_VITB16"
NR_BATCH, NR_MICRO, NR_STEPS, NR_SEEDS = 256, 2, 8, 3
NR_RECIPE = [f"model.name={NR_MODEL}", f"data.clip_length={FRAMES}",
             f"data.crop_size={SIZE}",
             f"data.batch_size={NR_BATCH // NR_MICRO}",
             f"optim.update_freq={NR_MICRO}", "optim.accum=multistep",
             "optim.optimizer=adamw", "optim.lr=3e-5", "optim.wd=0.01",
             "optim.warmup_epochs=1", "optim.epochs=5",
             "optim.grad_clip_norm=1.0", "print_freq=1"]
NR_GATE = 0.5  # tanh gates opened, so the video reaches the loss
NR_REF_BATCH, NR_DET_BATCH, NR_DET_STEPS = 2, 32, 2
NR_DATA_BATCH, NR_DATA_STEPS = 32, 2
NR_SAMPLES, NR_MAX_LEN, NR_WINDOW_S, NR_STRIDE_S = 3, 30, 4.0, 4.0
# the cached decode's logits against a teacher-forced decode of the same
# tokens, bf16: max abs and RMS error over the logits' RMS (0.046 and
# 0.0053 on the CPU's plain path)
NR_LOGIT_MAX_TOL, NR_LOGIT_RMS_TOL = 0.15, 0.02
# the generation decoder (uncached: causal inference kernel) and the
# head_dim-128 decoder (model.text_heads=4)
NR_SHAPES = [("decoder H128", 77, 4, 128, True)]
NR_GEN_SHAPES = [("decoder, generation", NR_MAX_LEN, 8, 64, True)]
LV_MODEL, LV_SIZE = "VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL", 336
# (f)'s tokens a sample (the captioner's default 77 took 34 s of host-bound
# decoding for 3 samples)
LV_MAX_LEN = 20
LV_SAMPLES = 3  # lavila_captioner's default: one encode a sample
LV_TWIN = dict(vision_layers=2, text_layers=3)  # the CPU reference's depth
# LaViLa's training cell (64 clips of 4 frames at 336 px, captions of 77):
# (shapes, check batch, time batch, forward only) of the divided
# attention's space and time modes, which the frozen tower runs on the
# inference kernel, and of GPT-2 XL's causal self-attention
LV_KERNEL_SHAPES = [
    ([("LaViLa space", 577, 16, 64, False)], 16, 256, True),
    ([("LaViLa time", 5, 16, 64, False)], 36864, 36864, True),
    ([("LaViLa GPT-2 XL decoder", 76, 25, 64, True)], 64, 64, False)]
NR_DEVICE = "cuda"


def _open_gates(model) -> None:
    """Every tanh gate of a narrator to NR_GATE."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("_gate", "alpha_cattn", "alpha_dense")):
                p.fill_(NR_GATE)


def _caption_batches(n: int, batch: int) -> list:
    """Seeded batches in the caption dataset's contract: uint8 clips at
    224 px and 77 token ids, SOT first, EOT, then padding."""
    out = []
    for seed in range(n):
        rng = np.random.default_rng(100 + seed)
        text = rng.integers(1, 49405, (batch, 77), dtype=np.int32)
        text[:, 0] = 49406
        ends = rng.integers(5, 77, batch)
        text[np.arange(batch), ends] = 49407
        text[np.arange(77)[None] > ends[:, None]] = 0
        out.append({"video": rng.integers(0, 256, (batch, FRAMES, SIZE, SIZE,
                                                   3), dtype=np.uint8),
                    "text": text})
    return out


def _nr_step_launches(model, split: bool = False) -> dict:
    """One narrator step's launches: a forward with lse and a backward for
    every attention layer of the visual tower and of the decoder (both
    take the combined backward: S 785 and 77 pad to 896 and 128)."""
    layers = model.vision_layers + model.layers
    names = ("flash_bwd_dq", "flash_bwd_dkv") if split else \
        ("flash_bwd_combined",)
    return {"flash_fwd_lse": layers, **{n: layers for n in names}}


def _nr_flops(model, batch: int) -> float:
    """6 x parameters x tokens of the visual tower and of the decoder (the
    token table counts as the head's product only) plus 12 B H S^2 D per
    self-attention layer and 12 B H S Sv D per cross-attention."""
    v = model.visual
    s_v = (v.positional_embedding.shape[0] - 1) * FRAMES + 1
    s_t = model.context_length
    vis = sum(p.numel() for p in v.parameters())
    dec = sum(p.numel() for n, p in model.named_parameters()
              if not n.startswith("visual."))
    flops = 6 * vis * batch * s_v + 6 * dec * batch * s_t
    flops += 12 * batch * s_v * s_v * v.width * model.vision_layers
    flops += 12 * batch * s_t * s_t * model.width * model.layers
    cross = sum(b.cross_attend for b in model.blocks)
    return flops + 12 * batch * s_t * s_v * model.width * cross


def _saved_bytes_per_clip(model, batch: dict) -> float:
    """Bytes of the tensors one more clip makes the forward keep for the
    backward (the caption loss at 2 clips less at 1; storages counted
    once): what a batch costs in activation memory."""
    def saved(n):
        seen = {}

        def pack(t):
            storage = t.untyped_storage()
            seen[storage.data_ptr()] = storage.nbytes()
            return t

        b = _to_device({k: v[:n] for k, v in batch.items()})
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            _caption_loss(model, b)
        return sum(seen.values())

    return float(saved(2) - saved(1))


def _caption_loss(model, b: dict) -> torch.Tensor:
    from avion_tpu_torch.models.narrator import caption_loss
    from avion_tpu_torch.train.steps import prep_video

    return caption_loss(model(prep_video(b["video"], dtype=model.dtype),
                              b["text"].long()), b["text"])


def _nr_seeded(tmp: str) -> dict:
    """(a)-(c): seeded training through ``train_narrator.
    build_model_and_state`` / ``make_narrator_step`` / ``train.loop``, a
    profiled step, a step against the CPU, an exact resume, 2 steps under
    the deterministic flag twice.  Returns the report and the resumed
    model."""
    from avion_tpu_torch.core.train_state import TrainState
    from avion_tpu_torch.optim.factory import build_optimizer
    from avion_tpu_torch.train.loop import save_epoch, setup_run
    from avion_tpu_torch.train.train_narrator import (build_model,
                                                      build_model_and_state,
                                                      make_narrator_step)

    out_dir = os.path.join(tmp, "narrator")
    cfg = _train_config(out_dir, recipe=NR_RECIPE)
    t0 = time.perf_counter()
    model, opt, _ = build_model_and_state(cfg, NR_STEPS)
    _open_gates(model)
    run = setup_run(cfg, model, opt, make_narrator_step(model))
    micro = cfg.data.batch_size
    batches = _caption_batches(NR_SEEDS, micro)
    log(f"== narrator (a): {cfg.model.name}, {FRAMES} frames, batch {NR_BATCH} "
        f"as {NR_MICRO} calls of {micro} (optim.accum=multistep), AdamW, "
        f"{NR_STEPS} calls over {NR_SEEDS} batches; "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"parameters, gates at {NR_GATE}; ready in "
        f"{time.perf_counter() - t0:.1f} s")
    per_step = _nr_step_launches(model)
    res = _timed_epoch(run, [batches[i % NR_SEEDS] for i in range(NR_STEPS)])
    report = _report_run("narrator (a)", res, micro, NR_STEPS, per_step,
                         _nr_flops(model, micro))
    report["updates"] = run.state.optimizer.count
    if report["updates"] != NR_STEPS // NR_MICRO:
        raise RuntimeError(f"narrator (a): {report['updates']} updates")
    paths = {"narrator_seeded": res["launches"]}
    report["profile"] = profile_step(run, _to_device(batches[0]))
    per_clip = _saved_bytes_per_clip(model, batches[0])
    report["saved_mib_a_clip"] = per_clip / 2 ** 20
    log(f"narrator (a): the forward keeps {per_clip / 2 ** 20:.1f} MiB of "
        f"activations a clip for the backward (no remat, as in JAX): "
        f"{NR_BATCH * per_clip / 2 ** 30:.1f} GiB for {NR_BATCH} clips in "
        f"one call, {micro * per_clip / 2 ** 30:.1f} GiB for {micro}")

    # (c) one small step against the CPU in f32, then an exact resume
    _reference_grads(model, build_model(cfg, torch.float32).to_empty(
        device="cpu"), {k: v[:NR_REF_BATCH] for k, v in batches[1].items()},
        _caption_loss, f"narrator (c) reference step at batch "
        f"{NR_REF_BATCH}")
    save_epoch(run, 0, res["summary"])
    saved = {k: v.detach().clone() for k, v in
             run.state.model.state_dict().items()}
    saved_opt = run.state.optimizer.state_dict()
    step = run.state.step
    del run, model, opt
    torch.cuda.empty_cache()
    model, opt, _ = build_model_and_state(_train_config(
        out_dir, "seed=1", recipe=NR_RECIPE), NR_STEPS)
    run = setup_run(cfg, model, opt, make_narrator_step(model))
    same = run.state.step == step and _same_state(run.state, saved,
                                                  saved_opt)
    log(f"narrator (c) checkpoint at step {step} restored into a model built "
        f"from another seed: step, parameters and AdamW moments bit for "
        f"bit: {same}")
    if not same:
        raise RuntimeError("narrator: the resume did not restore the state")
    del run, opt, saved, saved_opt

    # (b) two runs of NR_DET_STEPS steps under the flag from one state
    small = [_to_device({k: v[:NR_DET_BATCH] for k, v in b.items()})
             for b in batches[:NR_DET_STEPS]]
    det_cfg = _train_config(out_dir, "optim.update_freq=1",
                            recipe=NR_RECIPE)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs = []
    for _ in range(2):
        model.load_state_dict(start)
        state = TrainState.create(model, build_optimizer(
            det_cfg.optim, model, NR_STEPS, num_layers=model.layers)[0])
        step_fn = make_narrator_step(model)
        torch.cuda.synchronize()
        fa.reset_launches()  # (b)'s path, counted from here
        with deterministic():
            losses = []
            for b in small:
                state, m = step_fn(state, b)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
        runs.append((losses, dict(fa.launches), {
            k: v.detach().clone() for k, v in model.state_dict().items()}))
    want = {k: v * NR_DET_STEPS for k, v in
            _nr_step_launches(model, split=True).items()}
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(v, runs[1][2][k]) for k, v in runs[0][2].items())
    log(f"narrator (b) {NR_DET_STEPS} steps at batch {NR_DET_BATCH} under "
        f"the deterministic flag, twice from one state: losses "
        f"{runs[0][0]} / {runs[1][0]}, launches {runs[0][1]} / {runs[1][1]} "
        f"(want {want}), parameters bit for bit: {same}")
    if not same or runs[0][1] != want or runs[1][1] != want:
        raise RuntimeError("narrator (b): the flag's steps differ")
    paths["narrator_deterministic"] = runs[0][1]
    model.load_state_dict(start)
    del runs, start, state
    torch.cuda.empty_cache()
    return {"report": report, "paths": paths, "model": model}


def _nr_data(tmp: str, fixture: tuple) -> dict:
    """(d): ``train_narrator.main`` on the data phase's Ego4D layout (its
    first NR_DATA_BATCH x NR_DATA_STEPS rows) and a second ``main`` that
    restores and trains no step."""
    from avion_tpu_torch.core.config import TrainConfig
    from avion_tpu_torch.train import train_narrator

    root, meta = fixture
    with open(meta, "rb") as f:
        rows = pickle.load(f)[:NR_DATA_BATCH * NR_DATA_STEPS]
    sub = os.path.join(tmp, "narrator_rows.pkl")
    with open(sub, "wb") as f:
        pickle.dump(rows, f)
    out = os.path.join(tmp, "narrator_data")
    args = [*NR_RECIPE, f"output_dir={out}", f"data.root={root}",
            f"data.train_metadata={sub}",
            f"data.batch_size={NR_DATA_BATCH}", "optim.update_freq=1",
            f"data.num_workers={min(8, os.cpu_count() or 1)}",
            "optim.epochs=1"]
    cfg = TrainConfig().apply_overrides(args)
    ds, _ = train_narrator.build_loader(cfg, 77)
    ds[0]
    t0 = time.perf_counter()
    for i in range(1, 17):
        ds[i % len(ds)]
    decode_ms = (time.perf_counter() - t0) / 16 * 1e3
    log(f"== narrator (d): train_narrator.main on the Ego4D layout, "
        f"{len(rows)} rows, batch {NR_DATA_BATCH}; one caption item "
        f"(decode, rrc crop, tokenize) in one process: {decode_ms:.3f} ms")
    torch.cuda.synchronize()
    fa.reset_launches()  # (d)'s main path, counted from here
    t0 = time.perf_counter()
    res = train_narrator.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    with torch.device("meta"):
        want = {k: v * NR_DATA_STEPS for k, v in
                _nr_step_launches(train_narrator.build_model(cfg)).items()}
    recs = [r for r in _train_log(out) if "train/loss" in r]
    losses = [r["train/loss"] for r in recs]
    batch_ms = [r["perf/batch_time_win"] * 1e3 for r in recs]
    data_ms = [r["perf/data_time_win"] * 1e3 for r in recs]
    log(f"narrator (d): {res['steps']} steps, losses {losses}, launches "
        f"{launches} (want {want}), decode backend {res['decode_backend']}, "
        f"main() wall {wall:.2f} s, step ms {[round(x, 3) for x in batch_ms]}"
        f", data wait ms {[round(x, 3) for x in data_ms]}")
    if (res["steps"] != NR_DATA_STEPS or len(losses) != NR_DATA_STEPS
            or not np.isfinite(losses).all() or launches != want):
        raise RuntimeError("narrator (d): a data-fed step failed")
    fa.reset_launches()
    again = train_narrator.main(args)
    if again["steps"] != 0 or again["step"] != res["step"] or fa.launches:
        raise RuntimeError(f"narrator (d): the resume trained: {again}")
    log(f"narrator (d): a second main restored step {again['step']} and "
        f"trained no step")
    return {"launches": launches, "report": {
        "p50_ms": float(np.median(batch_ms[1:])),
        "p50_data_ms": float(np.median(data_ms[1:])),
        "first_step_ms": batch_ms[0], "decode_ms_a_clip": decode_ms}}


def _nr_generate(model, fixture: tuple) -> dict:
    """(e): ``tools.narrator.narrate_video`` with ``vclm_captioner`` (bf16
    inference copy, NR_SAMPLES samples of NR_MAX_LEN tokens) on one 15 s
    chunk of the layout; then one generation's cached per-step logits
    against a teacher-forced ``decode`` of its tokens."""
    from avion_tpu_torch.models.gpt2_gated import make_decode_cache
    from avion_tpu_torch.models.narrator import nucleus_sample_step
    from avion_tpu_torch.tools.narrator import narrate_video, vclm_captioner

    root, _ = fixture
    path = os.path.join(root, "vid0.mp4", "0.mp4")
    cap = vclm_captioner(model, num_samples=NR_SAMPLES, max_len=NR_MAX_LEN)
    clips = []

    def counted(frames):
        clips.append(frames)
        return cap(frames)

    torch.cuda.synchronize()
    fa.reset_launches()  # (e)'s main path, counted from here
    t0 = time.perf_counter()
    rows = narrate_video(path, counted, window_sec=NR_WINDOW_S,
                         stride_sec=NR_STRIDE_S, clip_length=FRAMES,
                         crop_size=SIZE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    want = {"flash_fwd": model.vision_layers * len(clips) * NR_SAMPLES}
    log(f"== narrator (e): narrate_video over a 15 s chunk: {len(clips)} "
        f"windows of {NR_WINDOW_S} s every {NR_STRIDE_S} s, {len(rows)} rows "
        f"after the dedup, {NR_SAMPLES} samples of {NR_MAX_LEN} tokens each; "
        f"wall {wall:.2f} s, {len(clips) / wall:.3f} windows/s; launches "
        f"{launches} (want {want}: the visual tower, none in the cached "
        f"decoder); first row {rows[0]}")
    if launches != want or not all(
            len(r[2]) == NR_SAMPLES and all(isinstance(c, str) for c in r[2])
            for r in rows):
        raise RuntimeError("narrator (e): generation failed")
    from avion_tpu_torch.data.transforms import normalize_video

    video = normalize_video(torch.from_numpy(clips[0])[None].to(NR_DEVICE),
                            dtype=model.dtype)
    g = torch.Generator(device=NR_DEVICE).manual_seed(0)
    with torch.inference_mode():
        visual = model.encode_video(video)
        cross = model.precompute_cross(visual)
        kv = make_decode_cache(model.layers, 1, NR_MAX_LEN, model.width,
                               model.dtype, NR_DEVICE)
        tokens = torch.zeros(1, NR_MAX_LEN, dtype=torch.long,
                             device=NR_DEVICE)
        tokens[:, 0] = 49406
        steps = []
        for i in range(1, NR_MAX_LEN):
            logits, kv = model.decode_one(tokens[:, i - 1:i], i - 1, kv,
                                          cross)
            steps.append(logits)
            tokens[:, i] = nucleus_sample_step(g, logits)
        fa.reset_launches()  # the uncached decode's path
        full = model.decode(tokens, visual)[:, :-1]
        torch.cuda.synchronize()
        teacher = dict(fa.launches)
        cached = torch.stack(steps, 1)
        rms = full.pow(2).mean().sqrt().item()
        max_err = (cached - full).abs().max().item() / rms
        rms_err = (cached - full).pow(2).mean().sqrt().item() / rms
    log(f"narrator (e) cached decode against the teacher-forced decode of "
        f"its {NR_MAX_LEN} tokens: logits RMS {rms:.4f}, max abs error / RMS "
        f"{max_err:.5f} (bound {NR_LOGIT_MAX_TOL}), RMS error / RMS "
        f"{rms_err:.5f} (bound {NR_LOGIT_RMS_TOL}); the teacher-forced "
        f"decoder's launches {teacher}")
    if not (max_err <= NR_LOGIT_MAX_TOL and rms_err <= NR_LOGIT_RMS_TOL):
        raise RuntimeError("narrator (e): cached logits disagree")
    if teacher != {"flash_fwd": model.layers}:
        raise RuntimeError(f"narrator (e): teacher-forced launches {teacher}")
    return {"launches": launches, "teacher_forced": teacher, "report": {
        "windows": len(clips), "windows_per_s": len(clips) / wall,
        "wall_s": wall, "logit_max_err_over_rms": max_err,
        "logit_rms_err_over_rms": rms_err}}


class _IdsTokenizer:
    """GPT-2's ids as text (its vocabulary is not in the repo)."""

    eos_token_id = 50256

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def _lavila(tmp: str) -> dict:
    """(f): the LaViLa narrator at full width on the card (seeded random
    weights, gates opened, bf16 inference copy) answering one
    ``/v1/narrate`` of ``serve.server.make_server``; then a full-width twin
    of LV_TWIN's depth, teacher-forced, against the CPU in f32."""
    from avion_tpu_torch.models.lavila import LavilaNarrator
    from avion_tpu_torch.models.pt_import import load_clip_checkpoint
    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.serve.server import (ClipService, NarrateService,
                                              make_server,
                                              serve_forever_in_thread)
    from avion_tpu_torch.tools.narrator import lavila_captioner

    t0 = time.perf_counter()
    with torch.device("meta"):
        xl = create_model(LV_MODEL, num_frames=FRAMES)
    xl = xl.to_empty(device=NR_DEVICE)
    xl.init_weights(torch.Generator(device=NR_DEVICE).manual_seed(0))
    _open_gates(xl)
    n_params = sum(p.numel() for p in xl.parameters())
    # the divided attention's two modes, a visual block, an encode
    want = {"flash_fwd": LV_SAMPLES * 2 * len(xl.visual.blocks)}
    clip = create_model(MODEL, num_frames=FRAMES)
    load_clip_checkpoint(clip, os.path.join(tmp, "clip_vitb16_random.pt"))
    service = ClipService(clip.to(NR_DEVICE), batch=32)
    narrate = NarrateService(
        lavila_captioner(model=xl, tokenizer=_IdsTokenizer(),
                         num_frames=FRAMES, num_samples=LV_SAMPLES,
                         max_len=LV_MAX_LEN),
        clip_length=FRAMES, image_size=LV_SIZE)
    server = make_server(service, port=0, narrate=narrate)
    serve_forever_in_thread(server)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    log(f"== narrator (f): {LV_MODEL}, {n_params / 1e9:.3f} B parameters "
        f"({sum(p.numel() * p.element_size() for p in xl.parameters()) / 2**30:.3f}"
        f" GiB after the bf16 cast), served in {time.perf_counter() - t0:.1f} s")
    try:
        clips = np.random.default_rng(5).integers(
            0, 256, (1, FRAMES, LV_SIZE, LV_SIZE, 3), dtype=np.uint8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        body, latency = _post(url, "/v1/narrate", _frames(clips))
        peak = torch.cuda.max_memory_allocated()
        launches = dict(fa.launches)
        metrics = _get(url, "/metrics")["narrate"]
    finally:
        server.shutdown()
        server.server_close()
        narrate.close()
        service.close()
    narrations = body.get("narrations", [])
    tokens = sum(len(c.split()) for n in narrations for c in n)
    log(f"narrator (f) one /v1/narrate of a {LV_SIZE} px clip: latency "
        f"{latency:.3f} s, {tokens} tokens generated ({tokens / latency:.1f} "
        f"tokens/s over 3 samples), peak memory "
        f"allocated {peak / 2**30:.3f} GiB, launches {launches} (expected "
        f"{want}), /metrics narrate requests {metrics.get('requests')}")
    if (len(narrations) != 1 or len(narrations[0]) != LV_SAMPLES
            or not all(narrations[0])):
        raise RuntimeError(f"narrator (f): bad answer {body}")
    if launches != want:
        raise RuntimeError(f"narrator (f): launches {launches}, expected "
                           f"{want}")
    del xl, clip, service, narrate
    torch.cuda.empty_cache()

    # the twin: full widths, LV_TWIN's depth; card bf16 against CPU f32
    kw = dict(num_frames=FRAMES, **LV_TWIN)
    cpu = LavilaNarrator(dtype=torch.float32, **kw)
    cpu.init_weights(torch.Generator().manual_seed(1))
    _open_gates(cpu)
    card = LavilaNarrator(dtype=torch.bfloat16, **kw)
    card.load_state_dict(cpu.state_dict())
    card = card.to(NR_DEVICE).eval()
    rng = np.random.default_rng(6)
    video = torch.from_numpy(rng.standard_normal(
        (1, FRAMES, cpu.image_size, cpu.image_size, 3)).astype(np.float32))
    text = torch.from_numpy(rng.integers(
        0, cpu.text_decoder.transformer.wte.num_embeddings, (1, 16)))
    with torch.inference_mode():
        ref = cpu(video, text)["logits"].double()
        got = card(video.to(NR_DEVICE),
                   text.to(NR_DEVICE))["logits"].cpu().double()
    cos = float((ref * got).sum() / (ref.norm() * got.norm()))
    log(f"narrator (f) full-width twin ({LV_TWIN}) teacher-forced logits, "
        f"card bf16 against CPU f32: cosine {cos:.6f} (bound 0.99)")
    if not cos >= 0.99:
        raise RuntimeError("narrator (f): the twin disagrees with the CPU")
    return {"latency_s": latency, "tokens": tokens,
            "tokens_per_s": tokens / latency, "peak_gib": peak / 2 ** 30,
            "params": n_params, "twin_cosine": cos, "launches": launches}


def _lv_kernel_rows() -> dict:
    """Every kernel at LV_KERNEL_SHAPES against its plain f32 version,
    timed beside its bound; rows by kernel."""
    rows = {name: [] for name in fa.KERNELS}
    for shapes, check, batch, forward_only in LV_KERNEL_SHAPES:
        got = _slice_kernel_rows(shapes, check, batch, 18, "LaViLa's shapes",
                                 forward_only=forward_only)
        for name in rows:
            rows[name] += got[name]
    return rows


def phase_narrator(tmp: str, fixture: tuple) -> dict:
    """The narrator slice on one card: the kernels at its new shapes; (a)
    seeded VCLM_VITB16 training, (b) the flag's split steps bit for bit,
    (c) a step against the CPU and an exact resume, (d) ``train_narrator.
    main`` on decoded video and its resume, (e) generation through
    ``tools.narrator``, (f) LaViLa at full width behind ``/v1/narrate``.
    Returns the launches by path and the kernels' rows."""
    log("== narrator")
    t_phase = time.perf_counter()
    rows = _slice_kernel_rows(NR_SHAPES, 4, 128, 12, "the narrator's shapes")
    gen_rows = _slice_kernel_rows(NR_GEN_SHAPES, NR_SAMPLES, NR_SAMPLES, 13,
                                  "the narrator's generation",
                                  forward_only=True)
    for name in rows:
        rows[name] += gen_rows[name]
    for name, lv in _lv_kernel_rows().items():
        rows[name] += lv
    seeded = _nr_seeded(tmp)
    gen = _nr_generate(seeded.pop("model"), fixture)
    torch.cuda.empty_cache()
    data = _nr_data(tmp, fixture)
    lavila = _lavila(tmp)
    paths = {**seeded["paths"], "narrator_data": data["launches"],
             "narrator_generate": gen["launches"],
             "narrator_teacher_forced": gen["teacher_forced"],
             "narrator_lavila": lavila["launches"]}
    report = {"seeded": seeded["report"], "data": data["report"],
              "generate": gen["report"], "lavila": lavila}
    log("narrator summary " + json.dumps(report, default=float))
    log(f"narrator phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "paths": paths}


# the EgoNLQ slice: one NLQ clip (an Ego4D NLQ clip is 480 s; 120 s here,
# for time) of 512x288 at 30 fps, and 64 queries in the official schema
NLQ_VIDEO_S, NLQ_W, NLQ_H, NLQ_FPS, NLQ_QUERIES = 120, 512, 288, 30, 64
NLQ_VDIM = NLQ_QDIM = 512  # CLIP_VITB16's embed_dim: both feature widths
NLQ_WHERE = ("where did I put", "where was", "what did I do with",
             "how many times did I touch", "in what location did I see",
             "who handed me")


def write_nlq_fixture(root: str, seed: int = 0, *,
                      seconds: float = NLQ_VIDEO_S, w: int = NLQ_W,
                      h: int = NLQ_H, fps: int = NLQ_FPS,
                      queries: int = NLQ_QUERIES) -> str:
    """``root/nlqvid0.mp4`` (mp4v, a seeded texture sliding one pixel a
    frame) and an Ego4D NLQ json in the official schema (one video, one
    clip from 0 to ``seconds``, ``queries`` language queries of varied
    lengths with their spans); returns the json's path."""
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    _write_chunk(os.path.join(root, "nlqvid0.mp4"), _canvas(rs, w, h), 0,
                 int(seconds * fps), fps)
    qs = []
    for i in range(queries):
        words = [NLQ_WHERE[rs.randint(len(NLQ_WHERE))],
                 NOUNS[rs.randint(len(NOUNS))]]
        for _ in range(i % 4):  # 0 to 3 more clauses
            words += ["after I", VERBS[rs.randint(len(VERBS))],
                      NOUNS[rs.randint(len(NOUNS))]]
        length = float(rs.uniform(1.0, min(8.0, seconds / 2)))
        start = float(rs.uniform(0.0, seconds - length))
        qs.append({"query": " ".join(words) + "?", "clip_start_sec": start,
                   "clip_end_sec": start + length})
    ann = {"version": "v1", "videos": [{"video_uid": "nlqvid0", "clips": [{
        "clip_uid": "nlqclip0", "video_start_sec": 0.0,
        "video_end_sec": float(seconds),
        "annotations": [{"annotation_uid": "a0",
                         "language_queries": qs}]}]}]}
    path = os.path.join(root, "nlq.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


def write_nlq_features(root: str, n: int, seed: int, *, lv: int = 32,
                       duration: float = 64.0, vdim: int = NLQ_VDIM,
                       qdim: int = NLQ_QDIM) -> str:
    """The planted-span generator of ``tests/test_nlq_entry.py``:
    ``feat_<i>.npz`` whose rows inside the ground-truth span carry a shared
    linear image of the query vector (a learnable correlation), and their
    annotations; returns the json's path."""
    rs = np.random.RandomState(seed)
    proj = np.random.RandomState(7).randn(qdim, vdim).astype(np.float32)
    videos = []
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        q = rs.randn(qdim).astype(np.float32)
        q /= np.linalg.norm(q)
        video = 0.3 * rs.randn(lv, vdim).astype(np.float32)
        s = int(rs.randint(0, lv - 6))
        e = s + int(rs.randint(2, 6))
        video[s : e + 1] += q @ proj
        scale = duration / lv
        np.savez(os.path.join(root, f"feat_{i}.npz"), video=video, text=q)
        videos.append({
            "video_uid": f"v{i}",
            "clips": [{
                "clip_uid": f"c{i}", "video_start_sec": 0.0,
                "video_end_sec": duration,
                "annotations": [{"language_queries": [
                    {"query": f"synthetic query {i}",
                     "clip_start_sec": s * scale,
                     "clip_end_sec": (e + 1) * scale},
                ]}],
            }],
        })
    path = os.path.join(root, f"nlq_{seed}.json")
    with open(path, "w") as f:
        json.dump({"videos": videos}, f)
    return path


NLQ_BATCH = 32  # extract_features' --batch default: windows a batch
# the kernel at the extractor's shapes: a batch of 32 windows through the
# visual tower (phase 3's first shape) and one query through the text tower
NLQ_SHAPES = [("NLQ visual, 32 windows", 785, 12, 64, False)]
NLQ_TEXT_SHAPES = [("NLQ text, one query", 77, 8, 64, True)]
# (b): train_nlq.main at the NLQConfig defaults on NLQ_TRAIN planted-span
# samples of the extractor's widths, 2 epochs of 32 steps; NLQ_VAL of them
# evaluated after each epoch
NLQ_TRAIN, NLQ_VAL, NLQ_EPOCHS = 1024, 256, 2
NLQ_REF_BATCH = 8
NLQ_LEGACY = {}  # (d)'s FrozenInTime keywords: the released geometry
NLQ_TWIN = dict(layers=2, text_layers=2)  # (d)'s CPU reference depth
NLQ_DEVICE = "cuda"


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _nlq_extract(tmp: str, root: str, ann: str, ckpt: str) -> dict:
    """(a): ``extract_features.main`` at CLIP_VITB16 over the NLQ clip; the
    launches, rates and peak memory; one profiled window batch; 2 windows
    and 2 queries against the CPU in f32."""
    from avion_tpu_torch.egonlq import extract_features
    from avion_tpu_torch.egonlq.features import FeatureExtractor
    from avion_tpu_torch.egonlq.nlq_dataset import parse_nlq_annotations
    from avion_tpu_torch.models.pt_import import load_clip_checkpoint
    from avion_tpu_torch.models.registry import create_model

    out = os.path.join(tmp, "nlq_features")
    args = ["--ckpt", ckpt, "--model", MODEL, "--annotations", ann,
            "--video-root", root, "--out", out, "--clip-length", str(FRAMES),
            "--batch", str(NLQ_BATCH)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # (a)'s main path, counted from here
    t0 = time.perf_counter()
    stats = extract_features.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    samples = parse_nlq_annotations(ann)
    windows = stats["windows"]
    batches = -(-windows // NLQ_BATCH)
    want = {"flash_fwd": LAYERS * batches + LAYERS * len(samples)}
    feats = [np.load(os.path.join(out, f"feat_{i}.npz"))
             for i in range(len(samples))]
    report = {
        "windows": windows, "queries": stats["queries"], "wall_s": wall,
        "windows_per_s": windows / (stats["decode_s"] + stats["encode_s"]),
        "encode_windows_per_s": windows / stats["encode_s"],
        "decode_ms_a_window": stats["decode_s"] / windows * 1e3,
        "ms_a_query": stats["text_s"] / stats["queries"] * 1e3,
        "first_query_ms": stats["query_ms"][0],
        "p50_query_ms": float(np.median(stats["query_ms"][1:])),
        "peak_gib": peak / 2 ** 30}
    log(f"== egonlq (a): extract_features.main, {MODEL} at {FRAMES} frames, "
        f"a {NLQ_VIDEO_S} s clip at {NLQ_W}x{NLQ_H}: {windows} windows in "
        f"{batches} batches of {NLQ_BATCH}, {len(samples)} queries; main() "
        f"wall {wall:.2f} s; {report['windows_per_s']:.3f} windows/s "
        f"(decode and encode), {report['encode_windows_per_s']:.3f} "
        f"windows/s encoding alone, decode {report['decode_ms_a_window']:.3f}"
        f" ms a window, {report['ms_a_query']:.3f} ms a query (the first "
        f"{report['first_query_ms']:.3f} ms with the tokenizer's load, p50 "
        f"of the rest {report['p50_query_ms']:.3f}), peak memory "
        f"allocated {report['peak_gib']:.3f} GiB; launches {launches} (want "
        f"{want}: {LAYERS} x {batches} visual + {LAYERS} x {len(samples)} "
        f"text)")
    if windows != NLQ_VIDEO_S // 2 or launches != want:
        raise RuntimeError("egonlq (a): extraction went wrong")
    if not all(f["video"].shape == (windows, NLQ_VDIM)
               and f["text"].shape == (NLQ_QDIM,)
               and np.isfinite(f["video"]).all()
               and np.isfinite(f["text"]).all() for f in feats):
        raise RuntimeError(f"egonlq (a): feature shapes "
                           f"{feats[0]['video'].shape}, "
                           f"{feats[0]['text'].shape}")

    # one window batch profiled on the card's extractor
    model = create_model(MODEL, num_frames=FRAMES)
    load_clip_checkpoint(model, ckpt)
    fx = FeatureExtractor(model.to(NLQ_DEVICE), clip_length=FRAMES,
                          crop_size=model.image_size, batch=NLQ_BATCH)
    clips = fx.decode_windows(os.path.join(root, "nlqvid0.mp4"))
    report["profile"] = _profile_call(
        lambda: fx.encode_windows(clips[:NLQ_BATCH]),
        f"one batch of {NLQ_BATCH} windows (the host-to-device copy, both "
        f"normalizations, the visual tower, the projection, the copy back)")
    del fx, model
    torch.cuda.empty_cache()

    # 2 windows and 2 queries on the CPU in f32
    cpu = create_model(MODEL, num_frames=FRAMES, dtype=torch.float32)
    load_clip_checkpoint(cpu, ckpt)
    ref = FeatureExtractor(cpu, clip_length=FRAMES,
                           crop_size=cpu.image_size, batch=2)
    v_cos = _cosines(feats[0]["video"][:2], ref.encode_windows(clips[:2]))
    t_cos = _cosines(np.stack([f["text"] for f in feats[:2]]),
                     np.concatenate([ref.text_features([s["query"]])
                                     for s in samples[:2]]))
    report["cpu_cosines"] = [*v_cos.tolist(), *t_cos.tolist()]
    log(f"egonlq (a) the card's features (bf16) against the CPU's (f32): "
        f"window cosines {v_cos.tolist()}, query cosines {t_cos.tolist()} "
        f"(bound 0.99)")
    if not (v_cos.min() >= 0.99 and t_cos.min() >= 0.99):
        raise RuntimeError("egonlq (a): the card disagrees with the CPU")
    return {"launches": launches, "report": report, "out": out,
            "clips": clips[:2], "samples": samples}


def _profile_call(fn, what: str) -> dict:
    """Wall, device busy (the union of the device's intervals) and idle
    share of one call of ``fn`` (synchronized), with the device time by
    kind; empty when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = _device_busy_ms(prof)
    if not busy:
        log(f"profile of {what}: the profiler saw no device time (not "
            f"measured)")
        return {}
    log(f"profile of {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
        f"idle share {1 - busy / wall:.4f}; device time by kind:")
    log_device_time(_device_ms_by_name(prof), top=8)
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall}


def _nlq_args(out: str, ann: str, feats: str, *extra: str) -> list:
    return [f"annotations={ann}", f"feature_dir={feats}", f"output_dir={out}",
            "print_freq=1", *extra]


def _nlq_train(tmp: str, ext: dict, ann_a: str) -> dict:
    """(b) ``train_nlq.main`` at the NLQConfig defaults on planted-span
    features of the extractor's widths, evaluated; one epoch on (a)'s
    extracted samples; (c) one step against the CPU and a resume that
    trains no step."""
    from avion_tpu_torch.egonlq import train_nlq

    feats = os.path.join(tmp, "nlq_planted")
    ann = write_nlq_features(feats, NLQ_TRAIN, seed=0, lv=NLQ_VIDEO_S // 2,
                             duration=float(NLQ_VIDEO_S), vdim=NLQ_VDIM,
                             qdim=NLQ_QDIM)
    with open(ann) as f:
        data = json.load(f)
    val = os.path.join(feats, "nlq_val.json")
    with open(val, "w") as f:
        json.dump({"videos": data["videos"][:NLQ_VAL]}, f)
    out = os.path.join(tmp, "nlq_train")
    cfg = train_nlq.NLQConfig()
    steps = NLQ_TRAIN // cfg.batch_size * NLQ_EPOCHS
    args = _nlq_args(out, ann, feats, f"val_annotations={val}",
                     f"epochs={NLQ_EPOCHS}")
    profiler = _ProfileLastSteps(train_nlq.make_train_step, steps)
    train_nlq.make_train_step = profiler
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_nlq.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train_nlq.make_train_step = profiler.make_step
    peak = torch.cuda.max_memory_allocated()
    recs = _train_log(out)
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    batch_ms = np.array([r["perf/batch_time_win"] * 1e3 for r in recs
                         if "train/loss" in r])
    data_ms = np.array([r["perf/data_time_win"] * 1e3 for r in recs
                        if "train/loss" in r])
    vals = [{k[4:]: v for k, v in r.items() if k.startswith("val/")}
            for r in recs if any(k.startswith("val/") for k in r)]
    p50 = float(np.median(batch_ms[2:]))
    report = {
        "steps": res["step"], "p50_ms": p50,
        "queries_per_s": cfg.batch_size / p50 * 1e3,
        "p50_data_ms": float(np.median(data_ms[2:])),
        "idle_share": (1 - profiler.busy_ms / profiler.wall_ms
                       if profiler.busy_ms else None),
        "peak_gib": peak / 2 ** 30, "wall_s": wall, "val": vals}
    log(f"== egonlq (b): train_nlq.main at the NLQConfig defaults (dim "
        f"{cfg.dim}, {cfg.num_heads} heads, max_pos_len {cfg.max_pos_len}, "
        f"drop {cfg.drop_rate}, lr {cfg.lr}, batch {cfg.batch_size}, "
        f"{cfg.variant}) on {NLQ_TRAIN} planted-span samples ({NLQ_VDIM} "
        f"video, {NLQ_QDIM} query), {NLQ_EPOCHS} epochs, {res['step']} steps;"
        f" main() wall {wall:.2f} s; losses {[round(x, 4) for x in losses]}")
    log(f"egonlq (b): p50 step {p50:.3f} ms (steps 3-{steps}), "
        f"{report['queries_per_s']:.1f} queries/s, p50 data wait "
        f"{report['p50_data_ms']:.3f} ms, the last 2 steps with their "
        f"batches: wall {profiler.wall_ms:.3f} ms, device busy "
        f"{profiler.busy_ms:.3f} ms, idle share {report['idle_share']}, peak "
        f"memory allocated {report['peak_gib']:.4f} GiB; evaluation on "
        f"{NLQ_VAL} queries after each epoch: {vals}")
    if (res["steps"] != steps or len(losses) != steps
            or not np.isfinite(losses).all() or len(vals) != NLQ_EPOCHS):
        raise RuntimeError("egonlq (b): training failed")

    # the extracted features: widths from the data, one epoch
    out_a = os.path.join(tmp, "nlq_train_extracted")
    res_a = train_nlq.main(_nlq_args(out_a, ann_a, ext["out"], "epochs=1"))
    losses_a = [r["train/loss"] for r in _train_log(out_a)
                if "train/loss" in r]
    width = res_a["model"].video_affine.in_features
    log(f"egonlq (b) one epoch on (a)'s {len(ext['samples'])} extracted "
        f"samples: {res_a['steps']} steps, losses {losses_a}, video_affine "
        f"in {width}, query_affine in "
        f"{res_a['model'].query_affine.in_features}")
    if (res_a["steps"] != max(1, len(ext["samples"]) // cfg.batch_size)
            or not np.isfinite(losses_a).all() or width != NLQ_VDIM):
        raise RuntimeError("egonlq (b): the extracted features did not train")

    # (c) one step at batch 8, f32, drop 0, card against CPU; a resume
    ref_cfg = train_nlq.parse_config(["drop_rate=0.0"])
    cpu = train_nlq.build_model(ref_cfg, NLQ_VDIM, NLQ_QDIM)
    cpu.init_weights(torch.Generator().manual_seed(0))
    card = train_nlq.build_model(ref_cfg, NLQ_VDIM, NLQ_QDIM)
    card.load_state_dict(cpu.state_dict())
    card = card.to(NLQ_DEVICE)
    from avion_tpu_torch.egonlq.nlq_dataset import (NLQFeatureDataset,
                                                    parse_nlq_annotations)

    ds = NLQFeatureDataset(parse_nlq_annotations(ann), feats)
    batch = train_nlq._collate([ds[i] for i in range(NLQ_REF_BATCH)])

    def loss_fn(model, b):
        from avion_tpu_torch.egonlq.vslnet import vslnet_loss

        out_ = model(b["video"], b["v_mask"], b["query"], b["q_mask"], False)
        return vslnet_loss(*out_, b, ref_cfg.highlight_weight)[0]

    _reference_grads(card, cpu, batch, loss_fn,
                     f"egonlq (c) a step at batch {NLQ_REF_BATCH}, f32, drop "
                     f"0", loss_tol=1e-3, cos_tol=0.999)
    again = train_nlq.main(args)
    log(f"egonlq (c): a second main restored step {again['step']} and "
        f"trained {again['steps']} steps")
    if again["steps"] != 0 or again["step"] != steps:
        raise RuntimeError(f"egonlq (c): the resume trained: {again}")
    return {"report": report}


def random_egovlp_state(model, seed: int = 0) -> dict:
    """A seeded random state dict of ``model`` (a ``FrozenInTime``) in the
    released EgoVLP layout, with the entries feature extraction does not
    read (a fusion block's, the text pooler, the ITM / MLM heads): weights
    normal(0.02), LayerNorms ones and zeros, biases zeros."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("bias"):
            sd[k] = torch.zeros(v.shape)
        elif ("norm" in k or "LayerNorm" in k) and v.dim() == 1:
            sd[k] = torch.ones(v.shape)
        else:
            sd[k] = torch.randn(v.shape, generator=gen) * 0.02
    w = model.video_model.width
    sd["video_model.blocks.0.attn.qkv_text_i2t.weight"] = torch.zeros(2 * w, w)
    sd["video_model.blocks.0.attn.alpha_i2t"] = torch.zeros(1)
    sd["text_model.pooler.dense.weight"] = torch.zeros(w, w)
    sd["itm_score.fc.weight"] = torch.zeros(2, 2 * w)
    sd["mlm_score.bias"] = torch.zeros(8)
    return sd


def write_roberta_vocab(path: str) -> str:
    """A made-up HF-format RoBERTa tokenizer directory: the specials at ids
    0-4, the 256 byte symbols and a few merges."""
    from avion_tpu_torch.data.tokenizer import _byte_to_unicode

    vocab = {t: i for i, t in enumerate(("<s>", "<pad>", "</s>", "<unk>",
                                         "<mask>"))}
    for ch in _byte_to_unicode().values():
        vocab[ch] = len(vocab)
    merges = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("Ġ", "w"), ("e", "r"),
              ("Ġw", "her"), ("h", "er"), ("Ġwher", "e"), ("Ġ", "I")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return path


def _nlq_legacy(tmp: str, root: str, ann: str, clips: np.ndarray,
                samples: list) -> dict:
    """(d): ``extract_features.main --legacy`` with the full-width
    FrozenInTime (seeded random weights in the released layout) and a
    made-up tokenizer; then a twin of NLQ_TWIN's depth against the CPU."""
    from avion_tpu_torch.data.roberta_tokenizer import RobertaTokenizer
    from avion_tpu_torch.egonlq import extract_features
    from avion_tpu_torch.egonlq.egovlp import (EgoVLPFeatureExtractor,
                                               FrozenInTime,
                                               load_egovlp_checkpoint)

    t0 = time.perf_counter()
    with torch.device("meta"):
        full = FrozenInTime(num_frames=FRAMES, **NLQ_LEGACY)
    proj = full.vid_proj[4].out_features
    n_params = sum(p.numel() for p in full.parameters())
    pth = os.path.join(tmp, "egovlp_random.pth")
    torch.save({"state_dict": random_egovlp_state(full)}, pth)
    tok = write_roberta_vocab(os.path.join(tmp, "roberta_tok"))
    out = os.path.join(tmp, "nlq_legacy")
    log(f"== egonlq (d): FrozenInTime, {n_params / 1e6:.1f} M parameters "
        f"(a TimeSformer of {len(full.video_model.blocks)} blocks at width "
        f"{full.video_model.width}, a RoBERTa of "
        f"{len(full.text_model.encoder['layer'])} layers, {proj}-wide "
        f"projections), written in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # (d)'s path: no kernel
    t0 = time.perf_counter()
    stats = extract_features.main([
        "--legacy", "--ckpt", pth, "--tokenizer-dir", tok, "--annotations",
        ann, "--video-root", root, "--out", out, "--clip-length", str(FRAMES),
        "--batch", str(NLQ_BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    z = np.load(os.path.join(out, "feat_0.npz"))
    report = {
        "params": n_params, "wall_s": wall,
        "windows_per_s": stats["windows"] / (stats["decode_s"]
                                             + stats["encode_s"]),
        "encode_windows_per_s": stats["windows"] / stats["encode_s"],
        "ms_a_query": stats["text_s"] / stats["queries"] * 1e3,
        "first_query_ms": stats["query_ms"][0],
        "p50_query_ms": float(np.median(stats["query_ms"][1:])),
        "peak_gib": peak / 2 ** 30}
    log(f"egonlq (d) extract_features.main --legacy: main() wall {wall:.2f} "
        f"s, {stats['windows']} windows, {report['windows_per_s']:.3f} "
        f"windows/s (decode and encode), {report['encode_windows_per_s']:.3f}"
        f" encoding alone, {report['ms_a_query']:.3f} ms a query (the first "
        f"{report['first_query_ms']:.3f}, p50 of the rest "
        f"{report['p50_query_ms']:.3f}), peak "
        f"memory allocated {report['peak_gib']:.3f} GiB, launches {launches} "
        f"(want none), features {z['video'].shape} {z['text'].shape}")
    if (launches or z["video"].shape != (NLQ_VIDEO_S // 2, proj)
            or z["text"].shape != (proj,) or not np.isfinite(z["video"]).all()
            or not np.isfinite(z["text"]).all()):
        raise RuntimeError("egonlq (d): the legacy extraction went wrong")
    torch.cuda.empty_cache()

    # the twin: full widths, NLQ_TWIN's depth, card f32 against CPU f32
    twin = FrozenInTime(num_frames=FRAMES, **{**NLQ_LEGACY, **NLQ_TWIN})
    state = random_egovlp_state(twin, seed=1)
    tokenizer = RobertaTokenizer.from_dir(tok)
    feats = []
    for device in (NLQ_DEVICE, "cpu"):
        fx = EgoVLPFeatureExtractor(
            load_egovlp_checkpoint(state, num_frames=FRAMES).to(device),
            tokenizer=tokenizer, clip_length=FRAMES,
            crop_size=twin.image_size, batch=2)
        feats.append((fx.encode_windows(clips),
                      fx.text_features([s["query"] for s in samples[:2]])))
    v_cos = _cosines(feats[0][0], feats[1][0])
    t_cos = _cosines(feats[0][1], feats[1][1])
    report["twin_cosines"] = [*v_cos.tolist(), *t_cos.tolist()]
    log(f"egonlq (d) twin ({NLQ_TWIN}) card f32 against CPU f32: window "
        f"cosines {v_cos.tolist()}, query cosines {t_cos.tolist()} (bound "
        f"0.99)")
    if not (v_cos.min() >= 0.99 and t_cos.min() >= 0.99):
        raise RuntimeError("egonlq (d): the twin disagrees with the CPU")
    return {"launches": launches, "report": report}


def phase_egonlq(tmp: str, ckpt: str) -> dict:
    """The EgoNLQ slice on one card: the inference kernel at the
    extractor's shapes; (a) feature extraction through ``extract_features.
    main``, (b) ``train_nlq.main`` on planted-span features and on (a)'s,
    (c) a step against the CPU and a resume, (d) the legacy EgoVLP
    extractor.  Returns the launches by path and the kernels' rows."""
    log("== egonlq")
    t_phase = time.perf_counter()
    rows = _slice_kernel_rows(NLQ_SHAPES, 4, NLQ_BATCH, 14,
                              "the NLQ extractor's windows",
                              forward_only=True)
    text_rows = _slice_kernel_rows(NLQ_TEXT_SHAPES, 1, 1, 15,
                                   "the NLQ extractor's queries",
                                   forward_only=True)
    for name in rows:
        rows[name] += text_rows[name]
    root = os.path.join(tmp, "nlq")
    t0 = time.perf_counter()
    ann = write_nlq_fixture(root, seconds=NLQ_VIDEO_S, w=NLQ_W, h=NLQ_H,
                            fps=NLQ_FPS, queries=NLQ_QUERIES)
    log(f"egonlq: the {NLQ_VIDEO_S} s clip and {NLQ_QUERIES} queries written "
        f"in {time.perf_counter() - t0:.1f} s")
    ext = _nlq_extract(tmp, root, ann, ckpt)
    train = _nlq_train(tmp, ext, ann)
    legacy = _nlq_legacy(tmp, root, ann, ext["clips"], ext["samples"])
    report = {"extract": ext["report"], "train": train["report"],
              "legacy": legacy["report"]}
    log("egonlq summary " + json.dumps(report, default=float))
    log(f"egonlq phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "paths": {"nlq_features": ext["launches"],
                                    "nlq_legacy": legacy["launches"]}}


ST_REQUESTS = 5  # timed requests of each route: paths and frames_b64
ST_MESH = "mesh.data=-1"  # every visible card: one replica on one card
ST_PROFILE_BATCH = 32
ST_DEVICE = "cuda"
ST_TOL = 1e-2  # paths against frames_b64 of the same host decode


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = val
    return tree


def _export_import(tmp: str) -> str:
    """(a) ``convert_checkpoint export`` of phase 5's checkpoint, loaded
    back strict and bit-equal to the saved model; ``import`` of the serve
    phase's ``.pt`` to the JAX package's ``.npz``, read back through
    ``params_from_jax`` bit-equal to ``import_clip_pt``.  Returns the
    exported ``.pt``."""
    from avion_tpu_torch.models.pt_import import (import_clip_pt,
                                                  load_clip_checkpoint,
                                                  params_from_jax)
    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.tools import convert_checkpoint
    from avion_tpu_torch.train.common import latest_model_state

    t0 = time.perf_counter()
    run_dir = os.path.join(tmp, "train")
    exported = os.path.join(tmp, "clip_exported.pt")
    geometry = ["--model", MODEL, "--frames", str(FRAMES)]
    convert_checkpoint.main(["export", "--src", run_dir, "--dst", exported,
                             *geometry])
    state = latest_model_state(run_dir)
    model = create_model(MODEL, num_frames=FRAMES, dtype=torch.float32)
    load_clip_checkpoint(model, exported)
    loaded = model.state_dict()
    bad = [k for k in state if k not in loaded or not torch.equal(
        loaded[k], state[k].detach().cpu())]
    if set(loaded) != set(state) or bad:
        raise RuntimeError(f"export: {len(bad)} tensors differ, e.g. "
                           f"{bad[:3]}")
    src, npz = (os.path.join(tmp, "clip_vitb16_random.pt"),
                os.path.join(tmp, "clip_imported.npz"))
    convert_checkpoint.main(["import", "--src", src, "--dst", npz,
                             *geometry])
    with np.load(npz) as z:
        back = params_from_jax(_unflatten({k: z[k] for k in z.files}))
    ref = import_clip_pt(src, num_frames=FRAMES)
    bad = [k for k in ref if k not in back or not torch.equal(back[k],
                                                              ref[k])]
    if set(back) != set(ref) or bad:
        raise RuntimeError(f"import: {len(bad)} arrays differ, e.g. "
                           f"{bad[:3]}")
    log(f"(a) export of phase 5's checkpoint ({len(state)} tensors), loaded "
        f"strict, bit for bit; import to {len(back)} flax arrays and back, "
        f"bit for bit; {time.perf_counter() - t0:.1f} s")
    return exported


def _status(url: str, path: str, obj: dict) -> int:
    try:
        _post(url, path, obj)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def _int8_matrices(model) -> tuple:
    """(the int8 matrices' count, the matrices in another dtype that
    quantization should have taken) of a served replica, whose every
    parameter must be on the card."""
    from avion_tpu_torch.eval.runners import _CAST_EXCLUDE

    int8, wrong = 0, []
    for name, p in model.named_parameters():
        if ST_DEVICE == "cuda" and p.device.type != "cuda":
            raise RuntimeError(f"{name} is on {p.device}")
        if p.dtype == torch.int8:
            int8 += 1
        elif p.dim() >= 2 and not any(k in name.lower()
                                      for k in _CAST_EXCLUDE):
            wrong.append(name)
    return int8, wrong


def _serve_paths_int8(tmp: str, root: str, exported: str,
                      bf16: dict) -> dict:
    """(b) ``serve.server.main`` with ``--weights int8 --mesh`` and
    ``--media-root`` on the data phase's Ego4D layout: ``paths`` requests
    against ``frames_b64`` of the same clips decoded on the host, the CPU
    f32 plain path, the launches, the status codes, the weight bytes."""
    from avion_tpu_torch.data.tokenizer import tokenize
    from avion_tpu_torch.data.transforms import normalize_video
    from avion_tpu_torch.models.pt_import import load_clip_checkpoint
    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.serve.server import decode_clip, main

    rel = sorted(os.path.relpath(p, root) for p in
                 glob.glob(os.path.join(root, "*.mp4", "*.mp4")))
    t0 = time.perf_counter()
    host = np.stack([decode_clip(os.path.join(root, p), FRAMES, SIZE)
                     for p in rel])
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(rel)
    window = dict(start=2.0, end=6.5)
    host_window = np.stack([decode_clip(os.path.join(root, p), FRAMES, SIZE,
                                        **window) for p in rel[:4]])
    log(f"(b) {len(rel)} clips under the media root; host decode "
        f"{decode_ms:.2f} ms a clip ({FRAMES} frames, {SIZE} px)")

    ready: queue.Queue = queue.Queue()
    errors: list = []

    def run():
        try:
            main([f"model.name={MODEL}", f"data.clip_length={FRAMES}",
                  f"data.val_batch_size={BATCH}", f"pretrain_model={exported}",
                  "--port", "0", "--weights", "int8", "--mesh", ST_MESH,
                  "--media-root", root, "--device", ST_DEVICE],
                 on_ready=ready.put)
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller
            errors.append(e)
            ready.put(None)

    th = threading.Thread(target=run, name="serve-int8")
    th.start()
    server = ready.get(timeout=600)
    if server is None:
        raise RuntimeError("the int8 server failed to start") from errors[0]
    url = f"http://127.0.0.1:{server.server_address[1]}"
    texts = ["#C C cuts an onion", "#C C opens the fridge"]
    try:
        health = _get(url, "/health")
        log(f"health {health}")
        replica = server.service.encoders.replicas[0]
        int8, wrong = _int8_matrices(replica)
        _post(url, "/v1/embed/video", {"paths": rel[:2]})  # warm up
        _post(url, "/v1/embed/text", {"texts": texts[:1]})

        # the main path, with the launch count set to 0 just before
        before = _get(url, "/metrics")["encoder"]
        fa.reset_launches()
        paths_emb, frames_emb, lat_paths, lat_frames = [], [], [], []
        for _ in range(ST_REQUESTS):
            body, dt = _post(url, "/v1/embed/video", {"paths": rel})
            paths_emb.append(body["embeddings"])
            lat_paths.append(dt * 1e3)
            body, dt = _post(url, "/v1/embed/video", _frames(host))
            frames_emb.append(body["embeddings"])
            lat_frames.append(dt * 1e3)
        win_paths = _post(url, "/v1/embed/video",
                          {"paths": rel[:4], **window})[0]["embeddings"]
        win_frames = _post(url, "/v1/embed/video",
                           _frames(host_window))[0]["embeddings"]
        text_emb = _post(url, "/v1/embed/text", {"texts": texts})[0][
            "embeddings"]
        launches = dict(fa.launches)
        after = _get(url, "/metrics")["encoder"]
        log("int8 frames_b64 requests, each profiled alone:")
        profile_request(url, host)
        codes = {"escape": _status(url, "/v1/embed/video",
                                   {"paths": ["../outside.mp4"]}),
                 "missing": _status(url, "/v1/embed/video",
                                    {"paths": ["vid0.mp4/999.mp4"]})}
    finally:
        server.shutdown()
        th.join(timeout=120)
    if th.is_alive():
        raise RuntimeError("server thread did not stop")
    if errors:
        raise errors[0]

    if health["platform"] != "gpu" and ST_DEVICE == "cuda":
        raise RuntimeError(f"not serving on the GPU: {health}")
    if len(health["replicas"]) != torch.cuda.device_count() and \
            ST_DEVICE == "cuda":
        raise RuntimeError(f"replicas {health['replicas']}")
    if after["weight_dtype"] != "int8" or not int8 or wrong:
        raise RuntimeError(f"int8 service holds {int8} int8 matrices and "
                           f"unquantized {wrong}")
    calls = {k: after[k] - before[k] for k in ("image_calls", "text_calls")}
    want = LAYERS * sum(calls.values())
    log(f"tower forwards {calls}, kernel launches {launches}")
    if launches != {"flash_fwd": want}:
        raise RuntimeError(f"launches {launches}, expected {want} flash_fwd")
    if codes != {"escape": 400, "missing": 500}:
        raise RuntimeError(f"status codes {codes}, the JAX server's are "
                           f"400 (escape) and 500 (missing file)")
    p_emb = [_unit_rows("paths", e, len(rel)) for e in paths_emb]
    f_emb = [_unit_rows("frames", e, len(rel)) for e in frames_emb]
    err = max(np.abs(a - b).max() for a in p_emb for b in f_emb)
    err_window = np.abs(_unit_rows("window paths", win_paths, 4)
                        - _unit_rows("window frames", win_frames, 4)).max()
    log(f"paths against frames_b64 of the host decode: max abs {err:.2e}, "
        f"with start/end {err_window:.2e} (bound {ST_TOL})")
    if max(err, err_window) > ST_TOL:
        raise RuntimeError("paths and frames_b64 disagree")

    model = create_model(MODEL, num_frames=FRAMES, dtype=torch.float32)
    load_clip_checkpoint(model, exported)
    with torch.inference_mode():
        ref_v = model.encode_image(normalize_video(
            torch.from_numpy(host[:2]), dtype=torch.float32)).numpy()
        ref_t = model.encode_text(
            torch.from_numpy(tokenize(texts)).long()).numpy()
    cos_v = (ref_v * p_emb[0][:2]).sum(-1)
    cos_t = (ref_t * _unit_rows("text", text_emb, 2)).sum(-1)
    log(f"int8 against the CPU f32 plain path: cosine video {cos_v}, "
        f"text {cos_t} (bound 0.98)")
    if min(cos_v.min(), cos_t.min()) < 0.98:
        raise RuntimeError("int8 embeddings disagree with the CPU reference")
    p50_paths = float(np.median(lat_paths))
    p50_frames = float(np.median(lat_frames))
    int8_bytes = after["replicas"][0]["weight_bytes"]
    log(f"int8 service: {int8} int8 matrices, {int8_bytes} weight bytes on "
        f"the card against bf16's {bf16['weight_bytes']} "
        f"({int8_bytes / bf16['weight_bytes']:.3f}); {len(rel)}-clip "
        f"requests: paths p50 {p50_paths:.1f} ms (host decode included), "
        f"frames_b64 p50 {p50_frames:.1f} ms, phase 4's bf16 frames_b64 p50 "
        f"{bf16['p50_ms']:.1f} ms")
    return {"launches": launches, "p50_paths_ms": p50_paths,
            "p50_frames_ms": p50_frames, "decode_ms": decode_ms,
            "weight_bytes": int8_bytes}


ST_PROFILE_STEPS = 2


def _profile_step_tool(tmp: str) -> dict:
    """(c) ``tools.profile_step.main`` at ``CLIP_VITB16``, 4 frames, batch
    32: 24 ``flash_fwd_lse`` and 24 combined-backward launches a step
    (the wrappers' counts over 3 warm-up and 2 traced steps, exactly), its
    rows 24 ``flash_fwd_kernel`` (forward) and 24 ``bwd_kv_kernel``
    (backward) a step in both towers, and device time above 0 and below
    the wall.  A trace may lose kernel records (1 of 5320 in one of three
    traces of a fresh process on the card; late in this script, the first
    kernels of one visual forward, PERF.md §6), and a row counts its
    kernels a step rounded down, so a row may read one short of the
    launches."""
    from avion_tpu_torch.tools import profile_step

    fa.reset_launches()
    out = profile_step.main(["--batch", str(ST_PROFILE_BATCH), "--steps",
                             str(ST_PROFILE_STEPS), "--model", MODEL,
                             "--frames", str(FRAMES), "--top", "1000",
                             "--device", ST_DEVICE,
                             "--out", os.path.join(tmp, "steptrace")])
    launches = dict(fa.launches)
    flash: dict = {}
    for _, n, kind, region, phase in out["rows"]:
        if kind in ("flash_fwd_kernel", "bwd_kv_kernel", "bwd_dq_kernel"):
            flash[(kind, region, phase)] = n
    log(f"(c) profile_step: device {out['total_ms']:.3f} ms of "
        f"{out['wall_ms']:.3f} ms wall a step; flash kernels a step {flash}; "
        f"launches over {3 + ST_PROFILE_STEPS} steps {launches}")
    if ST_DEVICE != "cuda":
        return {"launches": launches, "rows": out["rows"][:10]}
    steps = 3 + ST_PROFILE_STEPS
    if launches != {"flash_fwd_lse": 2 * LAYERS * steps,
                    "flash_bwd_combined": 2 * LAYERS * steps}:
        raise RuntimeError(f"profile_step launched {launches}")
    want = {("flash_fwd_kernel", "vision", "fwd"), ("flash_fwd_kernel",
            "text", "fwd"), ("bwd_kv_kernel", "vision", "bwd"),
            ("bwd_kv_kernel", "text", "bwd")}
    counts = [sum(n for k, n in flash.items() if k[0] == kind)
              for kind in ("flash_fwd_kernel", "bwd_kv_kernel")]
    if set(flash) != want or not all(2 * LAYERS - 1 <= n <= 2 * LAYERS
                                     for n in counts) or not \
            0 < out["total_ms"] < out["wall_ms"]:
        raise RuntimeError(f"profile_step rows {flash}, expected {want} at "
                           f"{2 * LAYERS} a step; device {out['total_ms']} "
                           f"ms of {out['wall_ms']} ms")
    return {"launches": launches, "rows": out["rows"][:10]}


def phase_serve_tools(tmp: str, fixture: tuple, bf16: dict) -> dict:
    """Serving completed and the model tools: (a) the checkpoint
    converter both ways, (b) ``paths`` under ``--media-root`` with
    ``--weights int8`` over ``--mesh``, (c) ``tools.profile_step``.
    Returns the launches by path."""
    log("== serve completed, tools")
    t_phase = time.perf_counter()
    exported = _export_import(tmp)
    served = _serve_paths_int8(tmp, fixture[0], exported, bf16)
    prof = _profile_step_tool(tmp)
    log("serve-tools summary " + json.dumps(
        {k: v for k, v in served.items() if k != "launches"}, default=float))
    log(f"serve-tools phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"paths": {"serve_paths_int8": served["launches"],
                      "profile_step": prof["launches"]}}


# the convergence drill: the e2e tool's clip family at its default model
# (CLIP_VITB16_H128: 6 visual and 4 text heads of 128), 4 frames, 224 px,
# cut to 8 classes x 16 windows (4 steps an epoch at batch 32) over 3
# epochs, SIGTERM once step 6 is logged (the steps are bound by the host's
# decode, about 1.2 s each on an 8-core host); a checkpoint at the
# preemption and at the end only (each is 1.8 GB, and the script writes
# about 40 GB in all)
DRILL_ARGS = ["--family", "clip", "--classes", "8", "--windows", "16",
              "--batch", "32", "--epochs", "3", "--preempt-step", "6",
              "--workers", str(min(8, os.cpu_count() or 1)),
              "--extra", "save_freq=3"]
DRILL_DEVICE = "cuda"
DRILL_TIMEOUT_S = 600
DRILL_COUNTS = "launches"  # the summary's counters the checks read


def phase_drill(tmp: str) -> dict:
    """16. ``python -m avion_tpu_torch.tools.e2e_convergence`` as a child
    process: the drill writes its seeded mp4v classes, trains
    ``pretrain_clip`` in a child of its own, preempts it, relaunches it to
    the end and scores the restored checkpoint against the run's fresh
    init on the held-out windows.  It must show a preemption with a resume
    step above 0, a last logged loss below the first, the restored model's
    zero-shot top-1 above the init's, and the training kernels' and the
    inference kernel's launches in the children (their counter files)."""
    log("== drill")
    t0 = time.perf_counter()
    out = os.path.join(tmp, "drill")
    cmd = [sys.executable, "-m", "avion_tpu_torch.tools.e2e_convergence",
           *DRILL_ARGS, "--out", out, "--device", DRILL_DEVICE,
           "--timeout", str(DRILL_TIMEOUT_S), "--stall-timeout", "300"]
    res = subprocess.run(cmd, capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         timeout=2 * DRILL_TIMEOUT_S + 300)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        tail = ""
        log_path = os.path.join(out, "train_stdout.log")
        if os.path.exists(log_path):
            with open(log_path) as f:
                tail = f.read()[-4000:]
        raise RuntimeError(f"drill: rc {res.returncode}\n"
                           f"{res.stderr[-4000:]}\n{tail}")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    train, evals = (summary[DRILL_COUNTS][k] for k in ("train", "eval"))
    log(f"drill ({card_line()}): {summary['steps_logged']} steps logged to "
        f"step {summary['ckpt_step']}, preempted and resumed at step "
        f"{summary['resume_step']}; loss {summary['first_loss']:.4f} -> "
        f"{summary['final_loss']:.4f}; zero-shot top-1 "
        f"{summary['zeroshot_top1']} (top-5 {summary['zeroshot_top5']}) "
        f"against the fresh init's {summary['init_zeroshot_top1']} "
        f"({summary['init_zeroshot_top5']}) over "
        f"{summary['heldout_clips']} held-out clips; "
        f"{summary['samples_per_s']:.3f} clips/s over both launches "
        f"({summary['train_s']:.1f} s, start-ups included); launches: "
        f"training {train}, eval {evals}; the tool's wall "
        f"{summary['wall_s']:.1f} s, the phase's {wall:.1f} s")
    bad = []
    if not summary["resume_step"] > 0:
        bad.append(f"resume step {summary['resume_step']}")
    if not summary["final_loss"] < summary["first_loss"]:
        bad.append(f"loss {summary['first_loss']} -> {summary['final_loss']}")
    if not summary["zeroshot_top1"] > summary["init_zeroshot_top1"]:
        bad.append(f"top-1 {summary['zeroshot_top1']} against the init's "
                   f"{summary['init_zeroshot_top1']}")
    for name, counts in (("flash_fwd_lse", train),
                         ("flash_bwd_combined", train), ("flash_fwd", evals)):
        if not counts.get(name, 0) > 0:
            bad.append(f"no {name} launch")
    if bad:
        raise RuntimeError("drill: " + "; ".join(bad))
    return {"paths": {"drill_train": train, "drill_eval": evals},
            "summary": summary}


# the tensor-parallel blocks: (tower, B, S, H, D, causal) at the widths of
# ViT-B/16 (4 and 16 frames), its text tower and the H128 split, each at
# the tensor sizes that divide its heads
TP_BLOCKS = [("ViT-B/16 visual", 32, 785, 12, 64, False),
             ("ViT-B/16 visual, 16 frames", 8, 3137, 12, 64, False),
             ("text", 32, 77, 8, 64, True),
             ("H128 visual", 32, 785, 6, 128, False)]
TP_SIZES = (2, 4)
TP_CHECK_BATCH = 4  # the shard kernels against their plain f32 versions


def _scaled_errors(got: torch.Tensor, ref: torch.Tensor):
    """(max abs error over the reference's max abs value, RMS error over
    its RMS): phase 3 holds tensors of unit scale to 3e-2; a block's bf16
    output (one ulp is 3e-2 at 4) and its weights' gradients (sums over
    B x S rows) are not of unit scale."""
    diff = got.float() - ref.float()
    return ((diff.abs().max() / ref.float().abs().max()).item(),
            (diff.norm() / ref.float().norm()).item())


def _tp_block_check(gen, tower, b, s, h, d, causal, check) -> list:
    """One block, whole and with each of TP_SIZES's tensor ranks played on
    the card (``run_block_local``): output and the gradients of x and of
    every weight against the whole block's; the block's and the shard
    attention's times.  Returns the rows."""
    from avion_tpu_torch.models.layers import Block
    from avion_tpu_torch.parallel.tensor_parallel import run_block_local

    block = Block(h * d, h, causal=causal).cuda()
    with torch.no_grad():
        for p in block.parameters():
            if p.dim() > 1:
                p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn(b, s, h * d, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    g = torch.randn(b, s, h * d, generator=gen, device="cuda")

    def run(fn):
        block.zero_grad(set_to_none=True)
        xi = x.detach().requires_grad_()
        out = fn(xi)
        (out.float() * g).sum().backward()
        return out.detach(), xi.grad, {n: p.grad for n, p in
                                       block.named_parameters()}

    def attn_ms(heads):
        qkv = torch.randn(b, s, 3 * heads * d, generator=gen, device="cuda",
                          dtype=torch.bfloat16, requires_grad=True)
        do = torch.randn(b, s, heads * d, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        return cuda_ms(lambda: fa.flash_attention_fused_qkv(
            qkv, heads, s, causal=causal).backward(do), iters=10)

    whole = run(block)
    whole_ms = cuda_ms(lambda: run(block), iters=5)
    attn_whole = attn_ms(h)
    rows = []
    for t in TP_SIZES:
        if h % t:
            continue
        fa.reset_launches()
        split = run(lambda xi: run_block_local(block, xi, t))
        launches = dict(fa.launches)
        name = f"{tower} t={t}"
        errs = {"out": (_scaled_errors(split[0], whole[0]), REL_TOL),
                "dx": (_scaled_errors(split[1], whole[1]), BWD_REL_TOL),
                **{n: (_scaled_errors(split[2][n], whole[2][n]),
                       BWD_REL_TOL) for n in whole[2]}}
        for key, ((err, rel), rel_tol) in errs.items():
            check(name, key, scaled_max_abs_err=(err, TOL),
                  rel_rms_err=(rel, rel_tol))
        want = t if s <= 1024 else 0
        if launches.get("flash_fwd_lse") != t or launches.get(
                "flash_bwd_combined", 0) != want:
            raise RuntimeError(f"{name}: launches {launches}")
        row = {"tower": tower, "shape": [b, s, h, d], "causal": causal,
               "tensor": t, "launches": launches,
               "max_abs_err": max(e[0][0] for e in errs.values()),
               "raw_max_abs_err": max(
                   (split[i] - whole[i]).abs().max().item() for i in (0, 1)),
               "out_rel_rms_err": errs["out"][0][1],
               "grad_rel_rms_err": max(e[0][1] for k, e in errs.items()
                                       if k != "out"),
               "block_ms": cuda_ms(lambda: run(
                   lambda xi: run_block_local(block, xi, t)), iters=5),
               "whole_block_ms": whole_ms,
               "shard_attn_ms": attn_ms(h // t),
               "whole_attn_ms": attn_whole}
        rows.append(row)
        log(f"tensor shards ({card_line()}) " + json.dumps(row))
    del block, x, g, whole
    torch.cuda.empty_cache()
    return rows


def phase_tensor() -> dict:
    """17. The tensor axis on one card: (a) the attention kernels at each
    shard's H / t heads against their plain versions, with their times;
    (b) the blocks of TP_BLOCKS with their tensor ranks played on the card
    (``parallel.tensor_parallel.run_block_local``) against the whole
    block.  (``pretrain_clip.main`` with ``mesh.tensor=1`` under a
    one-rank NCCL group is phase 12 (d).)  Returns the kernel rows and
    the block rows."""
    log("== tensor")
    t_phase = time.perf_counter()
    shards = sorted({(f"{tower} / {t}", s, h // t, d, causal)
                     for tower, _, s, h, d, causal in TP_BLOCKS
                     for t in TP_SIZES if h % t == 0},
                    key=lambda r: (r[1], r[2], r[3]))
    kernel_rows = {}
    for shape in shards:
        batch = next(b for tower, b, s, *_ in TP_BLOCKS if s == shape[1])
        got = _slice_kernel_rows([shape], TP_CHECK_BATCH, batch, seed=17,
                                 what="the tensor shards")
        for name, rs in got.items():
            kernel_rows.setdefault(name, []).extend(rs)
    gen = torch.Generator(device="cuda").manual_seed(17)
    bad = []

    def check(name, what, **errs):
        for key, (err, limit) in errs.items():
            if not err <= limit:  # NaN fails too
                bad.append(f"{name} {what}: {key} {err} > {limit}")

    blocks = []
    for spec in TP_BLOCKS:
        blocks += _tp_block_check(gen, *spec, check)
    if bad:
        raise RuntimeError("tensor shards: " + "; ".join(bad))
    log(f"tensor phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"rows": kernel_rows, "blocks": blocks}


# phase 18: the mixture-of-experts tower and the pipelines
XP_EXPERTS, XP_BATCH, XP_STEPS = 8, 32, 2
XP_EP = (2, 4)  # the expert ranks played on the card
XP_PP = (2, 4)  # the tower's stages played
XP_MICRO = 8  # pipeline_microbatches' default
# CLIP_VITB16's visual tower at 4 frames: (32, 785, 768), 12 heads
XP_TOWER = dict(batch=32, tokens=785, width=768, heads=12, layers=LAYERS)
XP_NR_PP, XP_NR_BATCH = (2, 3), 16  # VCLM_VITB16's 6 groups
XP_NR = dict(width=512, layers=12, heads=8, cross_every=2)
# LaViLa's gated GPT-2 XL at its widths; depth cut from 48 to 6 (two groups
# of cross_freq 3, the released weights are not in the repository)
XP_GPT2 = dict(width=1600, layers=6, heads=25, cross_every=3)
XP_GPT2_BATCH, XP_GPT2_MICRO, XP_GPT2_TOKENS = 8, 4, 256
XP_DEVICE = "cuda"
H100_F32_FLOPS = 67e12  # outside the tensor cores, H100 SXM data sheet


def _played_check(name: str, run_played, run_whole, params, inputs: list,
                  check, out_tol=REL_TOL) -> dict:
    """One played run against the whole one on the same weights: output
    and the gradients of the inputs and of every parameter (scaled errors,
    phase 17's bounds), the played run's launches."""
    def run(fn):
        for p in params:
            p.grad = None
        xs = [x.detach().requires_grad_() for x in inputs]
        out = fn(*xs)
        g = torch.randn(out.shape, generator=torch.Generator(
            device=out.device).manual_seed(18), device=out.device)
        (out.float() * g).sum().backward()
        return (out.detach(), [x.grad for x in xs],
                [p.grad.detach().clone() for p in params])

    whole = run(run_whole)
    fa.reset_launches()
    played = run(run_played)
    launches = dict(fa.launches)
    errs = {"out": (_scaled_errors(played[0], whole[0]), out_tol)}
    errs.update({f"d_in{i}": (_scaled_errors(a, b), BWD_REL_TOL)
                 for i, (a, b) in enumerate(zip(played[1], whole[1]))})
    # each matrix alone; the vectors and scalars (biases, LayerNorms, the
    # gates: sums over B x S rows in bf16) as one
    mats = [(a, b) for a, b in zip(played[2], whole[2]) if a.dim() > 1]
    vecs = [(a.reshape(-1), b.reshape(-1))
            for a, b in zip(played[2], whole[2]) if a.dim() <= 1]
    if vecs:
        mats.append((torch.cat([a for a, _ in vecs]),
                     torch.cat([b for _, b in vecs])))
    grad = max((_scaled_errors(a, b) for a, b in mats), key=lambda e: e[1])
    errs["params"] = (grad, BWD_REL_TOL)
    for key, ((err, rel), rel_tol) in errs.items():
        check(name, key, scaled_max_abs_err=(err, TOL),
              rel_rms_err=(rel, rel_tol))
    row = {"what": name, "launches": launches,
           "max_abs_err": max(e[0][0] for e in errs.values()),
           "out_rel_rms_err": errs["out"][0][1],
           "grad_rel_rms_err": max(e[0][1] for k, e in errs.items()
                                   if k != "out")}
    log(f"played ({card_line()}) " + json.dumps(row))
    return row


def _moe_layer_times(gen) -> dict:
    """The MoE layer of (a)'s visual block, forward, by part (ms, CUDA
    events) beside its bound: the router and the masks, the dispatch and
    combine products (f32), the two expert products (bf16)."""
    from avion_tpu_torch.models.layers import quick_gelu
    from avion_tpu_torch.ops.moe import MoEMlp

    w, e, tokens = XP_TOWER["width"], XP_EXPERTS, XP_TOWER["tokens"]
    moe = MoEMlp(w, experts=e, act=quick_gelu).to(XP_DEVICE)
    moe.init_weights(torch.Generator(device=XP_DEVICE).manual_seed(18))
    x = torch.randn(XP_BATCH, tokens, w, generator=gen, device=XP_DEVICE,
                    dtype=torch.bfloat16)
    with torch.no_grad():
        xs, dispatch, combine, places, *_ = moe.route(x)
        expert_in = torch.einsum("ngw,ngec->encw", xs.float(),
                                 dispatch).to(moe.dtype)
        out = moe.experts_forward(expert_in)
        n, g, _, c = dispatch.shape
        t, hid = n * g, moe.expert_fc1.shape[-1]
        parts = {
            "router_and_masks": (lambda: moe.route(x), 2 * t * w * e,
                                 x.numel() * 2 + 2 * dispatch.numel() * 4,
                                 H100_F32_FLOPS),
            "dispatch": (lambda: torch.einsum(
                "ngw,ngec->encw", xs.float(), dispatch).to(moe.dtype),
                2 * t * w * e * c, t * w * 4 + dispatch.numel() * 4
                + expert_in.numel() * 2, H100_F32_FLOPS),
            "experts": (lambda: moe.experts_forward(expert_in),
                        4 * e * n * c * w * hid, expert_in.numel() * 2
                        + 2 * e * w * hid * 4 + out.numel() * 2,
                        H100_BF16_FLOPS),
            "combine": (lambda: moe.combine(out, combine, places, x.shape),
                        2 * t * w * e * c, out.numel() * 2
                        + combine.numel() * 4 + x.numel() * 4,
                        H100_F32_FLOPS)}
        times = {}
        for name, (fn, flops, nbytes, peak) in parts.items():
            t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
            times[name] = {"ms": cuda_ms(fn, iters=10),
                           "bound_ms": max(t_ops, t_bytes) * 1e3,
                           "bound_by": ("operations" if t_ops > t_bytes
                                        else "bytes")}
    log(f"MoE layer parts at ({XP_BATCH} x {tokens} tokens, W {w}, E {e}, "
        f"groups {n} x {g}, capacity {c}) ({card_line()}) "
        + json.dumps(times))
    del moe, x, xs, dispatch, combine, expert_in, out
    torch.cuda.empty_cache()
    return times


def _xp_moe_main(tmp: str, fixture: tuple) -> dict:
    """(a) ``pretrain_clip.main`` with ``model.moe_experts`` at CLIP_VITB16,
    batch XP_BATCH, XP_STEPS steps on the data phase's layout, under a
    one-rank NCCL group; its checkpoint is not written (about 10 GB of
    parameters and AdamW state at 8 experts)."""
    from avion_tpu_torch.core.checkpoint import Checkpointer
    from avion_tpu_torch.train import pretrain_clip

    root, meta = fixture
    out = os.path.join(tmp, "moe")
    args = _data_args(out, root, meta, True,
                      f"data.batch_size={XP_BATCH}",
                      "data.subsample_stride="
                      f"{DATA_ROWS // (XP_BATCH * XP_STEPS)}",
                      "eval_freq=0", f"model.moe_experts={XP_EXPERTS}",
                      "mesh.data=1")
    group_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    save = Checkpointer.save
    os.environ.update(group_env)
    Checkpointer.save = lambda self, step, state, extra=None: None
    try:
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        res = pretrain_clip.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Checkpointer.save = save
        for k in group_env:
            os.environ.pop(k, None)
    launches = dict(fa.launches)
    logs = [r for r in _train_log(out) if "train/loss" in r]
    want = {"flash_fwd_lse": XP_STEPS * 2 * LAYERS,
            "flash_bwd_combined": XP_STEPS * 2 * LAYERS}
    keys = ("loss", "moe_aux", "moe_overflow", "moe_load_max",
            "moe_load_min")
    per_step = [{k: r[k if k == "train/loss" else f"train/{k}"]
                 for k in ("train/loss", *keys[1:])} for r in logs]
    log(f"(a) MoE pretrain_clip.main ({card_line()}): {res['steps']} steps "
        f"at batch {XP_BATCH}, {XP_EXPERTS} experts, launches {launches}, "
        f"per step {per_step}, step ms "
        f"{[round(r.get('perf/step_time_win', 0) * 1e3, 3) for r in logs]}, "
        f"wall {wall:.2f} s")
    ok = (res["steps"] == XP_STEPS and launches == want and all(
        np.isfinite(list(s.values())).all() and s["moe_load_max"] <= 1.0
        for s in per_step))
    if not ok:
        raise RuntimeError(f"(a) MoE main: {res['steps']} steps, launches "
                           f"{launches} (want {want}), {per_step}")
    return {"launches": launches, "per_step": per_step, "wall_s": wall}


def phase_experts_pipeline(tmp: str, fixture: tuple) -> dict:
    """18. (a) :func:`_xp_moe_main`; the MoE layer's parts timed beside
    their bounds; (b) ``ops.moe.run_experts_local`` at ep = 2, 4 against
    the whole MoEMlp (W 768, 8 experts, XP_BATCH x 785 tokens, bf16):
    output and the gradients of x, the router and the experts; (c)
    CLIP_VITB16's pipelined tower (12 blocks, M = XP_MICRO microbatches)
    with its pp = 2, 4 stages played (``parallel.pipeline.
    run_stages_local``), with and without remat, against the same blocks
    in sequence: output and gradients, launches (12 x M each kernel);
    (d) VCLM_VITB16's pipelined decoder (6 groups) at pp = 2, 3 with its
    visual tokens' gradient, pp = 4 refused; (e) LaViLa's gated GPT-2 at
    XL width, 6 layers, pp = 2 (its causal self-attention on the flash
    forward with lse and the combined backward, 6 x M each)."""
    from avion_tpu_torch.models.layers import quick_gelu
    from avion_tpu_torch.ops.moe import MoEMlp, run_experts_local
    from avion_tpu_torch.parallel.pipeline import (PipelinedTransformer,
                                                   run_stages_local)
    from avion_tpu_torch.parallel.pipeline_gated import (
        PipelinedGatedDecoder)

    log("== experts and pipeline")
    t_phase = time.perf_counter()
    paths = {}
    moe_main = _xp_moe_main(tmp, fixture)
    paths["moe_pretrain_main"] = moe_main["launches"]
    log(f"(a) wall {time.perf_counter() - t_phase:.1f} s")
    gen = torch.Generator(device=XP_DEVICE).manual_seed(18)
    bad, played = [], []

    def check(name, what, **errs):
        for key, (err, limit) in errs.items():
            if not err <= limit:  # NaN fails too
                bad.append(f"{name} {what}: {key} {err} > {limit}")

    parts = _moe_layer_times(gen)

    def randomize(module, std=0.02):
        with torch.no_grad():
            for p in module.parameters():
                if p.dim() > 1:
                    p.normal_(0.0, std, generator=gen)
        return module

    # (b) the expert ranks played
    tw = XP_TOWER
    moe = MoEMlp(tw["width"], experts=XP_EXPERTS, act=quick_gelu).to(
        XP_DEVICE)
    moe.init_weights(torch.Generator(device=XP_DEVICE).manual_seed(19))
    x = torch.randn(XP_BATCH, tw["tokens"], tw["width"], generator=gen,
                    device=XP_DEVICE, dtype=torch.bfloat16)
    for ep in XP_EP:
        played.append(_played_check(
            f"(b) MoE ep={ep}", lambda xi: run_experts_local(moe, xi, ep),
            moe, list(moe.parameters()), [x], check))
    del moe, x
    # (c) the pipelined tower's stages played
    tower = randomize(PipelinedTransformer(
        tw["width"], tw["layers"], tw["heads"], act=quick_gelu,
        num_microbatches=XP_MICRO).to(XP_DEVICE))
    x = torch.randn(tw["batch"], tw["tokens"], tw["width"], generator=gen,
                    device=XP_DEVICE, dtype=torch.bfloat16)
    for remat in (False, True):
        tower.remat = remat
        for pp in XP_PP:
            name = f"(c) tower pp={pp}" + (" remat" if remat else "")
            row = _played_check(
                name, lambda xi: run_stages_local(tower, xi, pp),
                lambda xi: tower.run_units(tower.units(), xi),
                list(tower.parameters()), [x], check)
            want = {"flash_fwd_lse": tw["layers"] * XP_MICRO,
                    "flash_bwd_combined": tw["layers"] * XP_MICRO}
            if row["launches"] != want:
                bad.append(f"{name}: launches {row['launches']}")
            paths[f"pipeline_tower_pp{pp}" + ("_remat" if remat else "")] \
                = row["launches"]
            played.append(row)
    del tower, x
    # (d) the VCLM decoder's stages played, the visual tokens' gradient
    decoder = randomize(PipelinedGatedDecoder(
        **XP_NR, cross_position="mid", num_microbatches=XP_MICRO).to(
            XP_DEVICE))
    _open_gates(decoder)
    nw = XP_NR["width"]
    x = torch.randn(XP_NR_BATCH, 77, nw, generator=gen, device=XP_DEVICE,
                    dtype=torch.bfloat16)
    enc = torch.randn(XP_NR_BATCH, tw["tokens"], nw, generator=gen,
                      device=XP_DEVICE, dtype=torch.bfloat16)
    for pp in XP_NR_PP:
        name = f"(d) VCLM decoder pp={pp}"
        row = _played_check(
            name, lambda xi, ei: run_stages_local(decoder, xi, pp, ei),
            lambda xi, ei: decoder.run_units(decoder.units(), xi, ei),
            list(decoder.parameters()), [x, enc], check)
        want = {"flash_fwd_lse": XP_NR["layers"] * XP_MICRO,
                "flash_bwd_combined": XP_NR["layers"] * XP_MICRO}
        if row["launches"] != want:
            bad.append(f"{name}: launches {row['launches']}")
        paths[f"pipeline_vclm_pp{pp}"] = row["launches"]
        played.append(row)
    try:
        run_stages_local(decoder, x, 4, enc)
        bad.append("(d) pp=4 over 6 groups did not raise")
    except ValueError as err:
        log(f"(d) pp=4 refused: {err}")
    del decoder, x, enc
    # (e) LaViLa's GPT-2 at XL width
    gpt2 = randomize(PipelinedGatedDecoder(
        **XP_GPT2, cross_position="pre", num_microbatches=XP_GPT2_MICRO)
        .to(XP_DEVICE))
    _open_gates(gpt2)
    w = XP_GPT2["width"]
    x = torch.randn(XP_GPT2_BATCH, 77, w, generator=gen, device=XP_DEVICE,
                    dtype=torch.bfloat16)
    enc = torch.randn(XP_GPT2_BATCH, XP_GPT2_TOKENS, w, generator=gen,
                      device=XP_DEVICE, dtype=torch.bfloat16)
    row = _played_check(
        "(e) GPT-2 XL width, 6 layers, pp=2",
        lambda xi, ei: run_stages_local(gpt2, xi, 2, ei),
        lambda xi, ei: gpt2.run_units(gpt2.units(), xi, ei),
        list(gpt2.parameters()), [x, enc], check)
    want = {"flash_fwd_lse": XP_GPT2["layers"] * XP_GPT2_MICRO,
            "flash_bwd_combined": XP_GPT2["layers"] * XP_GPT2_MICRO}
    if row["launches"] != want:
        bad.append(f"(e) GPT-2 launches {row['launches']}, expected {want}")
    played.append(row)
    del gpt2, x, enc
    torch.cuda.empty_cache()
    if bad:
        raise RuntimeError("experts and pipeline: " + "; ".join(bad))
    log(f"experts and pipeline phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"paths": paths, "moe_main": moe_main, "moe_parts": parts,
            "played": played}


# phase 19: each tool's main at a small size, the kernels its path launches
# and the keys of the JAX tool's JSON line (avion_tpu/tools/<tool>.py)
_TRAIN = {"flash_fwd_lse", "flash_bwd_combined"}
_SPLIT = _TRAIN | {"flash_bwd_dq", "flash_bwd_dkv"}
TOOL_RUNS = {
    "bench_attention": (["--iters", "5"], _SPLIT,
                        {"metric", "split_ms", "combined_ms", "speedup"}),
    "mxu_roofline": (["--iters", "3"], _TRAIN | {"flash_fwd"},
                     {"metric", "shape", "12x64", "6x128",
                      "fwd_12x64_over_6x128", "fwdbwd_12x64_over_6x128"}),
    # ViT-L/14's 1025 visual tokens take the split backward
    "bench_vitl": (["16"], _SPLIT,
                   {"metric", "value", "unit", "mfu", "step_ms"}),
    # the decoder's 1568 tokens take the split backward
    "bench_videomae": (["32"], _SPLIT,
                       {"metric", "value", "unit", "vs_baseline"}),
    # 4 videos give 32 clips: batch 32
    "bench_pipeline": (["--steps", "4", "--videos", "4", "--batch", "32"],
                       _TRAIN, {"metric", "input_path", "value", "unit",
                                "duty_cycle", "data_time_s", "step_time_s",
                                "decode_clips_per_sec_per_core",
                                "host_cores", "live_batch",
                                "projected_duty_cycle_at_cores", "loss"}),
    "bench_serve": (["--texts", "64", "--videos", "16"], {"flash_fwd"},
                    {"metric", "text_embeds_per_sec",
                     "video_embeds_per_sec", "unit", "text_mean_batch",
                     "video_mean_batch", "text_p95_ms", "video_p95_ms",
                     "device"}),
    "bench_narrator": (["--batch", "4", "--max-len", "16"], set(),
                       {"metric", "value", "unit", "tokens_per_sec",
                        "batch_s", "samples_per_clip", "kv_cache"}),
    "headdim_ablation": (["--steps", "20", "--batch", "16", "--concepts",
                          "8"], _TRAIN | {"flash_fwd"},
                         {"metric", "seed", "arms", "top1_delta_vs_first",
                          "loss_delta_vs_first"}),
}
TOOL_DEVICE = "cuda"
TOOL_COUNTS = "launches"  # the counters the checks read


def phase_tools(tmp: str) -> dict:
    """19. Each tool's ``main`` (``python -m avion_tpu_torch.tools.<tool>
    ...``) at TOOL_RUNS' small size, the counters set to 0 just before it
    and read just after: every kernel of the tool's path launched (none
    for ``bench_narrator``: its attention is plain, as the JAX decoder's),
    and its JSON line carries the JAX tool's keys.  Returns the launches
    by tool and each tool's line."""
    import importlib

    log("== tools")
    t_phase = time.perf_counter()
    paths, lines, bad = {}, {}, []
    for tool, (args, kernels, keys) in TOOL_RUNS.items():
        mod = importlib.import_module(f"avion_tpu_torch.tools.{tool}")
        argv = list(args) + ["--device", TOOL_DEVICE]
        if tool == "bench_pipeline":
            argv += ["--root", os.path.join(tmp, "bench_pipe")]
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        fa.reset_launches()
        out = mod.main(argv)
        torch.cuda.synchronize()
        launched = {k: n for k, n in getattr(fa, TOOL_COUNTS).items() if n}
        wall = time.perf_counter() - t0
        paths[f"tool_{tool}"] = launched
        lines[tool] = out
        missing = kernels - set(launched)
        if missing or (not kernels and launched):
            bad.append(f"{tool}: launched {launched}, want {sorted(kernels)}")
        if not keys <= set(out):
            bad.append(f"{tool}: JSON line lacks {sorted(keys - set(out))}")
        log(f"(19) {tool} {' '.join(argv)} ({card_line()}): launches "
            f"{launched}, wall {wall:.1f} s, {json.dumps(out)}")
        torch.cuda.empty_cache()
    if bad:
        raise RuntimeError("tools: " + "; ".join(bad))
    log(f"tools phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"paths": paths, "lines": lines}


KERNEL_SOURCES = {
    "flash_fwd": ("flash_fwd.cu", 134), "flash_fwd_lse": ("flash_fwd.cu", 91),
    "flash_bwd_combined": ("flash_bwd.cu", 494),
    "flash_bwd_dq": ("flash_bwd.cu", 220), "flash_bwd_dkv": ("flash_bwd.cu", 271),
    # the ring hops: the pallas_calls of `_fwd` and `_bwd` with extra_bias
    "flash_hop_fwd": ("flash_fwd.cu", 194),
    "flash_hop_bwd_dq": ("flash_bwd.cu", 369),
    "flash_hop_bwd_dkv": ("flash_bwd.cu", 388),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    rows = phase_kernel()
    act_rows = phase_activation()
    log(f"phases 1-3 wall {time.perf_counter() - t_start:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t_phase = time.perf_counter()
        serve = phase_serve(tmp)
        log(f"serve phase wall {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        train, echo_p50, train_det = phase_train(tmp)
        long = phase_train_long(tmp)
        log(f"train phases wall {time.perf_counter() - t_phase:.1f} s")
        data = phase_data(tmp, echo_p50)
        evals = phase_eval(tmp, data["fixture"],
                           os.path.join(tmp, "clip_vitb16_random.pt"))
        vmae = phase_videomae(tmp)
        ft = phase_finetune(tmp, os.path.join(tmp, "clip_vitb16_random.pt"))
        cl = phase_contrastive(tmp, data["fixture"])
        par = phase_parallel(tmp, data["fixture"])
        nar = phase_narrator(tmp, data["fixture"])
        nlq = phase_egonlq(tmp, os.path.join(tmp, "clip_vitb16_random.pt"))
        tools = phase_serve_tools(tmp, data["fixture"], serve)
        drill = phase_drill(tmp)
        tensor = phase_tensor()
        xp = phase_experts_pipeline(tmp, data["fixture"])
        tools19 = phase_tools(tmp)
    # each kernel's launches from the path that drives it: serving, the
    # data-fed 4-frame main path (run A), and the data-fed MIR finetune at
    # 16 frames for the split kernels; every path's counts beside them
    mir = ft["paths"]["finetune_mir_data_with_validation"]
    launches = {"flash_fwd": serve["launches"], **data["host_crop"],
                "flash_bwd_dq": mir["flash_bwd_dq"],
                "flash_bwd_dkv": mir["flash_bwd_dkv"], **par["ring"]}
    by_path = {"serve": {"flash_fwd": serve["launches"]},
               "train_seeded_batches": train,
               "train_seeded_deterministic": train_det["launches"],
               "train_16_frames": long, "data_host_crop": data["host_crop"],
               "data_device_crop": data["device_crop"],
               "eval": evals["eval"], "data_with_eval": evals["with_eval"],
               **vmae["paths"], **ft["paths"], **cl["paths"],
               "parallel_ring": par["ring"], "parallel_nccl": par["nccl"],
               **{f"parallel_entry_{name}": counts
                  for name, counts in par["entries"].items()},
               **nar["paths"], **nlq["paths"], **tools["paths"],
               **drill["paths"], **xp["paths"], **tools19["paths"]}
    rows["flash_fwd"] += evals["checks"]
    for name in rows:
        rows[name] += vmae["rows"][name] + ft["rows"][name] + \
            cl["rows"][name] + par["rows"].get(name, []) + \
            nar["rows"][name] + nlq["rows"][name] + \
            tensor["rows"].get(name, [])
    kernels = []
    for name, (source, line) in KERNEL_SOURCES.items():
        head = rows[name][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"avion_tpu_torch/ops/csrc/{source}",
            "replaces": f"avion_tpu/ops/flash_attention.py:{line}",
            "launches": launches[name],
            "launches_by_path": {path: counts[name] for path, counts in
                                 by_path.items() if name in counts},
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "shapes": rows[name]})
    # QuickGELU's pair: its launches from the data-fed 4-frame main path
    # (run A); JAX's XLA fuses the formula, so it replaces no kernel there
    for name, head in act_rows.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "avion_tpu_torch/ops/csrc/quick_gelu.cu",
            "replaces": None, "launches": data["host_crop"][name],
            "launches_by_path": {path: counts[name] for path, counts in
                                 by_path.items() if name in counts},
            "max_abs_err": head["max_abs_err"], "ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "shape": head["shape"], "shapes": [head]})
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
