"""Batch inference: CLIP embeddings for videos and / or texts
(``avion_tpu.tools.embed_videos``).

Encodes a directory (or list file) of videos and / or a text file of
captions with a trained dual encoder and writes an ``.npz``: the building
block for retrieval, nearest-neighbour search and feature stages.

Usage::

    python -m avion_tpu_torch.tools.embed_videos \\
        --ckpt model.pt --model CLIP_VITB16 \\
        --videos /data/clips --out embeds.npz \\
        --texts captions.txt --clip-length 4 [--device cpu]

``--ckpt`` is a ``.pt`` / ``.pth`` file or a directory of the port's
checkpoints (``train.common.load_pretrained_params``).  It runs on CUDA
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp
import sys

import numpy as np
import torch


def main(argv=None) -> dict:
    """Writes ``--out`` and returns what it holds."""
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--model", default="CLIP_VITB16")
    p.add_argument("--videos", default="")
    p.add_argument("--texts", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--clip-length", type=int, default=4)
    p.add_argument("--crop-size", type=int, default=224)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from avion_tpu_torch.data.sampling import get_frame_ids
    from avion_tpu_torch.data.tokenizer import tokenize
    from avion_tpu_torch.data.transforms import center_crop_spec
    from avion_tpu_torch.data.video_reader import DecodeError, VideoReader
    from avion_tpu_torch.eval.runners import CLIPEncoders
    from avion_tpu_torch.models.registry import create_model
    from avion_tpu_torch.parallel.launch import resolve_device
    from avion_tpu_torch.train.common import load_pretrained_params

    device = resolve_device(args.device)
    with torch.device("meta"):
        model = create_model(args.model, num_frames=args.clip_length)
    # weights the checkpoint lacks keep a seeded init (strict=False)
    model = model.to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    load_pretrained_params(args.ckpt, model, num_frames=args.clip_length,
                           context_length=model.context_length,
                           vocab_size=model.vocab_size)
    enc = CLIPEncoders(model.to(device), batch=args.batch)

    out = {}
    if args.videos:
        paths = (sorted(glob.glob(osp.join(args.videos, "*.mp4")))
                 if osp.isdir(args.videos)
                 else [l.strip() for l in open(args.videos) if l.strip()])
        clips, names = [], []
        for path in paths:
            try:
                vr = VideoReader(path)
                ids = get_frame_ids(0, len(vr), args.clip_length, jitter=False)
                crop = center_crop_spec(vr.width, vr.height)
                clips.append(vr.get_batch(ids, crop,
                                          (args.crop_size, args.crop_size)))
                names.append(osp.basename(path))
            except DecodeError as e:
                print(f"skip {path}: {e}", file=sys.stderr)
        if clips:
            out["video_embeds"] = enc.encode_images(np.stack(clips))
            out["video_names"] = np.array(names)
    if args.texts:
        lines = [l.strip() for l in open(args.texts) if l.strip()]
        out["text_embeds"] = enc.encode_texts(tokenize(lines))
        out["texts"] = np.array(lines)
    np.savez(args.out, **out)
    print(f"wrote {args.out}: " + ", ".join(
        f"{k}={v.shape}" for k, v in out.items()))
    return out


if __name__ == "__main__":
    main()
