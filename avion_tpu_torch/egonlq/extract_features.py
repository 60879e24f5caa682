"""CLI: extract NLQ features with a pretrained dual encoder
(``avion_tpu.egonlq.extract_features``).

Counterpart of the reference's ``egonlq/extract_features.py`` and the
extraction half of ``egonlq/main.py``.

Usage::

    python -m avion_tpu_torch.egonlq.extract_features \\
        --ckpt runs/pretrain --model CLIP_VITB16 \\
        --annotations nlq_train.json --video-root /data/ego4d_full \\
        --out features/train [--device cpu]

``--ckpt`` is a ``.pt`` / ``.pth`` file or a directory of the port's
checkpoints (``train.common.load_pretrained_params``).  With ``--legacy``
the extractor is the EgoVLP FrozenInTime dual encoder loaded from a
released ``.pth`` (``egonlq.egovlp``), and the queries are tokenized by
the RoBERTa byte-level BPE of ``--tokenizer-dir`` (a local HF-format
directory with ``vocab.json`` and ``merges.txt``).  It runs on CUDA
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> dict:
    """Writes ``feat_<i>.npz`` under ``--out``; returns the extractor's
    ``stats``."""
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--model", default="CLIP_VITB16")
    p.add_argument("--annotations", required=True)
    p.add_argument("--video-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--clip-length", type=int, default=4)
    p.add_argument("--window-sec", type=float, default=2.0)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--device", default="cuda")
    p.add_argument("--legacy", action="store_true",
                   help="EgoVLP FrozenInTime extractor from a released "
                        ".pth checkpoint (--ckpt) instead of the native "
                        "CLIP tower")
    p.add_argument("--tokenizer-dir", default=None,
                   help="local HF-format RoBERTa tokenizer dir "
                        "(vocab.json + merges.txt) for --legacy text")
    args = p.parse_args(argv)
    if args.legacy and not args.tokenizer_dir:
        # fail here, not minutes later after the first video's windowed
        # sweep, when text_features first needs the tokenizer
        p.error("--legacy requires --tokenizer-dir (raw-text queries "
                "need the RoBERTa BPE)")

    from avion_tpu_torch.egonlq.nlq_dataset import parse_nlq_annotations
    from avion_tpu_torch.parallel.launch import resolve_device

    device = resolve_device(args.device)
    samples = parse_nlq_annotations(args.annotations)

    if args.legacy:
        from avion_tpu_torch.data.roberta_tokenizer import \
            load_roberta_tokenizer
        from avion_tpu_torch.egonlq.egovlp import (EgoVLPFeatureExtractor,
                                                   load_egovlp_checkpoint)

        model = load_egovlp_checkpoint(args.ckpt,
                                       num_frames=args.clip_length)
        tokenizer = load_roberta_tokenizer(args.tokenizer_dir)
        fx = EgoVLPFeatureExtractor(
            model.to(device), tokenizer=tokenizer,
            clip_length=args.clip_length, window_sec=args.window_sec,
            crop_size=model.image_size, batch=args.batch)
    else:
        from avion_tpu_torch.egonlq.features import FeatureExtractor
        from avion_tpu_torch.models.registry import create_model
        from avion_tpu_torch.train.common import load_pretrained_params

        with torch.device("meta"):
            model = create_model(args.model, num_frames=args.clip_length)
        # weights the checkpoint lacks keep a seeded init (strict=False)
        model = model.to_empty(device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        load_pretrained_params(args.ckpt, model,
                               num_frames=args.clip_length,
                               context_length=model.context_length,
                               vocab_size=model.vocab_size)
        fx = FeatureExtractor(model.to(device), clip_length=args.clip_length,
                              window_sec=args.window_sec,
                              crop_size=model.image_size, batch=args.batch)
    fx.extract_to_dir(samples, args.video_root, args.out)
    print(f"extracted features for {len(samples)} samples to {args.out}")
    return fx.stats


if __name__ == "__main__":
    main()
