"""Zero-shot validation over the five suites (``avion_tpu.eval.validate``).

Each suite activates when its dataset paths are configured, by the JAX
package's rules and environment variables:

  EK100 MIR:  data.val_metadata + data.relevancy_path (csv + pkl)
  EK100 CLS:  EK100_ACTIONS_CSV + EK100_VIDEO_DIR (+ EK100_VAL, else
              data.val_metadata)
  EGTEA:      EGTEA_DATA_DIR + EGTEA_META_DIR
  Charades:   CHARADES_DATA_DIR + CHARADES_META_DIR
  EgoMCQ:     EGO4D_MCQ_DATA_DIR + EGO4D_MCQ_META_DIR

Standalone::

    python -m avion_tpu_torch.eval.validate model.name=CLIP_VITB16 \\
        data.clip_length=4 pretrain_model=<ckpt.pt> [--device cpu]

It runs on CUDA unless ``--device cpu`` is given.  The id columns of the
MIR csvs are read with ``csv`` (no pandas).  Each suite closes its
``DataLoader``'s workers when it ends.  A loader with workers starts them
with forkserver, which re-imports ``__main__``: a script that calls these
functions needs an ``if __name__ == "__main__"`` guard.
"""

from __future__ import annotations

import copy
import csv
import json
import os
import os.path as osp
import pickle
import sys
from typing import Dict

import torch

from avion_tpu_torch.data.datasets import (AugmentSpec, VideoCaptionDataset,
                                           VideoCaptionMCQDataset,
                                           VideoClassyDataset)
from avion_tpu_torch.data.loader import DataLoader
from avion_tpu_torch.data.metadata import generate_label_map
from avion_tpu_torch.eval.runners import (CLIPEncoders, build_text_classifier,
                                          validate_all, validate_egomcq,
                                          validate_mir, validate_zeroshot_cls)


def _first_column(path: str) -> list:
    """Column 0 of a csv, header row and blank lines skipped."""
    with open(path, newline="") as f:
        return [row[0] for row in list(csv.reader(f))[1:] if row]


def _run(make_loader, evaluate):
    """``evaluate(loader)`` on a new loader, whose workers stop after."""
    loader = make_loader()
    try:
        return evaluate(loader)
    finally:
        loader.close()


def build_suites(data_cfg, env=None) -> Dict:
    """``{suite name: callable of the encoders returning its metrics}`` for
    every configured suite (the JAX package binds the encoders here; the
    port hands them over at run time, so that a training run copies its
    model only when a suite is configured)."""
    env = env if env is not None else os.environ
    d = data_cfg
    center = AugmentSpec(crop_size=d.crop_size, mode="center")
    suites = {}

    def loader(ds, batch=None):
        return lambda: DataLoader(ds, batch or d.val_batch_size,
                                  shuffle=False, drop_last=False,
                                  num_workers=d.num_workers)

    # --- EK100 MIR retrieval -------------------------------------------------
    if d.val_metadata and d.relevancy_path and osp.exists(d.relevancy_path):
        def mir(encoders):
            ds = VideoCaptionDataset(
                "ek100_mir", d.root_val or d.root, d.val_metadata,
                is_training=False, clip_length=d.clip_length,
                chunk_len=d.chunk_len, augment=center)
            with open(d.relevancy_path, "rb") as f:
                rel = pickle.load(f)
            video_ids = _first_column(d.val_metadata)
            text_ids = _first_column(osp.join(
                osp.dirname(d.val_metadata),
                osp.basename(d.val_metadata).replace("test", "test_sentence")))
            return _run(loader(ds), lambda ld: validate_mir(
                encoders, ld, rel, video_ids, text_ids))

        suites["ek100_mir"] = mir

    # --- EK100 CLS zero-shot -------------------------------------------------
    actions_csv = env.get("EK100_ACTIONS_CSV", "")
    ek_val = env.get("EK100_VAL", d.val_metadata)
    ek_dir = env.get("EK100_VIDEO_DIR", "")
    if actions_csv and ek_val and ek_dir and osp.exists(actions_csv):
        def ek100_cls(encoders):
            from avion_tpu_torch.train.finetune_cls import load_actions

            labels, pairs, mapping = load_actions(actions_csv)
            ds = VideoClassyDataset(
                "ek100_cls", ek_dir, ek_val, is_training=False,
                clip_length=d.clip_length, chunk_len=d.chunk_len,
                label_mapping=mapping, augment=center)
            clf = build_text_classifier(encoders, labels)
            return _run(loader(ds), lambda ld: validate_zeroshot_cls(
                encoders, ld, clf, n_classes=len(labels),
                marginal_actions=pairs))

        suites["ek100_cls"] = ek100_cls

    # --- EGTEA zero-shot -----------------------------------------------------
    egtea_data = env.get("EGTEA_DATA_DIR", "")
    egtea_meta = env.get("EGTEA_META_DIR", "")
    if egtea_data and egtea_meta and osp.isdir(egtea_meta):
        def egtea(encoders):
            ds = VideoClassyDataset(
                "egtea", egtea_data, osp.join(egtea_meta, "test_split1.txt"),
                is_training=False, clip_length=d.clip_length, chunk_len=-1,
                augment=center)
            labels = generate_label_map("egtea", {
                "action_idx": osp.join(egtea_meta, "action_idx.txt")})
            clf = build_text_classifier(encoders, labels)
            return _run(loader(ds), lambda ld: validate_zeroshot_cls(
                encoders, ld, clf, n_classes=len(labels)))

        suites["egtea"] = egtea

    # --- Charades-Ego multi-label --------------------------------------------
    cha_data = env.get("CHARADES_DATA_DIR", "")
    cha_meta = env.get("CHARADES_META_DIR", "")
    if cha_data and cha_meta and osp.isdir(cha_meta):
        def charades(encoders):
            labels = generate_label_map(
                "charades_ego",
                {"classes_txt": osp.join(cha_meta, "Charades_v1_classes.txt")})
            ds = VideoClassyDataset(
                "charades_ego", cha_data,
                osp.join(cha_meta, "CharadesEgo_v1_test_only1st.csv"),
                is_training=False, clip_length=d.clip_length, chunk_len=-1,
                label_mapping={f"c{i:03d}": i for i in range(len(labels))},
                augment=center)
            clf = build_text_classifier(encoders, labels)
            return _run(loader(ds), lambda ld: validate_zeroshot_cls(
                encoders, ld, clf, multilabel=True))

        suites["charades_ego"] = charades

    # --- EgoMCQ --------------------------------------------------------------
    mcq_data = env.get("EGO4D_MCQ_DATA_DIR", "")
    mcq_meta = env.get("EGO4D_MCQ_META_DIR", "")
    if mcq_data and mcq_meta:
        def egomcq(encoders):
            ds = VideoCaptionMCQDataset(
                mcq_data, osp.join(mcq_meta, "egomcq.json"),
                clip_length=d.clip_length, chunk_len=d.chunk_len,
                crop_size=d.crop_size)
            # 5 clips an item: an eighth of the batch in items
            return _run(loader(ds, max(1, d.val_batch_size // 8)),
                        lambda ld: validate_egomcq(encoders, ld))

        suites["egomcq"] = egomcq

    return suites


def run_validation(model: torch.nn.Module, data_cfg, env=None,
                   strict: bool = False, group=None) -> Dict[str, float]:
    """Every configured suite on ``model``, which is left as it is: its
    mode and its (f32 master) weights.  The suites encode with a copy
    whose matrices are cast to bf16 (about 0.3 GB for ViT-B/16); a bf16
    model rounds each weight to bf16 at use, so the copy gives the same
    embeddings as the model's own weights would.  Without a configured
    suite nothing is copied and the result is empty.  Over a batch
    ``group`` each rank encodes its rows (``CLIPEncoders``)."""
    suites = build_suites(data_cfg, env)
    if not suites:
        return {}
    enc = CLIPEncoders(copy.deepcopy(model).requires_grad_(False),
                       batch=data_cfg.val_batch_size, group=group)
    return validate_all(enc, suites, strict=strict)


def main(argv=None) -> Dict[str, float]:
    """Standalone zero-shot evaluation (the reference's ``--evaluate``
    path): every configured suite, strict (a failing suite raises); prints
    and returns the metrics."""
    from avion_tpu_torch.core.config import TrainConfig, load_dotenv
    from avion_tpu_torch.parallel.launch import device_from_argv, host
    from avion_tpu_torch.parallel.mesh import mesh_from_config, use_mesh
    from avion_tpu_torch.train.common import load_pretrained_params
    from avion_tpu_torch.train.pretrain_clip import build_model

    load_dotenv()
    argv, device = device_from_argv(
        argv if argv is not None else sys.argv[1:])
    cfg = TrainConfig().apply_overrides(argv)
    if not cfg.pretrain_model:
        raise SystemExit("pretrain_model=<ckpt.pt|checkpoint dir> is "
                         "required")
    with host(cfg.seed, device) as device:
        mesh = mesh_from_config(cfg.mesh)
        # weights the checkpoint lacks keep their seeded init, as in the
        # JAX entry (strict=False)
        model = build_model(cfg).to_empty(device="cpu")
        model.init_weights(torch.Generator().manual_seed(cfg.seed))
        load_pretrained_params(cfg.pretrain_model, model,
                               num_frames=cfg.data.clip_length,
                               context_length=model.context_length,
                               vocab_size=model.vocab_size)
        enc = CLIPEncoders(model.to(device), batch=cfg.data.val_batch_size,
                           group=mesh.batch_group)
        with use_mesh(mesh):
            results = validate_all(enc, build_suites(cfg.data), strict=True)
    print(json.dumps(results, indent=2, sort_keys=True))
    return results


if __name__ == "__main__":
    main()
