"""Run the training entries on N cards (or N gloo processes) and hold each
against one process on the same global batch: ``finetune_mir``,
``finetune_cls``, ``videomae_pretrain`` and ``videomae_finetune`` at
ViT-B/16, 16 frames, ``pretrain_clip`` at ViT-B/16, 4 frames, and
``train_narrator`` (VCLM_VITB16, 4 frames), each at global batch 8 for 2
steps, on synthetic Ego4D, EK100 and Kinetics layouts and random
checkpoints (``chip_smoke``'s writers), over any mesh (``mesh.data``,
``mesh.fsdp``, ``mesh.pp``, ``mesh.sp``, ``mesh.ep``, ``mesh.tensor``).

    python scripts/torch_entries_over_ranks.py prepare DIR [ENTRY ...]
    torchrun --nproc_per_node=4 scripts/torch_entries_over_ranks.py \\
        run DIR ENTRY mesh.data=2 mesh.fsdp=2        # each ENTRY and mesh
    python scripts/torch_entries_over_ranks.py run DIR ENTRY   # reference
    python scripts/torch_entries_over_ranks.py compare DIR

``model.*`` arguments of a run pick its model, and the mesh run is held
against the one-process run with the same ones: e.g. ``pretrain_clip
mesh.data=2 mesh.ep=2 model.moe_experts=8`` against ``pretrain_clip
model.moe_experts=8``, ``pretrain_clip mesh.data=2 mesh.pp=2
model.pipeline=true model.pipeline_microbatches=2`` and
``train_narrator`` with the same pipeline arguments against theirs.

Every item draws its augmentation from seed 0 and mixup, DropPath and
patch dropout are off, so both runs see the same global rows (the mesh
run in another order, which none of the losses sees).  ``compare`` prints
one JSON line: each entry's per-step losses on the mesh and alone, their
relative gaps against the limits (5e-3 before any update, 2e-2 after
one: the reductions run in another order and batch shape) for every mesh
run, the mesh runs' validation metrics, and the card's name and power
limit; it exits
non-zero when a limit is missed.  ``--tiny`` (every sub-command) takes
the tiny models on the CPU with gloo, a rehearsal.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ENTRIES = ("finetune_mir", "finetune_cls", "videomae_pretrain",
           "videomae_finetune", "pretrain_clip", "train_narrator")
# the --tiny narrator: 4 decoder blocks, cross-attention every 2nd (2
# groups, so pp = 2 splits it)
TINY_VCLM = dict(vocab_size=49408, context_length=77, width=32, layers=4,
                 heads=2, cross_every=2, image_size=32, patch_size=16,
                 vision_width=64, vision_layers=2, vision_heads=2)
BATCH, STEPS = 8, 2
LIMITS = (5e-3, 2e-2)  # relative loss gap: step 1, step 2


def _tiny() -> bool:
    return "--tiny" in sys.argv


def prepare(root: str, entries=ENTRIES) -> None:
    """The layouts and checkpoints under ``root`` that ``entries`` read."""
    import chip_smoke as cs
    import torch

    if {"pretrain_clip", "train_narrator"} & set(entries):
        if _tiny():
            cs.DATA_W, cs.DATA_H, cs.DATA_ROWS = 64, 48, 64
        meta = cs.write_ego4d_fixture(os.path.join(root, "ego4d"))
        # the narrator reads the first STEPS batches' rows (its loader
        # takes no subsample_stride)
        with open(meta, "rb") as f:
            rows = pickle.load(f)[:BATCH * STEPS]
        with open(os.path.join(root, "ego4d", "narrator.pkl"), "wb") as f:
            pickle.dump(rows, f)
    if set(entries) <= {"pretrain_clip", "train_narrator"}:
        return
    tiny = dict(w=64, h=48, fps=10) if _tiny() else {}
    cs.write_ek100_fixture(os.path.join(root, "ek100"),
                           train_clips=BATCH * STEPS, test_clips=BATCH,
                           **(dict(tiny, chunk_s=2) if _tiny() else {}))
    cs.write_k400_fixture(os.path.join(root, "k400"), videos=BATCH * STEPS,
                          **(dict(tiny, frames=24) if _tiny() else {}))
    clip = os.path.join(root, "clip.pt")
    if _tiny():
        from avion_tpu_torch.models.registry import create_model

        model = create_model("CLIP_TINY").init_weights(
            torch.Generator().manual_seed(5))
        torch.save({"state_dict": model.state_dict()}, clip)
        cs.VMAE_FT_MODEL, cs.VMAE_FRAMES = "VIDEOMAE_TINY_FT", 4
    else:
        cs.random_checkpoint(clip)
    cs.random_videomae_checkpoint(os.path.join(root, "videomae.pt"))


def entry_args(root: str, entry: str) -> list:
    """``entry``'s recipe (``chip_smoke``'s) on the layouts, cut to STEPS
    steps of BATCH clips, without mixup."""
    import chip_smoke as cs

    ek, k4 = os.path.join(root, "ek100"), os.path.join(root, "k400")
    common = [f"data.batch_size={BATCH}", "data.num_workers=0",
              "optim.epochs=1", "print_freq=1", "mixup=0", "cutmix=0"]
    ek_args = [f"data.root={ek}", f"pretrain_model={root}/clip.pt",
               f"data.train_metadata={ek}/EPIC_100_retrieval_train.csv",
               f"data.val_metadata={ek}/EPIC_100_retrieval_test.csv",
               f"data.val_batch_size={BATCH}", "eval_freq=1"]
    k4_args = [f"data.root={k4}", f"data.train_metadata={k4}/list.txt"]
    eg = os.path.join(root, "ego4d")
    rows = 64 if _tiny() else cs.DATA_ROWS
    tiny_clip = ["model.name=CLIP_TINY", "data.clip_length=2",
                 "data.crop_size=32", "model.image_size=32",
                 "model.vision_width=64", "model.vision_layers=2",
                 "model.vision_heads=2", "model.project_embed_dim=32",
                 "data.chunk_len=2"]
    args = {
        "finetune_mir": [*cs.FT_MIR_RECIPE, *ek_args,
                         f"data.relevancy_path={ek}/relevancy/caption_"
                         f"relevancy_EPIC_100_retrieval_test.pkl",
                         f"data.chunk_len={cs.DATA_CHUNK_S}"],
        "finetune_cls": [*cs.FT_CLS_RECIPE, *ek_args,
                         f"data.label_map={ek}/actions.csv",
                         "data.num_clips=2", f"data.chunk_len={cs.DATA_CHUNK_S}"],
        "videomae_pretrain": [*cs.VMAE_PRETRAIN_RECIPE, *k4_args],
        "videomae_finetune": [*cs.VMAE_FINETUNE_RECIPE, *k4_args,
                              f"pretrain_model={root}/videomae.pt",
                              f"data.val_metadata={k4}/list.txt",
                              f"data.val_batch_size={BATCH}",
                              "data.num_clips=2", "data.num_crops=1",
                              "eval_freq=1"],
        "pretrain_clip": [*cs.TRAIN_RECIPE, f"data.root={eg}",
                          f"data.train_metadata={eg}/train.pkl",
                          "data.dataset=ego4d", "eval_freq=0",
                          f"data.subsample_stride={rows // (BATCH * STEPS)}"],
        "train_narrator": [*cs.NR_RECIPE, f"data.root={eg}",
                           f"data.train_metadata={eg}/narrator.pkl",
                           "optim.update_freq=1"],
    }[entry] + common
    if _tiny():
        args += {"finetune_mir": tiny_clip, "finetune_cls": tiny_clip,
                 "videomae_pretrain": ["model.name=VIDEOMAE_TINY",
                                       "data.clip_length=4"],
                 "videomae_finetune": ["model.name=VIDEOMAE_TINY_FT",
                                       "data.clip_length=4",
                                       "model.num_classes=10"],
                 "pretrain_clip": [*tiny_clip, "data.decode_size=40",
                                   "data.chunk_len=15"],
                 "train_narrator": ["model.name=VCLM_TINY_SCRIPT",
                                    "data.clip_length=2", "data.crop_size=32",
                                    "data.decode_size=40",
                                    "data.chunk_len=15"]}[entry]
        args += ["--device", "cpu"]
    return args


def _register_tiny_vclm() -> None:
    import torch

    from avion_tpu_torch.models.narrator import VCLM
    from avion_tpu_torch.models.registry import register_model

    @register_model("VCLM_TINY_SCRIPT")
    def _tiny(num_frames=2, pipeline=False, pipeline_microbatches=8,
              pipeline_remat=False, dtype=None, **_):
        return VCLM(**TINY_VCLM, num_frames=num_frames, pipeline=pipeline,
                    pipeline_microbatches=pipeline_microbatches,
                    pipeline_remat=pipeline_remat,
                    dtype=dtype or torch.float32)


def run(root: str, entry: str, mesh: list) -> None:
    """``entry``'s ``main`` on this process (and its group, under
    torchrun); rank 0 writes the logged losses and the validation to
    ``<root>/<entry>_<world>[_<mesh and model arguments>].json``."""
    import importlib

    if _tiny():
        _register_tiny_vclm()
    orig = np.random.RandomState
    np.random.RandomState = lambda seed=None: orig(0 if seed is None
                                                    else seed)
    world = int(os.environ.get("WORLD_SIZE", 1))
    tag = "_".join([f"{entry}_{world}", *(m.replace("mesh.", "").replace(
        "model.", "").replace("=", "") for m in mesh)])
    out = os.path.join(root, "runs", tag)
    main = importlib.import_module(f"avion_tpu_torch.train.{entry}").main
    res = main([*entry_args(root, entry), *mesh, f"output_dir={out}"])
    if int(os.environ.get("RANK", 0)) == 0:
        with open(os.path.join(out, "log.jsonl")) as f:
            losses = [r["train/loss"] for r in map(json.loads, f)
                      if "train/loss" in r]
        with open(os.path.join(root, f"{tag}.json"), "w") as f:
            json.dump({"world": world, "mesh": mesh, "losses": losses,
                       "steps": res["steps"],
                       "eval": {str(k): v for k, v in
                                res.get("eval", {}).items()}}, f)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "cpu"


def compare(root: str) -> int:
    report, ok = {"card": card_line()}, True
    for entry in ENTRIES:
        runs = {}
        for name in sorted(os.listdir(root)):
            if name.startswith(entry + "_") and name.endswith(".json"):
                with open(os.path.join(root, name)) as f:
                    runs[name[:-len(".json")]] = json.load(f)
        # the one-process run of each model (its model.* arguments)
        models = lambda r: sorted(a for a in r["mesh"]  # noqa: E731
                                  if a.startswith("model."))
        refs = {tuple(models(r)): r for r in runs.values()
                if r["world"] == 1}
        for tag, wide in runs.items():
            alone = refs.get(tuple(models(wide)))
            if wide["world"] == 1 or alone is None:
                continue
            gaps = [abs(a - b) / abs(b) for a, b in zip(wide["losses"],
                                                       alone["losses"])]
            good = (wide["steps"] == alone["steps"] == STEPS
                    and len(gaps) == STEPS
                    and all(g <= lim for g, lim in zip(gaps, LIMITS))
                    and (entry in ("videomae_pretrain", "pretrain_clip",
                                   "train_narrator")
                         or bool(wide["eval"])))
            ok &= good
            report[tag] = {"world": wide["world"], "mesh": wide["mesh"],
                           "losses": wide["losses"],
                           "losses_alone": alone["losses"],
                           "relative_gaps": gaps, "limits": LIMITS,
                           "eval": wide["eval"], "ok": good}
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


def main() -> int:
    argv = [a for a in sys.argv[1:] if a != "--tiny"]
    cmd, root = argv[0], os.path.abspath(argv[1])
    if cmd == "prepare":
        os.makedirs(root, exist_ok=True)
        prepare(root, tuple(argv[2:]) or ENTRIES)
    elif cmd == "run":
        run(root, argv[2], argv[3:])
    elif cmd == "compare":
        return compare(root)
    else:
        raise SystemExit(f"unknown command {cmd!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
