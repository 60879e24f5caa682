"""Extract peak metrics from training logs (the port's copy of
``avion_tpu.tools.metrics_extractor``).

Counterpart of ``second_party/wandb_extractor/download_wandb_metrics.py``
generalized to this framework's sinks: reads either the local
``log.jsonl`` files every run writes, or (when available and
configured) the wandb API, and emits a CSV of peak/final values per
metric per run.

Usage::

    python -m avion_tpu_torch.tools.metrics_extractor --runs out1 out2 \
        --metrics test_ek100_mir_avg_map train/loss --out peaks.csv
"""

from __future__ import annotations

import argparse
import csv
import json
import os.path as osp
from typing import Dict, List, Optional


def read_jsonl_metrics(run_dir: str) -> List[dict]:
    path = osp.join(run_dir, "log.jsonl")
    if not osp.exists(path):
        return []
    out = []
    for line in open(path):
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return out


def peak_metrics(records: List[dict], metrics: List[str],
                 mode: str = "max") -> Dict[str, float]:
    out = {}
    for m in metrics:
        vals = [(r.get("step", i), r[m]) for i, r in enumerate(records)
                if m in r]
        if not vals:
            continue
        if mode == "max":
            step, v = max(vals, key=lambda x: x[1])
        elif mode == "min":
            step, v = min(vals, key=lambda x: x[1])
        else:  # final
            step, v = vals[-1]
        out[m] = v
        out[f"{m}_step"] = step
    return out


def extract_wandb(project: str, metrics: List[str]) -> List[Dict]:
    """Pull peak metrics from the wandb API when importable/configured."""
    try:
        import wandb

        api = wandb.Api()
    except Exception as e:
        raise RuntimeError(f"wandb unavailable: {e}")
    rows = []
    for run in api.runs(project):
        rec = {"run": run.name}
        summary = dict(run.summary)
        for m in metrics:
            if m in summary:
                rec[m] = summary[m]
        rows.append(rec)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--runs", nargs="+", required=True)
    p.add_argument("--metrics", nargs="+", required=True)
    p.add_argument("--mode", default="max", choices=["max", "min", "final"])
    p.add_argument("--out", default="peaks.csv")
    args = p.parse_args(argv)
    rows = []
    for run in args.runs:
        rec = {"run": run}
        rec.update(peak_metrics(read_jsonl_metrics(run), args.metrics,
                                args.mode))
        rows.append(rec)
    keys = ["run"] + sorted({k for r in rows for k in r if k != "run"})
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.out}")


if __name__ == "__main__":
    main()
