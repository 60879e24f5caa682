"""Dataset / metric plotting utilities (the port's copy of
``avion_tpu.tools.plots``; matplotlib is imported where a plot is drawn).

Counterparts of the reference's one-off plot scripts
(``second_party/utils/plot_segment_distribution.py``,
``plot_jsonl_distribution.py``, ``plot_egoclip_vs_ego4d.py``,
``plot_relative_improvement.py``) consolidated into one CLI, using
plain matplotlib (Agg backend — no display, no seaborn/scienceplots
dependency).

Usage::

    python -m avion_tpu_torch.tools.plots segments --input meta.pkl --out d.png
    python -m avion_tpu_torch.tools.plots compare --input a.pkl --input b.pkl \
        --out cmp.png
    python -m avion_tpu_torch.tools.plots improvement --input peaks.csv \
        --baseline baseline_run --out imp.png
"""

from __future__ import annotations

import argparse
import csv
import json
import pickle
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend, imported at first draw
    (the card's machine has no matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def segment_lengths_from_rows(rows: Sequence) -> List[float]:
    """Durations from metadata rows: 4-tuples ``(vid, start, end, cap)``
    or uuid-stamped 5-tuples (``plot_segment_distribution.py:31-40``)."""
    if not rows:
        return []
    start_idx = 1 if len(rows[0]) == 4 else 2
    return [float(r[start_idx + 1]) - float(r[start_idx]) for r in rows]


def load_segment_lengths(path: str) -> List[float]:
    """Durations from a metadata pkl, a refinement csv
    (uuid/video_id/start_s/end_s/caption), or a refinement jsonl
    (``model_output.start/end`` rows; invalid rows skipped —
    ``plot_jsonl_distribution.py:10-29``)."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return segment_lengths_from_rows(pickle.load(f))
    if path.endswith(".csv"):
        out = []
        with open(path) as f:
            for row in csv.DictReader(f):
                out.append(float(row["end_s"]) - float(row["start_s"]))
        return out
    if path.endswith(".jsonl"):
        out = []
        with open(path) as f:
            for line in f:
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                mo = d.get("model_output") or {}
                if "start" not in mo or "end" not in mo:
                    continue
                if mo["start"] > mo["end"]:
                    continue
                out.append(float(mo["end"]) - float(mo["start"]))
        return out
    raise ValueError(f"unsupported input {path!r} (.pkl/.csv/.jsonl)")


def plot_segment_distribution(lengths: Sequence[float], out_path: str,
                              *, bins: int = 50, log_scale: bool = False,
                              title: str = "Segment length distribution",
                              ) -> Dict[str, float]:
    """Histogram of segment durations; returns summary stats."""
    lengths = np.asarray(lengths, np.float64)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.hist(lengths, bins=bins, edgecolor="black", alpha=0.7)
    if log_scale:
        ax.set_yscale("log")
    ax.set_xlabel("Segment length (s)")
    ax.set_ylabel("Frequency")
    ax.set_title(title)
    stats = {
        "count": int(lengths.size),
        "mean": float(lengths.mean()) if lengths.size else 0.0,
        "median": float(np.median(lengths)) if lengths.size else 0.0,
        "p95": float(np.percentile(lengths, 95)) if lengths.size else 0.0,
    }
    ax.axvline(stats["mean"], color="tab:red", linestyle="--",
               label=f"mean {stats['mean']:.2f}s")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return stats


def plot_dataset_comparison(named_lengths: Dict[str, Sequence[float]],
                            out_path: str, *, bins: int = 50,
                            log_scale: bool = True) -> None:
    """Overlayed duration distributions of several datasets
    (``plot_egoclip_vs_ego4d.py`` shape)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    all_vals = np.concatenate(
        [np.asarray(v, np.float64) for v in named_lengths.values()])
    edges = np.histogram_bin_edges(all_vals, bins=bins)
    for name, vals in named_lengths.items():
        ax.hist(vals, bins=edges, alpha=0.5, label=f"{name} (n={len(vals)})")
    if log_scale:
        ax.set_yscale("log")
    ax.set_xlabel("Segment length (s)")
    ax.set_ylabel("Frequency")
    ax.set_title("Segment length distributions")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def relative_improvements(rows: List[Dict[str, str]], baseline: str,
                          metrics: Sequence[str],
                          run_col: str = "run_name",
                          ) -> Dict[str, Dict[str, float]]:
    """Per-run absolute deltas vs the baseline row across metric
    columns, plus the task mean (``plot_relative_improvement.py:36-55``
    semantics: delta = run - baseline, mean over task metrics)."""
    base = next((r for r in rows if r[run_col] == baseline), None)
    if base is None:
        raise ValueError(f"baseline {baseline!r} not found")
    out: Dict[str, Dict[str, float]] = {}
    for r in rows:
        if r[run_col] == baseline:
            continue
        deltas = {m: float(r[m]) - float(base[m]) for m in metrics}
        deltas["mean"] = float(np.mean([deltas[m] for m in metrics]))
        out[r[run_col]] = deltas
    return out


def plot_relative_improvement(csv_path: str, baseline: str, out_path: str,
                              metrics: Optional[Sequence[str]] = None,
                              run_col: str = "run_name",
                              ) -> Dict[str, Dict[str, float]]:
    """Grouped bars of metric deltas vs a baseline run."""
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if metrics is None:
        metrics = [c for c in rows[0] if c != run_col]
    imps = relative_improvements(rows, baseline, metrics, run_col)
    names = list(imps)
    cols = list(metrics) + ["mean"]
    width = 0.8 / max(len(names), 1)
    x = np.arange(len(cols))
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(max(8, 1.6 * len(cols)), 5))
    for i, name in enumerate(names):
        ax.bar(x + i * width, [imps[name][c] for c in cols], width,
               label=name)
    ax.axhline(0.0, color="black", linewidth=0.8)
    ax.set_xticks(x + width * (len(names) - 1) / 2)
    ax.set_xticklabels(cols, rotation=30, ha="right")
    ax.set_ylabel(f"delta vs {baseline}")
    ax.set_title("Relative improvement over baseline")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return imps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("segments", help="duration histogram")
    s.add_argument("--input", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--bins", type=int, default=50)
    s.add_argument("--log-scale", action="store_true")
    s.add_argument("--title", default="Segment length distribution")

    c = sub.add_parser("compare", help="overlayed duration histograms")
    c.add_argument("--input", action="append", required=True,
                   help="repeatable; label taken from the filename")
    c.add_argument("--out", required=True)
    c.add_argument("--bins", type=int, default=50)

    i = sub.add_parser("improvement", help="metric deltas vs baseline")
    i.add_argument("--input", required=True, help="peak-metrics csv")
    i.add_argument("--baseline", required=True)
    i.add_argument("--out", required=True)
    i.add_argument("--metric", action="append", default=None,
                   help="repeatable; default = every non-run column")
    i.add_argument("--run-col", default="run_name")

    args = p.parse_args(argv)
    if args.cmd == "segments":
        stats = plot_segment_distribution(
            load_segment_lengths(args.input), args.out, bins=args.bins,
            log_scale=args.log_scale, title=args.title)
        print(json.dumps(stats))
    elif args.cmd == "compare":
        named = {path.rsplit("/", 1)[-1].rsplit(".", 1)[0]:
                 load_segment_lengths(path) for path in args.input}
        plot_dataset_comparison(named, args.out, bins=args.bins)
        print(f"wrote {args.out}")
    else:
        imps = plot_relative_improvement(args.input, args.baseline,
                                         args.out, args.metric,
                                         args.run_col)
        print(json.dumps(imps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
