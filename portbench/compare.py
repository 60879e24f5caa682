"""What decides ``correct``: the program's first train steps against the
reference's, from the same weights and batches.

Readings on each side: each step's loss (``loss``), each leaf's norm of
the first step's gradient as the optimizer gets it (``grad``) and each
leaf's change after the compared steps (``change``, tensors on the host);
the reference adds its first gradient's values (``grad_values``).  Five
numbers are compared:

- ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps;
- ``grad_gap``: over the leaves, the largest gap between the program's
  norm and the reference's, divided by the larger of that leaf's
  reference norm and the median leaf's;
- ``change_gap``: the same over the norms of the leaves' changes;
- ``grad_gap_median``, ``change_gap_median``: the median leaf's gaps, which
  swing less from seed to seed than the worst leaf's.

What moves under Adam by round-off alone is left out: leaves whose
reference gradient norm is under a thousandth of the median leaf's, and
leaves the reference gives no gradient, from every number; and from the
changes, the elements whose reference gradient is under a thousandth of
the median leaf's root mean square (the key's third of a fused ``qkv``
bias, which softmax makes nought).  A leaf the reference moves and the
program does not reads 1.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

NAMES = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median",
         "change_gap_median")
NEGLIGIBLE = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               leaves) -> tuple:
    """(the worst leaf's gap, that leaf, the median leaf's gap)."""
    median = statistics.median(ref[n] for n in leaves)
    gaps = {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], median)
            for n in leaves}
    if not all(math.isfinite(g) for g in gaps.values()):
        return math.inf, "", math.inf
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst, statistics.median(gaps.values())


def changed_norms(prog: dict, ref: dict, leaves) -> tuple:
    """({leaf: program's change norm}, {leaf: reference's}) over the
    elements whose reference gradient is not negligible."""
    rms = statistics.median(
        ref["grad"][n] / math.sqrt(max(1, ref["grad_values"][n].numel()))
        for n in ref["grad"])
    floor = NEGLIGIBLE * rms
    mine, theirs = {}, {}
    for n in leaves:
        keep = ref["grad_values"][n].abs() >= floor
        theirs[n] = float(torch.linalg.vector_norm(ref["change"][n][keep]))
        if n in prog["change"]:
            mine[n] = float(torch.linalg.vector_norm(
                prog["change"][n].to(keep.device)[keep]))
    return mine, theirs


def gaps(prog: dict, ref: dict) -> dict:
    steps = len(ref["loss"])
    if len(prog["loss"]) != steps:
        raise ValueError(f"{len(prog['loss'])} program losses against "
                         f"{steps} of the reference")
    loss_gap = max(abs(p - r) / max(abs(r), 1e-12)
                   for p, r in zip(prog["loss"], ref["loss"]))
    if not all(math.isfinite(p) for p in prog["loss"]):
        loss_gap = math.inf
    median = statistics.median(ref["grad"].values())
    leaves = [n for n, g in ref["grad"].items() if g >= NEGLIGIBLE * median]
    grad_gap, grad_leaf, grad_median = _leaf_gaps(prog["grad"], ref["grad"],
                                                  leaves)
    mine, theirs = changed_norms(prog, ref, leaves)
    change_gap, change_leaf, change_median = _leaf_gaps(mine, theirs, leaves)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_gap_median": grad_median,
            "change_gap_median": change_median, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf,
            "left_out": sorted(set(ref["grad"]) - set(leaves))}


def judge(found: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers of
    :data:`NAMES` whose limit is not null.  A null limit marks a number
    that neither the control nor a fault separates from sound runs in
    that cell: it is not compared."""
    checked = {n: {"value": found[n], "limit": limits[n]} for n in NAMES
               if limits[n] is not None}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checked.values())
    return ok, checked
