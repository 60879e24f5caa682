"""EK100-CLS action recognition (``avion_tpu.train.finetune_cls``).

For now only :func:`load_actions`, which the EK100 zero-shot suite
(``eval.validate``) reads its classes with; the finetune entry comes with
the finetune slice.
"""

from __future__ import annotations

import csv


def load_actions(actions_csv: str):
    """EPIC-100 actions.csv -> (action label texts, (verb, noun) pairs,
    'v:n' -> action-id mapping)."""
    labels, pairs, mapping = [], [], {}
    with open(actions_csv) as f:
        reader = csv.reader(f)
        next(reader)
        for i, row in enumerate(reader):
            labels.append(row[3].replace("_", " "))
            verb, noun = int(row[1]), int(row[2])
            pairs.append((verb, noun))
            mapping[f"{verb}:{noun}"] = i
    return labels, pairs, mapping
