"""The run's own check that nothing it loaded is JAX or the JAX package.

A module counts by its top-level name, the part before the first dot,
compared whole: ``avion_tpu_torch`` (the port) is not ``avion_tpu``.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "avion_tpu")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))
