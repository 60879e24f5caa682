"""A cell's files, found by the names in ``BENCHMARK.json``.

For the workload ``<name>`` with configuration ``<config>`` and traffic
``<traffic>``:

- the configuration: the ``file`` that ``BENCHMARK.json`` gives it, whose
  ``family`` names the plain reference ``reference/<family>.py``;
- the traffic: ``traffic/<traffic>.json``, whose ``job`` names
  ``jobs/<job>.py``;
- the limits of the comparison: ``limits/<name>.json``;
- each per-layer metric ``<metric>``: ``metrics/<metric>.py`` (its reader)
  and ``metrics/<metric>.json`` (its data), or, for ``<quantity>.<suffix>``
  with no reader of its own, the quantity's; read where the metric names
  the cell, or everywhere when it lists no ``workloads``;
- each end-to-end metric: where it names the cell, or everywhere when it
  lists no ``workloads``; the part of its name before the first dot is
  the quantity (``clips_per_s.pretrain`` is clips a second).

The data files are looked up under the benchmark's folder of ``root``
(by default this checkout); readers, jobs and references are this
package's own.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def family(self):
        return importlib.import_module(
            f"portbench.reference.{self.config['family']}")

    @property
    def job(self):
        return importlib.import_module(f"portbench.jobs.{self.traffic['job']}")


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(name: str, root: str = ROOT) -> Cell:
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    work = found[0]
    config = next(c for c in bench["configs"] if c["name"] == work["config"])
    data = os.path.join(root, bench["paths"][0])
    return Cell(
        name=name, chips=int(work["chips"]),
        config=read_json(os.path.join(root, config["file"])),
        traffic=read_json(os.path.join(data, "traffic",
                                       f"{work['traffic']}.json")),
        limits=read_json(os.path.join(data, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    """(the reader module of per-layer metric ``name``, its data).  A
    metric ``<quantity>.<suffix>`` with no reader of its own is that
    quantity in cells that move another end-to-end metric
    (``attn.ms.pretrain`` is ``attn.ms``): it reads with the quantity's
    reader and data."""
    folder = os.path.join(BENCH_DIR, "metrics")
    reader = name
    while not os.path.exists(os.path.join(folder, f"{reader}.py")):
        if "." not in reader:
            raise FileNotFoundError(f"no reader metrics/<name>.py for the "
                                    f"per-layer metric {name!r}")
        reader = reader.rsplit(".", 1)[0]
    own = os.path.join(folder, f"{reader}.json")
    data = read_json(own) if os.path.exists(own) else {}
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{reader.replace('.', '_')}",
        os.path.join(folder, f"{reader}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module, data
