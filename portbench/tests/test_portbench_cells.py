"""``BENCHMARK.json`` and the files it names: every cell resolves to its
configuration, traffic, limits, job, reference and metric readers; the
names, units and keys keep to the benchmark's format; a cell loads from
data files alone."""

import importlib
import json
import os
import re

import pytest

from portbench import cells, compare
from portbench.tests.conftest import TINY_CELLS

BENCH = cells.read_json(os.path.join(cells.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(width|_dim|_rank|heads|hidden|intermediate|latent)")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_the_file_has_the_benchmark_format():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in
                                                 BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind,key", [("config", "configs"),
                                      ("workload", "workloads"),
                                      ("end_to_end", "end_to_end"),
                                      ("per_layer", "per_layer")])
def test_entries_have_their_keys_and_names(kind, key):
    names = [e["name"] for e in BENCH[key]]
    assert len(names) == len(set(names))
    for e in BENCH[key]:
        assert KEYS[kind] <= set(e) <= KEYS[kind] | {"workloads"}
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), (e["name"], k)


def test_metrics_and_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert {"clips_per_s", "clips_per_s.pretrain", "peak_mem_gib",
            "setup_s"} == names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in names
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "attn_roofline" in layers["attention kernels"]


def test_configs_keep_every_width():
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        data = cells.read_json(os.path.join(cells.ROOT, c["file"]))
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_workload_resolves_to_its_files(workload):
    work = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert work["chips"] in (1, 4)
    assert NAME.match(work["traffic"]) and NAME.match(work["config"])
    cell = cells.load(workload)
    assert set(cell.limits) == set(compare.NAMES)
    assert cell.traffic["compared_steps"] <= cell.traffic["warmup_steps"]
    assert cell.traffic["compared_steps"] <= cell.traffic["batches"]
    assert importlib.import_module(f"portbench.jobs.{cell.traffic['job']}")
    assert cell.family.weight_spec(cell.config, cell.traffic)
    assert cell.family.step_work(cell.config, cell.traffic).model_flops > 0
    e2e = {m["name"] for m in cell.end_to_end}
    rate = e2e - {"peak_mem_gib", "setup_s"}
    assert len(rate) == 1 and rate.pop().split(".")[0] == "clips_per_s"
    assert {"peak_mem_gib", "setup_s"} <= e2e
    # every per-layer metric here moves an end-to-end metric of the cell,
    # and each quantity is read once
    assert {m["moves"] for m in cell.per_layer} <= e2e
    quantities = []
    for m in cell.per_layer:
        reader, data = cells.metric_reader(m["name"])
        assert callable(reader.read)
        quantities.append(reader.__name__)
    assert len(quantities) == len(set(quantities)) == 7


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_a_cell_loads_from_data_files_alone(tiny_root):
    for name, (config, traffic) in TINY_CELLS.items():
        cell = cells.load(name, tiny_root)
        assert cell.config["port_model"] in ("CLIP_TINY", "VIDEOMAE_TINY")
        assert cell.traffic["batch"] == 8
        assert cell.limits["loss_gap"] > 0
    with pytest.raises(KeyError):
        cells.load("no_such.cell", tiny_root)


def test_files_under_the_benchmark_are_named_from_name_characters():
    for root, dirs, files in os.walk(cells.BENCH_DIR):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".cache")]
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), cells.ROOT)
            assert PATH.match(rel), rel
