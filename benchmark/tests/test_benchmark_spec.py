"""BENCHMARK.json keeps to its contract, and every name in it finds its
files; a new configuration, traffic mix and per-layer metric are new
files and entries, with no edit to a file that is there."""

import json
import os
import re
import shutil

import pytest
import torch

from benchmark import harness
from benchmark.spec import BENCH_DIR, ROOT, Cell, load_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_the_contract():
    bench = load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][1] == "benchmark/run.py"
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    assert len(names) == len(bench["configs"])
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells)
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(cells)
    for w in bench["workloads"]:
        assert set(w) == CELL_KEYS
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
    assert {w["config"] for w in bench["workloads"]} == names
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    reports = {m["name"]: set(m.get("workloads", cells))
               for m in bench["end_to_end"]}
    for w in cells:      # setup_s, another end-to-end metric, a per-layer one
        assert "setup_s" in [m for m in reports if w in reports[m]]
        assert len([m for m in reports if w in reports[m]]) >= 2
        assert any(w in m.get("workloads", cells) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["moves"] in e2e and _line(m["layer"])
        # every cell that reads the metric reports the metric it moves
        assert set(m.get("workloads", cells)) <= reports[m["moves"]]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      load_benchmark()["workloads"]])
def test_every_name_finds_its_files(workload):
    cell = Cell(load_benchmark(), workload)
    assert callable(cell.schema.generate) and callable(cell.schema.templates)
    assert cell.traffic["draws"] and cell.traffic["draws_per_request"] >= 1
    assert {m["name"] for m in cell.per_layer} == set(cell.readers)
    assert cell.end_to_end and cell.per_layer


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import radixhashjoin_tpu_torch  # noqa: F401
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(__import__("sys").modules, "radixhashjoin_tpu.ops",
                        object())
    monkeypatch.setitem(__import__("sys").modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["jaxlib", "radixhashjoin_tpu.ops"]


def test_a_new_config_traffic_and_metric_are_files_and_entries(tmp_path):
    """A throwaway checkout gains a configuration, a traffic mix, a
    per-layer metric and a cell by new files and entries only; the run
    finds and uses each of them."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = load_benchmark()
    config = json.loads((root / "benchmark/configs/ssb_sf20.json").read_text())
    config.update(name="ssb_tiny", rows={
        "lineorder": 20000, "date": 2556, "customer": 300, "supplier": 20,
        "part": 2000})
    (root / "benchmark/configs/ssb_tiny.json").write_text(json.dumps(config))
    (root / "benchmark/traffic/flight4_batches.json").write_text(json.dumps(
        {"draws": {"q4.1": 4, "q4.3": 2}, "draws_per_request": 3}))
    (root / "benchmark/metrics/dispatches_per_query.py").write_text(
        "def read(rec):\n"
        "    return rec['counters']['dispatches'] / rec['queries']\n")
    bench["configs"].append({"name": "ssb_tiny", "source": "a test",
                             "file": "benchmark/configs/ssb_tiny.json",
                             "reduced": ["rows"], "why": "a test"})
    bench["workloads"].append({"name": "ssb_tiny.flight4",
                               "config": "ssb_tiny",
                               "traffic": "flight4_batches", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "queries_per_s.tiny",
                                "unit": "queries/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["ssb_tiny.flight4"]})
    bench["per_layer"].append({"name": "dispatches_per_query",
                               "unit": "dispatches/query", "better": "lower",
                               "source": "program_counter",
                               "layer": "batch driver (models/batch.py)",
                               "moves": "queries_per_s.tiny",
                               "workloads": ["ssb_tiny.flight4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell(json.loads((root / "BENCHMARK.json").read_text()),
                "ssb_tiny.flight4", str(root))
    assert "dispatches_per_query" in cell.readers
    result = harness.run_cell(cell, 11, 0.2, True, torch.device("cpu"), 0.0)
    assert result["correct"], result["checks"]
    assert "dispatches_per_query" in result["metrics"]
    assert result["info"]["queries_a_cycle"] == 6
    assert result["info"]["requests_a_cycle"] == 2
