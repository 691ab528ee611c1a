"""BENCHMARK.json keeps to its contract, and every name in it finds its
files; each configuration states the sizes its tests run it at; a new
configuration, schema, reference, traffic mix and per-layer metric are
new files and entries, with no edit to a file that is there."""

import hashlib
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.control import control
from benchmark.spec import BENCH_DIR, ROOT, Cell, load_benchmark, load_module
from benchmark.tests.test_benchmark_cells import own_reference_agrees, sized

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


def _check_test_rows(config):
    """`test_rows` holds a "cpu" and a "card" size, each with the keys of
    `rows` and positive counts no larger than the timed run's."""
    assert set(config["test_rows"]) == {"cpu", "card"}
    for rows in config["test_rows"].values():
        assert set(rows) == set(config["rows"])
        assert all(isinstance(n, int) and 0 < n <= config["rows"][table]
                   for table, n in rows.items())


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      load_benchmark()["workloads"]])
def test_every_name_finds_its_files(workload):
    cell = Cell(load_benchmark(), workload)
    assert callable(cell.schema.generate) and callable(cell.schema.templates)
    assert cell.traffic["draws"] and cell.traffic["draws_per_request"] >= 1
    assert {m["name"] for m in cell.per_layer} == set(cell.readers)
    assert cell.end_to_end and cell.per_layer
    _check_test_rows(cell.config)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import radixhashjoin_tpu_torch  # noqa: F401
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(__import__("sys").modules, "radixhashjoin_tpu.ops",
                        object())
    monkeypatch.setitem(__import__("sys").modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["jaxlib", "radixhashjoin_tpu.ops"]


ZIPF_SCHEMA = '''"""SSB with lo_suppkey drawn from a Zipf law (a test's schema)."""
import os

import numpy as np

from benchmark.spec import load_module

ssb = load_module(os.path.join(os.path.dirname(__file__), "ssb.py"))
templates = ssb.templates
SUPPKEY = ssb.COLUMNS["lineorder"].index("lo_suppkey")


def generate(config, seed, device):
    relations = ssb.generate(config, seed, device)
    fact = relations[ssb.LINEORDER]
    draws = np.random.default_rng(seed).zipf(1.5, len(fact[SUPPKEY]))
    fact[SUPPKEY] = ((draws - 1) % config["rows"]["supplier"] + 1
                     ).astype(np.uint64)
    return relations
'''


RECORDED_REFERENCE = '''"""The shared semantics, each instance's SUM type recorded in `made`
(a test's reference)."""
import os

import torch

from benchmark.spec import load_module

semantics = load_module(os.path.join(os.path.dirname(__file__),
                                     "semantics.py"))


class Reference(semantics.Reference):
    made = []

    def __init__(self, relations, device, sum_dtype=torch.int64):
        super().__init__(relations, device, sum_dtype)
        self.made.append(sum_dtype)
'''

WRONG_REFERENCE = RECORDED_REFERENCE + '''
    def answer(self, line):
        """The first line answered with numbers has its first SUM one
        more."""
        sums = super().answer(line)
        if sums is not None and not getattr(self, "altered", False):
            self.altered = True
            sums[0] += 1
        return sums
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_traffic_and_metric_are_files_and_entries(tmp_path):
    """A throwaway checkout gains a configuration whose schema module is
    new (SSB with Zipf-drawn supplier keys) and which names a reference
    module of its own, a traffic mix, a per-layer metric and a cell by
    new files and entries only, with no copied file changed: the cell
    tests' helper sizes the cell from the configuration's own
    `test_rows`, the run finds and uses each file and comes out correct
    on the CPU, the harness and the control answer with that reference
    (int64 and float32 SUMs), and a reference that gets one sum wrong
    makes the run not correct and fails the shared semantics' test."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    copied = _digests(root)
    bench = load_benchmark()
    config = json.loads((root / "benchmark/configs/ssb_sf20.json").read_text())
    rows = config["test_rows"]["cpu"]
    cpu = dict(rows, lineorder=rows["lineorder"] // 2)
    config.update(name="ssb_tiny", schema="ssb_zipf_supp", rows=rows,
                  test_rows={"cpu": cpu, "card": rows},
                  reference="ssb_recorded")
    _check_test_rows(config)
    (root / "benchmark/configs/ssb_tiny.json").write_text(json.dumps(config))
    (root / "benchmark/schemas/ssb_zipf_supp.py").write_text(ZIPF_SCHEMA)
    (root / "benchmark/reference/ssb_recorded.py").write_text(
        RECORDED_REFERENCE)
    (root / "benchmark/reference/ssb_wrong_sum.py").write_text(
        WRONG_REFERENCE)
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

    cell = sized(Cell(json.loads((root / "BENCHMARK.json").read_text()),
                      "ssb_tiny.flight4", str(root)), "cpu")
    assert cell.config["rows"] == cpu
    assert "dispatches_per_query" in cell.readers
    relations = cell.schema.generate(cell.config, 11, torch.device("cpu"))
    assert len(relations[0][0]) == cpu["lineorder"]
    ssb = load_module(os.path.join(BENCH_DIR, "schemas", "ssb.py"))
    plain = ssb.generate(cell.config, 11, torch.device("cpu"))
    suppkey = ssb.COLUMNS["lineorder"].index("lo_suppkey")
    assert [i for i, (a, b) in enumerate(zip(relations[0], plain[0]))
            if not np.array_equal(a, b)] == [suppkey]
    assert np.bincount(relations[0][suppkey].astype(np.int64)).argmax() == 1
    made = cell.reference.made
    result = harness.run_cell(cell, 11, 0.2, True, torch.device("cpu"), 0.0)
    assert result["correct"], result["checks"]
    assert made == [torch.int64]
    assert "dispatches_per_query" in result["metrics"]
    assert result["info"]["queries_a_cycle"] == 6
    assert result["info"]["requests_a_cycle"] == 2
    own_reference_agrees(json.loads((root / "BENCHMARK.json").read_text()),
                         "ssb_tiny", str(root))
    made.clear()
    controlled = harness.run_cell(cell, 11, 0.2, False, torch.device("cpu"),
                                  0.0, engine_factory=control(cell))
    assert made == [torch.float32, torch.int64]
    assert not controlled["correct"]

    config.update(reference="ssb_wrong_sum")
    (root / "benchmark/configs/ssb_tiny.json").write_text(json.dumps(config))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wrong = sized(Cell(bench, "ssb_tiny.flight4", str(root)), "cpu")
    result = harness.run_cell(wrong, 11, 0.2, False, torch.device("cpu"),
                              0.0)
    assert not result["correct"]
    assert result["checks"]["mismatched_lines"]["value"] > 0
    with pytest.raises(AssertionError):
        own_reference_agrees(bench, "ssb_tiny", str(root))
    assert {k: v for k, v in _digests(root).items() if k in copied} == copied
