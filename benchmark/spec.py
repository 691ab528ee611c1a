"""Everything the harness runs is found by the names in BENCHMARK.json:

    configs[].file                 the configuration (JSON), whose
                                   "schema" names schemas/<schema>.py
                                   and "reference", if it has one,
                                   reference/<reference>.py (else
                                   reference/semantics.py)
    traffic/<traffic>.json         a cell's traffic mix (data only)
    metrics/<name>.py              a per-layer metric's reader (a name
                                   split by cells, `<base>.<cells>`, may
                                   use its base's, metrics/<base>.py)

A later cell, configuration, traffic mix or metric is new files and new
entries; no file here changes:

- a configuration brings its schema module (schemas/<schema>.py, which
  may load another schema's by path with `load_module` and change what
  it must), its file under configs/ with "rows", the timed sizes, and
  "test_rows": {"cpu": {...}, "card": {...}}, the sizes its tests run
  it at (the keys of "rows"; tests/test_benchmark_cells.py `sized`),
  any traffic mix it needs and the readers of its per-layer metrics;
  where the shared reference cannot answer its queries at its sizes
  (reference/semantics.py builds every joined pair), it names a plain
  reference of its own, reference/<module>.py: a class `Reference(
  relations, device, sum_dtype=torch.int64)` with `lines(request) ->
  List[str]`, the same semantics by another algorithm, importing nothing
  of the program; the harness answers the requests with it and the
  control (control.py) is the same class with `sum_dtype=torch.float32`;
- a cell is an entry of "workloads"; its name goes into the
  "workloads" list of each metric it reports that has one ("setup_s"
  has none: every cell reports it);
- a cell whose runs spread otherwise than the cells under a metric's
  bound reports a split name, `<metric>.<group>`, with its own bound.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(path: str) -> ModuleType:
    """A module from its file (names may hold dots, so not by import)."""
    name = "_bench_" + os.path.relpath(path, ROOT).replace(os.sep, "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with what it names, loaded."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        bench_dir = os.path.join(root, "benchmark")
        self.schema = load_module(os.path.join(
            bench_dir, "schemas", f"{self.config['schema']}.py"))
        self.reference = load_module(os.path.join(
            bench_dir, "reference",
            f"{self.config.get('reference', 'semantics')}.py")).Reference
        with open(os.path.join(bench_dir, "traffic",
                               f"{self.workload['traffic']}.json")) as f:
            self.traffic = json.load(f)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.readers = {m["name"]: load_module(reader_path(
            bench_dir, m["name"])).read for m in self.per_layer}


def base_name(metric: str) -> str:
    """`launches_per_query.ssb` -> `launches_per_query`: a metric split by
    the cells that report it keeps its base's meaning."""
    return metric.split(".")[0]


def reader_path(bench_dir: str, metric: str) -> str:
    """metrics/<name>.py, else the reader of the name's base."""
    own = os.path.join(bench_dir, "metrics", f"{metric}.py")
    if os.path.isfile(own):
        return own
    return os.path.join(bench_dir, "metrics", f"{base_name(metric)}.py")
