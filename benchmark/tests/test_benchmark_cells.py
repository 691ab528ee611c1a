"""Each configuration at a tiny size on the CPU: the program's Engine and
the reference print the same lines; the run comes out not correct when
the timed path is broken underneath it (faults planted in the program's
place), and the run's own checks hold."""

import copy
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import generator, harness
from benchmark.capture import _host_at, _union, reduce_capture
from benchmark.control import control
from benchmark.reference.semantics import Reference
from benchmark.spec import ROOT, Cell, load_benchmark
from radixhashjoin_tpu_torch.utils import profiling

CPU = torch.device("cpu")
SEED = 2**31 + 12345          # past 32 signed bits, as the driver's are


CELLS = [w["name"] for w in load_benchmark()["workloads"]]


def sized(cell, where):
    """`cell` at the rows its configuration file states for tests on the
    CPU or the card (`where` "cpu" or "card"): `test_rows[where]` in
    place of `rows`."""
    cell = copy.copy(cell)
    cell.config = dict(cell.config, rows=cell.config["test_rows"][where])
    return cell


def tiny(workload):
    return sized(Cell(load_benchmark(), workload), "cpu")


def run(cell, engine_factory=None, seconds=0.3, seed=SEED):
    return harness.run_cell(cell, seed, seconds, False, CPU, 0.0,
                            engine_factory=engine_factory)


@pytest.mark.parametrize("workload", CELLS)
def test_engine_and_reference_print_the_same_lines(workload):
    result = run(tiny(workload))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in
                                      tiny(workload).end_to_end}
    assert list(result)[-2:] == ["checks", "info"]


def _cycle_lines(cell, reference):
    """[lines of each request] of one cycle of `cell`'s traffic at its
    size, answered by `reference` on the CPU."""
    cols = cell.schema.generate(cell.config, SEED, CPU)
    cycle = generator.requests(cell.traffic,
                               cell.schema.templates(cell.config, cols), SEED)
    ref = reference(cols, CPU)
    return [ref.lines(req) for _l, req, _n in cycle]


@pytest.mark.parametrize("workload", CELLS)
def test_the_lines_are_not_all_null(workload):
    """The tiny data still answers most queries with numbers."""
    cell = tiny(workload)
    lines = [ln for req in _cycle_lines(cell, cell.reference) for ln in req]
    assert sum("NULL" not in ln for ln in lines) > len(lines) // 2


def own_reference_agrees(bench, config, root=ROOT):
    """Over one cycle of each of `config`'s cells at its `test_rows["cpu"]`
    sizes, the configuration's reference gives the shared semantics'
    (reference/semantics.py) lines."""
    cells = [w["name"] for w in bench["workloads"] if w["config"] == config]
    assert cells
    for w in cells:
        cell = sized(Cell(bench, w, root), "cpu")
        assert _cycle_lines(cell, cell.reference) == \
            _cycle_lines(cell, Reference), w


@pytest.mark.parametrize("config", [c["name"] for c in
                                    load_benchmark()["configs"]])
def test_a_configuration_s_reference_keeps_the_shared_semantics(config):
    """A configuration that names a reference of its own is held to the
    shared one's lines; one that names none is answered by the shared
    one."""
    bench = load_benchmark()
    cell = Cell(bench, next(w["name"] for w in bench["workloads"]
                            if w["config"] == config))
    if "reference" in cell.config:
        own_reference_agrees(bench, config)
    else:
        assert cell.reference.lines.__code__.co_filename == os.path.join(
            ROOT, "benchmark", "reference", "semantics.py")


def test_a_seed_gives_the_same_inputs():
    cell = tiny("ssb_sf20.mixed")
    a = cell.schema.generate(cell.config, SEED, CPU)
    b = cell.schema.generate(cell.config, SEED, CPU)
    assert all(np.array_equal(x, y) for r, s in zip(a, b)
               for x, y in zip(r, s))
    assert [len(r) for r in a] == [17, 17, 8, 7, 9]
    rows = cell.config["test_rows"]["cpu"]
    assert len(a[0][0]) == rows["lineorder"] and len(a[1][0]) == rows["date"]


class _Broken:
    """The program with one fault planted where its answers are made."""

    def __init__(self, relations, device, fault):
        from radixhashjoin_tpu_torch.models.engine import Engine
        self.engine = Engine(relations, device=device)
        self.batch_executor = self.engine.batch_executor
        self.fault = fault
        self.last = None

    def run_batch(self, batch):
        if self.fault == "state_unchanged" and self.last is not None:
            return list(self.last)          # the previous request's lines
        if self.fault == "half_the_batch":
            kept = self.engine.run_batch(batch[:(len(batch) + 1) // 2])
            self.last = kept
            return kept
        lines = self.engine.run_batch(batch)
        if self.fault == "answer_altered":
            for i, ln in enumerate(lines):
                if "NULL" not in ln:
                    first, *rest = ln.split(" ")
                    lines[i] = " ".join([str(int(first) + 1), *rest])
                    break
        self.last = lines
        return lines


def _faults():
    """(cell, fault) pairs: half of a batch can be left out only where a
    request sends more than one line (flight 1's requests send one)."""
    for w in CELLS:
        cell = tiny(w)
        cycle = generator.requests(cell.traffic, cell.schema.templates(
            cell.config, None), SEED)
        for fault in ("state_unchanged", "half_the_batch", "answer_altered"):
            if fault != "half_the_batch" or max(len(r[1]) for r in cycle) > 1:
                yield w, fault


@pytest.mark.parametrize("workload,fault", list(_faults()))
def test_a_broken_timed_path_is_not_correct(workload, fault):
    result = run(tiny(workload),
                 engine_factory=lambda rels, dev: _Broken(rels, dev, fault))
    assert not result["correct"]
    assert 0 < result["failed"] <= result["attempted"]
    bad = result["checks"]
    assert bad["mismatched_lines"]["value"] + bad["missing_lines"]["value"] \
        >= result["failed"]


def test_a_raising_request_counts_as_missing():
    class Raising:
        def __init__(self, rels, dev):
            self.calls = 0

        def run_batch(self, batch):
            self.calls += 1
            if self.calls > 12:            # past the warm pass's 12
                raise RuntimeError("planted")
            return ["0"] * len(batch)
    result = run(tiny("ssb_sf20.flight1"), engine_factory=Raising)
    assert not result["correct"]
    assert result["checks"]["missing_lines"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The cell's reference with its SUMs accumulated in float32 (the
    control), put in the program's place, fails the comparison."""
    cell = tiny(workload)
    result = run(cell, engine_factory=control(cell))
    assert not result["correct"]
    assert result["checks"]["mismatched_lines"]["value"] > 0


def test_trace_run_reports_the_per_layer_metrics_it_can_read():
    cell = tiny("ssb_sf20.flight1")
    result = harness.run_cell(cell, SEED, 0.2, True, CPU, 0.0)
    assert result["correct"]
    # a CPU run has no device capture: the device metrics say nothing
    assert set(result["metrics"]) == {"readbacks_per_query",
                                      "engine_build_s"}
    assert "busy_s" not in result["device"]


def test_capture_helpers():
    assert _union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3], [5, 9]]
    host = [(0, 100, "bench.run_batch"), (10, 20, "aten::sort"),
            (30, 40, "cudaLaunchKernel"), (200, 300, "bench.parse")]
    assert _host_at(host, [5, 15, 25, 35, 150, 250]) == [
        "bench.run_batch", "aten::sort", "bench.run_batch",
        "cudaLaunchKernel", None, "bench.parse"]


class _Event:
    """One event of a torch.profiler capture, as reduce_capture reads it."""

    def __init__(self, device, name, start, end, thread=1, annotation=False):
        self.dev, self.nm, self.s, self.e = device, name, start, end
        self.thread, self.annotation = thread, annotation

    def device_type(self):
        return self.dev

    def name(self):
        return self.nm

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def start_thread_id(self):
        return self.thread

    def is_user_annotation(self):
        return self.annotation


def test_csrc_seconds_cover_every_launch():
    """`csrc_s` sums each csrc kernel's device seconds by its LAUNCHES
    key over every launch in the window: both overloads of one
    `__global__` name under its key, a template or a library kernel
    under none, kernels outside the ten longest included."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    w0, w1 = 1_000, 1_000_000
    device, t = [], 2_000
    lib = [f"void at::native::kernel_{i}<long>(long*, long)"
           for i in range(12)]           # twelve longer than any below
    csrc = [("(anonymous namespace)::bincount_cached_kernel(int const*, "
             "int const*, long long, int*, int)", 300),
            ("(anonymous namespace)::bincount_cached_kernel(long long "
             "const*, long long const*, long long, long long*, int)", 200),
            ("(anonymous namespace)::gather_kernel(int const*, int, int "
             "const*, long long, int, int*)", 70),
            ("void (anonymous namespace)::gather_kernel<long>(long const*, "
             "long long)", 50),                          # a template: none
            ("void at::native::_scatter_gather_elementwise_kernel<128, 8>()",
             40),                                        # a library kernel
            ("Memcpy DtoH (Device -> Pinned)", 30)]
    for name, dur in [(n, 1_000) for n in lib] + csrc:
        device.append(_Event(cuda, name, t, t + dur))
        t += dur + 100
    device += [  # a launch across the window's start counts its share
        _Event(cuda, csrc[0][0], w0 - 400, w0 + 100),
        _Event(cuda, csrc[2][0], w1 + 10, w1 + 90),      # after the window
        _Event(cuda, "bench.run_batch", w0, w1, annotation=True)]
    host = [_Event(cpu, "bench.window", w0, w1),
            _Event(cpu, "bench.run_batch", w0 + 10, w1 - 10)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=(
        SimpleNamespace(events=lambda: device + host))))
    cap = reduce_capture(prof, "bench.window")
    assert cap["csrc_s"] == pytest.approx(
        {"bincount": 600e-9, "gather": 70e-9, "gather2": 0.0,
         "radix_hist": 0.0, "rank_hist": 0.0}, abs=1e-15)
    assert cap["csrc_kernels"] == 4
    assert cap["kernels"] == 18
    assert [n for n, _s in cap["device_ops"]] == [n[:120] for n in lib[:10]]
    assert cap["busy_s"] == pytest.approx((12_000 + 690 + 100) / 1e9)
    assert [n for n, _s in cap["idle_gaps"]] == ["bench.run_batch"]


def test_metric_readers(monkeypatch):
    """Every reader of the cell on a record whose program kept no spans:
    the span readers say nothing (their numbers: test_span_readers.py)."""
    monkeypatch.setattr(profiling, "span_totals", dict)
    cell = tiny("ssb_sf20.mixed")
    rec = {"queries": 50, "window_s": 2.0, "counters": {"readbacks": 5},
           "capture": {"kernels": 1000, "busy_s": 0.5, "csrc_kernels": 10},
           "capture_complete": True, "engine_build_s": 0.01}
    got = {name: read(rec) for name, read in cell.readers.items()}
    assert got == pytest.approx({
        "readbacks_per_query": 0.1, "launches_per_query": 20.0,
        "device_idle_share": 75.0, "engine_build_s": 0.01,
        "join_stream_ms_per_query": None, "filter_stream_ms_per_query": None,
        "aggregate_stream_ms_per_query": None,
        "host_dispatch_ms_per_query": None, "join_sort_live_share": None})
    rec.update(capture_complete=False)
    got = {name: read(rec) for name, read in cell.readers.items()}
    assert got["launches_per_query"] is None
    assert got["device_idle_share"] is None


@pytest.mark.parametrize("alone", [False, True])
def test_run_exits_without_a_card_and_prints_no_result(tmp_path, alone):
    """Without a card, and in a directory that holds only BENCHMARK.json
    and the benchmark (no program beside it), no result and exit != 0."""
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        shutil.copytree(os.path.join(ROOT, "benchmark"),
                        os.path.join(cwd, "benchmark"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), cwd)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ssb_sf20.mixed", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=cwd,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_files_import_neither_jax_nor_the_jax_package():
    """Nor do the references (benchmark/reference/) import the program."""
    reference = os.path.join(ROOT, "benchmark", "reference")
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "benchmark")):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                for ln in f:
                    words = ln.split()
                    if words[:1] in (["import"], ["from"]) and len(words) > 1:
                        top = words[1].split(".")[0]
                        assert top not in harness.FORBIDDEN, (name, ln)
                        assert top not in ("bench", "scripts"), (name, ln)
                        if dirpath.startswith(reference):
                            assert top != "radixhashjoin_tpu_torch", (name,
                                                                      ln)


def test_result_line_is_json():
    result = run(tiny("ssb_sf20.flight1"))
    result.pop("info")
    assert json.loads(json.dumps(result)) == result


def test_a_query_is_a_draw_of_a_template():
    """SSB's Q3.3 and Q3.4 send four sub-query lines as one request and
    count as one query each: every template weighs the same."""
    cell = tiny("ssb_sf20.mixed")
    cycle = generator.requests(cell.traffic, cell.schema.templates(
        cell.config, None), SEED)
    assert len(cycle) == sum(n for _l, _lines, n in cycle) == 26
    assert sum(len(lines) for _l, lines, _n in cycle) == 38
    result = run(cell, seconds=0.5)
    info = result["info"]
    assert info["queries_a_cycle"] == 26 and info["lines_a_cycle"] == 38
    assert result["attempted"] == info["requests_window"]
