"""One run of one cell: set-up, the measured window, the reference, the
comparison, and the result.

Set-up (timed from the process's start): the schema's generator makes
the relations from the seed; `storage.Relation` takes each column's
stats; `Engine` is built with the default `EngineConfig`; one warm pass
answers each distinct request of the traffic's cycle once, so that every
column the cycle reads is on the card and every kernel is built.

Window: one client, closed loop. A request is one batch of query lines
(a contest batch ended by F): the harness parses each line with
`workload.parse_query` and hands the batch to `Engine.run_batch`, which
returns the formatted lines after its readback. Requests follow the
cycle in order, again and again, until `seconds` have passed; the
window ends when the request in flight returns. With `trace`, the
window runs under torch.profiler and lasts whole cycles until
TRACE_SECONDS (or `seconds`, if shorter) have passed. A query is one
draw of a template (generator.py), however many lines it sends.

Then the peak device memory is read, the engine is freed, and the
configuration's reference (`cell.reference`: reference/semantics.py
unless the configuration names its own) answers each distinct request
once, on the same device; every line the window printed is compared with
the reference's line for its request (reference/compare.py).
"""

from __future__ import annotations

import gc
import statistics
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from . import generator
from .capture import reduce_capture
from .reference.compare import compare
from .spec import Cell, base_name

TRACE_SECONDS = 2.0
WINDOW_SPAN = "bench.window"
FORBIDDEN = ("jax", "jaxlib", "flax", "radixhashjoin_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run must not load,
    compared whole (radixhashjoin_tpu_torch is not radixhashjoin_tpu)."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def _log(msg: str) -> None:
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(engine, parse_query, cycle, seconds: float, whole_cycles: bool):
    """Closed loop over the cycle: (seconds elapsed, [(request index,
    lines or None, latency s)])."""
    done = []
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % len(cycle)
        start = time.perf_counter()
        try:
            with torch.profiler.record_function("bench.parse"):
                batch = [parse_query(ln) for ln in cycle[k][1]]
            with torch.profiler.record_function("bench.run_batch"):
                lines = engine.run_batch(batch)
        except Exception as e:            # a failed request counts as failed
            print(f"request {i} ({cycle[k][0]}) raised {e!r}",
                  file=sys.stderr)
            lines = None
        end = time.perf_counter()
        done.append((k, lines, end - start))
        i += 1
        if end - t0 >= seconds and (not whole_cycles or i % len(cycle) == 0):
            return end - t0, done


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             engine_factory: Optional[Callable] = None) -> dict:
    """The result of one run (the printed line's object, with "info" for
    the earlier line). `engine_factory(relations, device)` replaces the
    program's Engine (the controls and the tests' faults)."""
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.config import EngineConfig
    from radixhashjoin_tpu_torch.models.engine import Engine
    from radixhashjoin_tpu_torch.storage import Relation
    from radixhashjoin_tpu_torch.workload import parse_query

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
    t = time.perf_counter()
    columns = cell.schema.generate(cell.config, seed, device)
    for cols in columns:
        for c in cols:
            c.flags.writeable = False      # the program reads, never writes
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_gen = time.perf_counter()
    _log(f"generated in {t_gen - t:.2f} s")
    relations = [Relation(list(cols)) for cols in columns]
    t_stats = time.perf_counter()
    if engine_factory is None:
        engine = Engine(relations, EngineConfig(), device=device)
    else:
        engine = engine_factory(relations, device)
    _sync(device)
    t_engine = time.perf_counter()
    _log(f"stats {t_stats - t_gen:.2f} s, engine {t_engine - t_stats:.2f} s")
    cycle = generator.requests(
        cell.traffic, cell.schema.templates(cell.config, columns), seed)
    for _label, lines, _draws in cycle:
        engine.run_batch([parse_query(ln) for ln in lines])
    _sync(device)
    t_warm = time.perf_counter()
    _log(f"warm pass over {len(cycle)} requests {t_warm - t_engine:.2f} s")
    bex = getattr(engine, "batch_executor", None)
    info = {"workload": cell.name, "seed": seed,
            "route": bex.join.kind if bex is not None else None,
            "ftree_queries_warm": (bex.counters["ftree_queries"]
                                   if bex is not None else None),
            "requests_a_cycle": len(cycle),
            "queries_a_cycle": sum(r[2] for r in cycle),
            "lines_a_cycle": sum(len(r[1]) for r in cycle),
            "setup_split_s": {"generate": t_gen - t, "stats": t_stats - t_gen,
                              "engine": t_engine - t_stats,
                              "warm": t_warm - t_engine}}
    setup_s = time.perf_counter() - t_start

    counters0 = dict(bex.counters) if bex is not None else {}
    launches0 = dict(kernels.LAUNCHES)
    record = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                window_s, done = _window(engine, parse_query, cycle,
                                         min(seconds, TRACE_SECONDS), True)
            _sync(device)
        record = {"window_s": window_s,
                  "capture": reduce_capture(prof, WINDOW_SPAN)
                  if on_card else None}
        del prof
    else:
        window_s, done = _window(engine, parse_query, cycle, seconds, False)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    queries = sum(cycle[k][2] for k, _l, _t in done)
    if bex is not None:
        info["counters_window"] = {k: bex.counters[k] - counters0[k]
                                   for k in bex.counters}
    info["launches_window"] = {k: kernels.LAUNCHES[k] - launches0[k]
                               for k in kernels.LAUNCHES}
    info["requests_window"] = len(done)
    del engine, bex, relations
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    _log(f"window {window_s:.2f} s, {len(done)} requests")
    t_ref = time.perf_counter()
    ref = cell.reference(columns, device)
    want = {k: ref.lines(cycle[k][1]) for k in {k for k, _l, _t in done}}
    del ref
    checks, correct, failed = compare(
        [(want[k], lines) for k, lines, _t in done])
    info["reference_s"] = time.perf_counter() - t_ref

    result = {"correct": correct, "attempted": len(done), "failed": failed}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak}
    if trace:
        made = sum(info["launches_window"].values())
        record["capture_complete"] = (record["capture"] is not None and
                                      record["capture"]["csrc_kernels"] == made)
        record.update(queries=queries, requests=len(done),
                      counters=info.get("counters_window", {}),
                      launches=info["launches_window"],
                      engine_build_s=t_engine - t_stats)
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]](record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        cap = record["capture"]
        if cap is not None:
            device_info["busy_s"] = cap["busy_s"]
            device_info["window_s"] = window_s
            result["breakdown"] = {"device_ops": cap["device_ops"],
                                   "idle_gaps": cap["idle_gaps"]}
            info["capture"] = {k: cap[k] for k in ("kernels", "csrc_kernels",
                                                   "csrc_s")}
            info["capture"]["launches_counted"] = made
            if not record["capture_complete"]:
                print(f"the capture holds {cap['csrc_kernels']} csrc kernel "
                      f"launches, the program counted {made}: "
                      f"launches_per_query and device_idle_share are not "
                      f"reported", file=sys.stderr)
    else:
        lat = [s for _k, _l, s in done]
        metrics = {"queries_per_s": queries / window_s,
                   "request_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                   "peak_device_gb": peak / 1e9, "setup_s": setup_s}
        info["request_p50_ms"] = statistics.median(lat) * 1e3
        by_label = {}
        for k, _l, sec in done:
            by_label.setdefault(cycle[k][0], []).append(sec * 1e3)
        info["request_p50_ms_by_template"] = {
            label: statistics.median(v) for label, v in sorted(by_label.items())}
        metrics = {m["name"]: {"value": metrics[base_name(m["name"])],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks
    result["info"] = info
    return result
