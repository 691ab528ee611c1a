#!/usr/bin/env python3
"""On-card smoke run of radixhashjoin_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py          # from the repo root, one CUDA card

Phases (any failure raises and exits non-zero; nothing is swallowed):

  0. the card (nvidia-smi name + power limit), torch and CUDA versions;
  1. build the hand-written kernels (csrc/tables.cu, csrc/radix.cu)
     with nvcc, one process per source, started together;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes its path gives it: element-exact (torch.equal), timed with
     CUDA events (warm-up, then 20 launches of each) beside one PyTorch
     library call computing the same function (where one exists) and its
     bound (bytes moved over 3.35 TB/s); the build and lookup through
     bench_tables (Zipf and uniform 2^26-row builds, shared-memory-size
     tables, lookups into 2^20-, 2^18-, 48K- and 1024-entry tables); the
     rank kernel on uniform, one-hot, sorted-run and all-dead digits and
     on phase 4c's 2-bin binning at 2^25 digits; the
     partition and the 18-bit radix sort built on the rank kernel against
     torch.sort(stable=True), with every device op of a profiled call;
  3. the CLI on a synthetic catalog shaped like the contest's `small`
     set (14 relations, ~270K uint64 tuples, 50 tree-shaped queries in
     5 batches; the generators of radixhashjoin_tpu_torch/bench.py, which
     phases 3b-3d and 4c use too): once as a subprocess, once in-process
     through models/engine.main; both must print the lines of the port's
     NumPy oracle (oracle.py), and the in-process run must go through
     the build and lookup kernels;
  3b. the same catalog through `--no-batch` (the per-query executor):
     the 50 tree queries plus 20 queries the factorized wave does not
     plan (cycles, same-slot predicates, no joins), in two batches, as a
     subprocess and in-process; every line equals the oracle's and the
     tree queries' lines equal the batch path's;
  3c. the same 70 queries through the default CLI (the batch path): as
     a subprocess and in-process, lines equal to the oracle's and to
     `--no-batch`'s; 50 queries in the factorized wave, 20 as
     materialized stage ops, none on the per-query executor;
  3d. the same 70 queries under every engine setting and CLI flag: the
     default CLI through the C++ host runtime (runtime/native, its
     library built at first use and used), --no-native, --oracle,
     --profile (its per-operator table, shares at most 100%), --backend
     sort and --reorder-joins as subprocesses started together, then
     stage_group 1, 8 and 64, ftree_wave=False and defer_middle=False
     in-process with their dispatches and launches and a sync check;
     every line equals the oracle's. Then native against Python load and
     parse seconds (this catalog, and a star of phase 4's shape written
     to files), and the A/B of warm walls: one round, 64-query rounds
     and per-query ftree ops, in turns, ten runs each;
  4. data scale through Engine.run_workload: a Zipf(1.1) fact of 2^27
     rows over 2^20 keys joined with a 2^20-row dimension, and a star of
     a 2^24-row fact with two 2^20-row dimensions, each against its
     closed-form NumPy oracle (data and oracle from bench_scale's
     zipf_join and star); the star again through the per-query
     executor and through the batch path's materialized fallback (the
     dense fused stage with factorized=False, and the sort backend's
     per-op path), and a cyclic triangle of 2^20-row relations
     through the per-query executor and the batch path, against the
     port's oracle. The fallback runs print their stage ops, readbacks,
     dispatches, launches, peak memory and top device ops, and count the
     synchronizing calls of a warm run under
     torch.cuda.set_sync_debug_mode("warn"): none inside a round, one
     per readback in all;
  4b. huge nodes, past the 2^28-row threshold of the windowed pass
     (ops/factorized.py _fused_node_pass), through Engine.run_workload:
     the Zipf join at 2^29 + 12345 fact rows and the star of
     scripts/bench_scale.py:315-349 (Zipf key 1, uniform key 2) at
     2^29 + 4099 (bench_scale's zipf_join and star_big), each loaded
     through storage.Relation (its load-time stats and the oracle included
     in the set-up time) and held against its closed-form oracle: first
     run and three warm walls, tuples/s, peak memory, launches (the
     build and lookup at least once a window), the sync check, the top
     device ops, and the warm wall against the bound of the bytes the
     window pass reads (6 and 10 B a fact row over
     3.35 TB/s);
  4c. the distributed layer (radixhashjoin_tpu_torch/parallel/) in a
     world of one NCCL rank, this process, on phase 4's relations: the
     Zipf join through the DistExecutor's factorized wave, through the
     exchange pipeline at the default skew_heavy_fraction (its one digit
     is heavy: the all_gather broadcast) and at 1.0 (the all_to_all
     exchange), and the star through case 1, case 2 and the projections,
     each against its closed-form oracle with its readbacks and
     collectives a query, launches (the rank kernel bins every exchange
     and gather), peak memory and top device ops; then phase 3c's 70
     queries through `--mesh 1` (a subprocess) and the same per-rank
     program in-process (50 queries in one wave, 20 exchanged), and
     through two gloo ranks sharing the card;
  5. the kernel shootout, `bench_kernels --log-rows 26`, in-process:
     its lines, and the launches of its run (the radix histogram's only
     path; the rank kernel's launches in the kernels line are phases 4c
     and 6's);
  6. the port's bench entry points, each through its main(argv, out) as
     a user runs it, every line exact: bench_scale (the three dense
     probes at 2^26 rows a side, the star and the small-dimension star at
     2^24 fact rows, the Zipf join and the big star at 2^24, the
     skew-aware distributed join at 2^24 rows in a world of one NCCL
     rank); the two-deep chain fact1 ⋈ fact2 ⋈ dim at 2^28 + 4097 rows a
     fact, both facts huge nodes, measured as phase 4b's cells (launches
     of its first run, peak memory, no synchronizing call inside its
     round) with bench_scale's metric line; the 70-query bench twin
     (bench.py); bench_planner at 2^18 / 2^14 and 2^20 / 2^16 rows /
     distinct keys; bench_microops. Each run's launches are counted from
     0 (a bench_scale config's exactness run, the chain's first run, the
     twin's cold pass, the planner's first run of each order) and join
     the kernels line; each dense probe, engine config, the chain and the
     twin must launch the build and lookup, the skew join the rank
     kernel. The planner's per-query path joins with the sort probe and
     launches none; the timed calls and bench_microops' timing loops are
     not counted;
  7. the rest of the distributed layer, its pipelined chunk loops and
     entry points: bench_dist_scale at 2^26 rows a rank in a world of one
     NCCL rank (the 2^26-row star through the d_ftree wave, two 2^26-row
     permutation sides through the case-1 exchange and d_project, each
     exact, with each operator's argument, output and peak bytes and the
     gcap against worst-case lines); scale_efficiency at 2^22 rows a side
     with N = 1 (NCCL) and N = 2 (gloo ranks sharing the card), exact;
     then phase 4c's dist_zipf_exchange and dist_star_exchange cells at
     K = 1 and K = 4 chunks (exchange, gather and broadcast), exact, their
     warm walls in alternating pairs; one warm K = 4 d_case1_probe of the
     Zipf cell profiled, which must show NCCL's device work (a kernel;
     in a world of one, a device-to-device copy on NCCL's stream)
     overlapping a compute-stream kernel on another stream, and the Zipf
     cell's
     exchange round (d_case1_probe, d_case1_expand, d_project) under the
     sync debug mode with 0 synchronizing calls. The launches of every
     exactness run (bench_dist_scale's configs, rank 0 of each
     scale_efficiency world, the cells' first runs) join the kernels line:
     the build and lookup on each ftree run, the rank kernel and lookup on
     each exchange.

Prints the kernels' JSON summary, the card's name and power limit, then
as its last line {"ok": true, "device": {...}}. Without a CUDA card it
exits 2 and prints no result; where the package is missing its import
fails and it exits 1.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# BASELINE config 4 asks for >= 100M fact rows: 2^27 (134M) meets it and
# stays below the 2^28-row huge-node threshold, so the ported non-huge
# wave runs; the star keeps scripts/bench_scale.py's 2^24-row fact
ZIPF_ROWS = 1 << 27
STAR_ROWS = 1 << 24
DIM_KEYS = 1 << 20
TRIANGLE_ROWS = 1 << 20
SHOOTOUT_LOG_ROWS = 26
# phase 4b: past the 2^28-row huge-node threshold, ragged tails
HUGE_ZIPF_ROWS = (1 << 29) + 12345
HUGE_STAR_ROWS = (1 << 29) + 4099
# phase 6: the port's bench entry points; the two-deep chain with both
# facts past the 2^28-row threshold (exactly 2^28 would not be past it)
BENCH_SCALE_ARGV = ["--rows", "26", "--skew", "--skew-rows", str(1 << 24),
                    "--devices", "1", "--zipf-engine", "--zipf-rows", "24",
                    "--star-rows", "24"]
CHAIN_ROWS = (1 << 28) + 4097
PLANNER_ARGVS = ([], ["--log-rows", "20", "--log-distinct", "16"])

# phase 7: the distributed entry points; the K = 1 / K = 4 walls in
# AB_PAIRS alternating pairs a cell
DIST_SCALE_ARGV = ["--rows-per-chip", "26", "--devices", "1"]
SCALE_EFF_ARGV = ["--rows", "22", "--ns", "1,2"]
DIST_AB_PAIRS = 5

# the factorized wave's kernels; the radix kernels run on the shootout
WAVE_KERNELS = ("bincount", "gather")


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _time_ms(fn) -> float:
    """CUDA-event mean of 20 calls after 3 warm-up calls."""
    from radixhashjoin_tpu_torch.bench_kernels import time_ms
    return time_ms(fn, iters=20)


def _max_abs_err(a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


# ---- phase 2: kernels vs their plain versions ----

def phase_kernels(dev):
    """The build and lookup at the main path's shapes through
    bench_tables (exact, then kernel, plain, library and bound), a few
    untimed edge shapes, then the radix kernels."""
    import torch
    from radixhashjoin_tpu_torch import bench_tables, kernels
    from radixhashjoin_tpu_torch.ops.tables import (table_gather_torch,
                                                    weighted_bincount_torch)
    errs = {"bincount": 0, "gather": 0}
    timed = {}
    for row in bench_tables.run(dev, out=None):
        errs[row["kernel"]] = max(errs[row["kernel"]], row["max_abs_err"])
        if row["main"]:
            timed[row["kernel"]] = row
        print(json.dumps(row))

    gen = torch.Generator(device=dev).manual_seed(0)

    def check(name, got, want, shape):
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {shape}: kernel != plain "
                                 f"(max abs err {err})")
        print(json.dumps({"kernel": name, "case": shape, "exact": True}))

    for n, bins in ((5000, 700), (1, 700), (0, 700)):
        idx = torch.randint(0, bins + 1, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        w = torch.randint(0, 1 << 20, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        check("bincount", kernels.weighted_bincount_cuda(idx, w, bins),
              weighted_bincount_torch(idx, w, bins), f"n={n} bins={bins}")
    # the huge-node pass builds window by window into a running table: a
    # 2^26-row Zipf window (phase 4b's) into a nonzero 2^20-bin table
    bins = DIM_KEYS
    idx = bench_tables.zipf_keys(gen, 1 << 26, bins, dev)
    w = torch.randint(0, 100, (1 << 26,), generator=gen, device=dev,
                      dtype=torch.int32)
    acc = torch.randint(0, 1 << 20, (bins,), generator=gen, device=dev,
                        dtype=torch.int32)
    want = acc + weighted_bincount_torch(idx, w, bins)
    check("bincount", kernels.weighted_bincount_cuda(idx, w, bins, out=acc),
          want, f"n=2^26 Zipf bins={bins} into a nonzero accumulator")
    del idx, w, acc, want
    table = torch.randint(-2**31, 2**31 - 1, (1000,), generator=gen,
                          device=dev, dtype=torch.int32)
    for n, b in ((1, 77), (1001, 77), (4097, 1000), (0, 77)):
        t = table[:b].contiguous()
        k = torch.randint(-3, b + 3, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        check("gather", kernels.table_gather_cuda(t, k),
              table_gather_torch(t, k), f"n={n} bins={b}")
    timed.update(_phase_radix_kernels(dev, gen, errs))
    return timed, errs


def _phase_radix_kernels(dev, gen, errs):
    """The radix histogram and rank kernels against their plain
    versions, and the partition and radix sort built on the rank kernel
    against torch.sort(stable=True)."""
    import torch
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.bench_tables import bound_ms
    from radixhashjoin_tpu_torch.ops.partition import (partition_order,
                                                       radix_sort_order,
                                                       rank_and_hist_torch)
    from radixhashjoin_tpu_torch.ops.radix_hist import radix_histogram_torch
    errs.update({"radix_hist": 0, "rank_hist": 0})
    rows = {}

    def report(name, label, pairs, kernel_fn, plain_fn, profile=0,
               library=None, n_bytes=None):
        """`library`: (call, fn) or (None, reason); `n_bytes`: what the
        function must move, for bound_ms; `profile`: how many of the
        device ops of a profiled call to list (0: no profile)."""
        err = max(_max_abs_err(g, w) for g, w in pairs)
        errs[name] = max(errs.get(name, 0), err)
        if not all(torch.equal(g, w) for g, w in pairs):
            raise AssertionError(f"{name} {label}: kernel != plain "
                                 f"(max abs err {err})")
        row = {"kernel": name, "case": label, "exact": True,
               "ms": _time_ms(kernel_fn), "plain_ms": _time_ms(plain_fn)}
        if library is not None:
            call, fn = library
            row["library_call"] = call if call else fn
            row["library_ms"] = _time_ms(fn) if call else None
        if n_bytes is not None:
            row["bound_ms"] = bound_ms(n_bytes)
            row["bound_by"] = "bytes"
        if profile:
            row["device_profile"] = _profile(kernel_fn, top=profile)
        print(json.dumps(row))
        return row

    # the shootout's histogram: 2^26 values into 256 bins, the last
    # 12345 lanes padding
    n, bins = 1 << 26, 256
    count = n - 12345
    vals = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                         device=dev, dtype=torch.int32)
    got = kernels.radix_histogram_cuda(vals, count, bins)
    want = radix_histogram_torch(vals, count, bins)
    torch.cuda.synchronize()
    masked = vals[:count] & (bins - 1)          # the yardstick's input
    rows["radix_hist"] = report(
        "radix_hist", f"n=2^26 count=2^26-12345 bins={bins}",
        [(got, want)],
        lambda: kernels.radix_histogram_cuda(vals, count, bins),
        lambda: radix_histogram_torch(vals, count, bins),
        library=("torch.bincount(minlength=n_bins) on the masked prefix",
                 lambda: torch.bincount(masked, minlength=bins)),
        n_bytes=count * 4 + bins * 4)
    del vals, masked

    # rank kernel at the shapes the partition (256 digits + the dead
    # bin) and the 18-bit radix sort (9-bit digits) give it, uniform over
    # [0, bins] (bins itself being the dead digit, ranked but not
    # counted), then skewed: one hot digit, sorted runs, all dead
    n = 1 << 24
    for dist, bins in (("uniform", 257), ("uniform", 513), ("hot", 257),
                       ("runs", 257), ("dead", 257)):
        if dist in ("uniform", "runs"):
            digits = torch.randint(0, bins + 1, (n,), generator=gen,
                                   device=dev, dtype=torch.int32)
            if dist == "runs":
                digits = torch.sort(digits).values
        else:
            digits = torch.full((n,), bins if dist == "dead" else bins // 2,
                                dtype=torch.int32, device=dev)
        got = kernels.rank_hist_cuda(digits, bins)
        want = rank_and_hist_torch(digits, bins)
        torch.cuda.synchronize()
        row = report("rank_hist", f"n=2^24 {dist} digits in [0, {bins}]",
                     list(zip(got, want)),
                     lambda: kernels.rank_hist_cuda(digits, bins),
                     lambda: rank_and_hist_torch(digits, bins),
                     library=(None, "none: no PyTorch call computes "
                              "per-block stable ranks and block histograms;"
                              " torch.sort(stable=True) is its consumers' "
                              "yardstick (partition_order row)"),
                     n_bytes=n * 8 + -(-n // kernels.RANK_BLOCK) * bins * 4)
        rows.setdefault("rank_hist", row)
    # the distributed layer's binning in a world of one (phase 4c): a
    # 2^25-lane gather chunk's digits, 0 for the rank and 1 for dead
    # lanes, which partition_order ranks with n_bins = 2
    n_d = 1 << 25
    digits = torch.randint(0, 2, (n_d,), generator=gen, device=dev,
                           dtype=torch.int32)
    got = kernels.rank_hist_cuda(digits, 2)
    want = rank_and_hist_torch(digits, 2)
    torch.cuda.synchronize()
    report("rank_hist", "n=2^25 digits in [0, 1], n_bins=2 (phase 4c's "
           "binning)", list(zip(got, want)),
           lambda: kernels.rank_hist_cuda(digits, 2),
           lambda: rank_and_hist_torch(digits, 2),
           library=(None, "none: see the 2^24 rows"),
           n_bytes=n_d * 8 + -(-n_d // kernels.RANK_BLOCK) * 2 * 4)
    del digits, got, want

    keys = torch.randint(0, 1 << 18, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    digits = keys & 255
    want = torch.sort(digits, stable=True).indices.to(torch.int32)
    report("partition_order", "n=2^24 256 digits vs torch.sort(stable)",
           [(partition_order(digits, 256)[0], want)],
           lambda: partition_order(digits, 256),
           lambda: torch.sort(digits, stable=True), profile=16)
    want = torch.sort(keys, stable=True).indices.to(torch.int32)
    report("radix_sort_order",
           "n=2^24 18-bit keys, 9-bit digits vs torch.sort(stable)",
           [(radix_sort_order(keys, 18, 9), want)],
           lambda: radix_sort_order(keys, 18, 9),
           lambda: torch.sort(keys, stable=True), profile=16)
    return rows


# ---- phase 3: the CLI on a contest-shaped synthetic catalog ----

def phase_cli(dev):
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.bench import contest_catalog
    from radixhashjoin_tpu_torch.config import EngineConfig
    from radixhashjoin_tpu_torch.models.engine import main
    from radixhashjoin_tpu_torch.oracle import run_workload
    from radixhashjoin_tpu_torch.storage import load_relation
    from radixhashjoin_tpu_torch.workload import parse_work_stream

    rels, work = contest_catalog()
    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_catalog(tmp, rels)
        stream = "\n".join(paths + ["Done"] + work) + "\n"
        t0 = time.perf_counter()
        loaded = [load_relation(p) for p in paths]
        want = run_workload(loaded, parse_work_stream(work))
        oracle_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "radixhashjoin_tpu_torch", "--device",
             dev.type], input=stream, capture_output=True, text=True,
            cwd=REPO, timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI exit {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        if proc.stdout.splitlines() != want:
            raise AssertionError("CLI lines differ from the oracle's")

        # the main path's run: counts from zero, in-process
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        engine = main(io.StringIO(stream), out, EngineConfig(), device=dev)
        first_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if out.getvalue().splitlines() != want:
            raise AssertionError("in-process lines differ from the oracle's")
        # the wave's build and lookup; the radix kernels are not on it
        if dev.type == "cuda" and min(launches[k] for k in WAVE_KERNELS) == 0:
            raise AssertionError(f"main path skipped a kernel: {launches}")
        counters = dict(engine.batch_executor.counters)
        batches = parse_work_stream(work)
        t0 = time.perf_counter()
        again = engine.run_workload(batches)
        warm_s = time.perf_counter() - t0
        if again != want:
            raise AssertionError("warm rerun differs from the oracle")
        profile = (_profile(lambda: engine.run_workload(batches))
                   if dev.type == "cuda" else "not measured")
    n_null = sum(line.startswith("NULL") for line in want)
    print(json.dumps({
        "phase": "cli", "queries": len(want), "null_lines": n_null,
        "tuples": int(sum(len(c[0]) for c in rels)),
        "lines_equal_oracle": True, "cli_subprocess_s": cli_s,
        "inprocess_first_s": first_s, "inprocess_warm_s": warm_s,
        "oracle_s": oracle_s, "counters": counters,
        "launches": launches, "device_profile": profile}))
    return launches


def _write_catalog(tmp, rels):
    """Each relation's columns written to tmp/r<i>; the paths."""
    from radixhashjoin_tpu_torch.storage import write_relation
    paths = []
    for i, cols in enumerate(rels):
        paths.append(os.path.join(tmp, f"r{i}"))
        write_relation(paths[-1], cols)
    return paths


def _contest_files(tmp, dev):
    """Phase 3c's workload over phase 3's catalog written under tmp:
    (paths, the relations loaded back, the 50 tree queries' lines, the
    70-query work stream, the fallback queries' kinds); the fallback
    queries are those the default engine's tree planner leaves out."""
    from radixhashjoin_tpu_torch import bench
    from radixhashjoin_tpu_torch.config import EngineConfig
    from radixhashjoin_tpu_torch.models.engine import Engine
    from radixhashjoin_tpu_torch.storage import load_relation
    rels, tree = bench.contest_catalog()
    paths = _write_catalog(tmp, rels)
    loaded = [load_relation(p) for p in paths]
    planner = Engine(loaded, EngineConfig(), device=dev).batch_executor
    extra, kinds = bench.fallback_queries(rels, planner)
    return paths, loaded, tree, bench.contest_work(tree, extra), kinds


# ---- phase 3b: the per-query path (--no-batch) on the same catalog ----

def phase_fallback_cli(dev):
    """The contest-shaped catalog's 50 tree queries plus 20 queries the
    factorized wave does not plan, in two batches: through `--no-batch`
    (phase 3b) and through the default batch path (phase 3c), each as a
    subprocess and in-process. Every line equals the oracle's, the two
    paths' lines are equal, and the batch path answers all 70 itself:
    50 in its factorized wave, 20 as materialized stage ops, none on the
    per-query executor."""
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.config import EngineConfig
    from radixhashjoin_tpu_torch.models.engine import Engine, main
    from radixhashjoin_tpu_torch.oracle import run_workload
    from radixhashjoin_tpu_torch.workload import parse_work_stream

    with tempfile.TemporaryDirectory() as tmp:
        paths, loaded, tree, work, kinds = _contest_files(tmp, dev)
        batch_engine = Engine(loaded, EngineConfig(), device=dev)
        batches = parse_work_stream(work)
        t0 = time.perf_counter()
        want = run_workload(loaded, batches)
        oracle_s = time.perf_counter() - t0
        batch_lines = batch_engine.run_workload(parse_work_stream(tree))
        if batch_lines != want[:len(batch_lines)]:
            raise AssertionError("batch path differs from the oracle on "
                                 "the tree queries")
        stream = "\n".join(paths + ["Done"] + work) + "\n"
        lines = {}
        for label, args, cfg in (
                ("no_batch_cli", ["--no-batch"],
                 EngineConfig(batch_execution=False)),
                ("default_cli", [], EngineConfig())):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "radixhashjoin_tpu_torch", "--device",
                 dev.type, *args], input=stream, capture_output=True,
                text=True, cwd=REPO, timeout=600)
            cli_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"{label} CLI exit {proc.returncode}:"
                                     f"\n{proc.stderr[-4000:]}")
            if proc.stdout.splitlines() != want:
                raise AssertionError(f"{label} CLI lines differ from the "
                                     f"oracle's")
            # the in-process run: kernel counts from zero
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            engine = main(io.StringIO(stream), out, cfg, device=dev)
            first_s = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            got = out.getvalue().splitlines()
            if got != want:
                raise AssertionError(f"in-process {label} lines differ "
                                     f"from the oracle's")
            if got[:len(batch_lines)] != batch_lines:
                raise AssertionError(f"{label} tree lines differ from the "
                                     f"batch path's")
            lines[label] = got
            executor = dict(engine.executor.counters)
            batch = (dict(engine.batch_executor.counters)
                     if engine.batch_executor is not None else None)
            warm = []
            for _ in range(3):
                t0 = time.perf_counter()
                if engine.run_workload(batches) != want:
                    raise AssertionError(f"{label} warm rerun differs")
                warm.append(time.perf_counter() - t0)
            row = {
                "phase": label, "queries": len(want),
                "tree_queries": len(batch_lines),
                "fallback_queries": {k: kinds.count(k) for k in set(kinds)},
                "null_lines": sum(ln.startswith("NULL") for ln in want),
                "lines_equal_oracle": True,
                "tree_lines_equal_batch_path": True,
                "cli_subprocess_s": cli_s, "inprocess_first_s": first_s,
                "inprocess_warm_s": warm, "oracle_s": oracle_s,
                "counters": executor if batch is None else batch,
                "launches": launches}
            if batch is not None:
                # every query on the batch path: 50 in the wave, none on
                # the per-query executor
                if batch["ftree_queries"] != len(batch_lines):
                    raise AssertionError(f"ftree queries {batch}")
                if executor["queries"] != 0:
                    raise AssertionError(f"per-query executor ran {executor}")
                if dev.type == "cuda" and min(launches[k]
                                              for k in WAVE_KERNELS) == 0:
                    raise AssertionError(f"{label} skipped a kernel: "
                                         f"{launches}")
                row["torch_executor_queries"] = executor["queries"]
                row["lines_equal_no_batch"] = got == lines["no_batch_cli"]
                if not row["lines_equal_no_batch"]:
                    raise AssertionError("default and --no-batch lines "
                                         "differ")
                if dev.type == "cuda":
                    row["device_profile"] = _profile(
                        lambda: engine.run_workload(batches))
            print(json.dumps(row))
    return lines["default_cli"]


# ---- phase 3d: every engine setting and CLI flag on the same catalog ----

# warm runs of each A/B configuration, in turns (forward, then backward)
AB_RUNS = 10

# the CLI's entry point with its argv, printing the kernel wrappers'
# launch counts to stderr when the process ends
_CLI_WITH_LAUNCHES = (
    "import atexit, json, sys\n"
    "from radixhashjoin_tpu_torch import kernels\n"
    "from radixhashjoin_tpu_torch.__main__ import cli\n"
    "atexit.register(lambda: print('LAUNCHES ' + json.dumps("
    "kernels.LAUNCHES), file=sys.stderr))\n"
    "sys.argv = ['radixhashjoin_tpu_torch'] + sys.argv[1:]\n"
    "cli()\n")


def _profile_table(stderr):
    """The rows of the --profile table on a CLI's stderr: [(operator,
    calls, seconds, GB/s, share or None)]."""
    rows, inside = [], False
    for ln in stderr.splitlines():
        if ln.startswith("operator") and "% roof" in ln:
            inside = True
            continue
        if inside and ln.startswith("TOTAL"):
            return rows
        if inside:
            name, calls, sec, gbs, roof = ln.split()
            rows.append((name, int(calls), float(sec), float(gbs),
                         None if roof == "-" else float(roof[:-1]) / 100))
    raise AssertionError(f"no --profile table on stderr:\n{stderr[-2000:]}")


def _native_vs_python(paths, text=None):
    """Load (relations and their stats) and parse (of `text`, if given)
    seconds through the C++ host runtime and through storage.py /
    workload.py, in turns (native, Python, native, Python); every
    relation's columns and stats and every query equal."""
    import dataclasses

    from radixhashjoin_tpu_torch.runtime import native
    from radixhashjoin_tpu_torch.storage import load_relation
    from radixhashjoin_tpu_torch.workload import parse_work_stream

    out = {"native_load_s": [], "python_load_s": [], "native_parse_s": [],
           "python_parse_s": []}
    for _ in range(2):
        t0 = time.perf_counter()
        nat = [native.load_relation_native(p) for p in paths]
        out["native_load_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        py = [load_relation(p) for p in paths]
        out["python_load_s"].append(time.perf_counter() - t0)
        if text is None:
            continue
        t0 = time.perf_counter()
        qn = native.parse_work_native(text)
        out["native_parse_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        qp = parse_work_stream(text.splitlines(True))
        out["python_parse_s"].append(time.perf_counter() - t0)
    for a, b in zip(nat, py):
        if ([dataclasses.astuple(s) for s in a.stats]
                != [dataclasses.astuple(s) for s in b.stats]
                or any(not np.array_equal(x, y)
                       for x, y in zip(a.values, b.values))):
            raise AssertionError(f"native and Python loads differ: {a.path}")

    if text is None:
        return {k: v for k, v in out.items() if v}

    def fields(batches):
        return [[(q.slots, q.joins, q.filters, q.projections) for q in b]
                for b in batches]
    if fields(qn) != fields(qp):
        raise AssertionError("native and Python parses differ")
    return out


def phase_settings_cli(dev):
    """Phase 3c's 70 queries under every engine setting and CLI flag:
    the default CLI (the C++ host runtime's loader, parser and formatter,
    its library built from runtime/native/rhj_host.cpp and used),
    --no-native, --oracle, --profile, --backend sort and --reorder-joins
    as subprocesses started together, then in-process stage_group 1, 8
    and 64, ftree_wave=False and defer_middle=False. Every line equals
    the port's oracle (the reordered queries' under --reorder-joins);
    every run but the oracle's and the sort backend's (whose per-op path
    runs neither) launches the build and lookup kernels. Then native
    against Python load and parse seconds, on this catalog and on a star
    of phase 4's shape written to files, and the A/B of warm walls: one
    round against stage_group=64 and ftree_wave=False, interleaved.
    Returns the in-process and subprocess runs' launches, summed."""
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.config import EngineConfig
    from radixhashjoin_tpu_torch.models.engine import Engine, main
    from radixhashjoin_tpu_torch.models.planner import reorder_joins
    from radixhashjoin_tpu_torch.oracle import run_workload
    from radixhashjoin_tpu_torch.runtime import native
    from radixhashjoin_tpu_torch.storage import write_relation
    from radixhashjoin_tpu_torch.workload import parse_work_stream

    total = {k: 0 for k in kernels.LAUNCHES}

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    with tempfile.TemporaryDirectory() as tmp:
        paths, loaded, tree, work, _kinds = _contest_files(tmp, dev)
        text = "\n".join(work) + "\n"
        batches = parse_work_stream(work)
        want = run_workload(loaded, batches)
        want_reordered = run_workload(
            loaded, [[reorder_joins(q, loaded) for q in b] for b in batches])
        stream = "\n".join(paths + ["Done"]) + "\n" + text

        # the CLI's flags, each a process of its own, started together
        flag_sets = {"default": [], "no_native": ["--no-native"],
                     "oracle": ["--oracle"], "profile": ["--profile"],
                     "backend_sort": ["--backend", "sort"],
                     "reorder_joins": ["--reorder-joins"]}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-c", _CLI_WITH_LAUNCHES, "--device", dev.type,
             *flags], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=REPO)
            for name, flags in flag_sets.items()}
        results = {name: p.communicate(stream, timeout=600)
                   for name, p in procs.items()}
        cli_s = time.perf_counter() - t0
        runs = {}
        for name, (out, err) in results.items():
            if procs[name].returncode != 0:
                raise AssertionError(f"CLI {flag_sets[name]} exit "
                                     f"{procs[name].returncode}:\n"
                                     f"{err[-4000:]}")
            expect = want_reordered if name == "reorder_joins" else want
            if out.splitlines() != expect:
                raise AssertionError(f"CLI {flag_sets[name]} lines differ "
                                     f"from the oracle's")
            tag = [ln for ln in err.splitlines()
                   if ln.startswith("LAUNCHES ")]
            launches = json.loads(tag[-1][len("LAUNCHES "):])
            kernel_run = name not in ("oracle", "backend_sort")
            if (dev.type == "cuda" and kernel_run
                    and min(launches[k] for k in WAVE_KERNELS) == 0):
                raise AssertionError(f"CLI {flag_sets[name]} skipped a "
                                     f"kernel: {launches}")
            if name == "oracle" and any(launches.values()):
                raise AssertionError(f"--oracle launched kernels: "
                                     f"{launches}")
            add(launches)
            runs[name] = {"flags": flag_sets[name], "launches": launches}
        profile = _profile_table(results["profile"][1])
        if not profile or any(r[4] is not None and r[4] > 1.0
                              for r in profile):
            raise AssertionError(f"--profile shares: {profile}")
        if dev.type == "cuda" and any(r[4] is None for r in profile):
            raise AssertionError(f"--profile table without shares on "
                                 f"{dev}: {profile}")
        # the default CLI's library: built from runtime/native's source in
        # this run or an earlier one
        lib = native.library_path()
        if not os.path.exists(lib):
            raise AssertionError(f"the native library {lib} was not built")
        print(json.dumps({
            "phase": "settings_cli", "queries": len(want),
            "lines_equal_oracle": True, "subprocesses_s": cli_s,
            "native_library": os.path.relpath(lib, REPO),
            "native_source": os.path.relpath(native.SOURCE, REPO),
            "runs": runs,
            "profile_table": [{"operator": r[0], "calls": r[1],
                               "seconds": r[2], "gb_per_s": r[3],
                               "roofline_share": r[4]} for r in profile]}))

        # in-process: the default (the library used), then each setting
        configs = {"default": EngineConfig(),
                   "stage_group1": EngineConfig(stage_group=1),
                   "stage_group8": EngineConfig(stage_group=8),
                   "stage_group64": EngineConfig(stage_group=64),
                   "no_ftree_wave": EngineConfig(ftree_wave=False),
                   "no_defer_middle": EngineConfig(defer_middle=False)}
        rows = {}
        engines = {}
        for name, cfg in configs.items():
            calls = dict(native.CALLS)
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            eng = main(io.StringIO(stream), out, cfg, device=dev)
            first_s = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            if out.getvalue().splitlines() != want:
                raise AssertionError(f"in-process {name} lines differ from "
                                     f"the oracle's")
            used = {k: native.CALLS[k] - calls[k] for k in calls}
            if used != {"load": len(paths), "parse": 1, "format": 1}:
                raise AssertionError(f"{name}: native runtime calls {used}")
            if dev.type == "cuda" and min(launches[k]
                                          for k in WAVE_KERNELS) == 0:
                raise AssertionError(f"in-process {name} skipped a kernel: "
                                     f"{launches}")
            add(launches)
            counters = dict(eng.batch_executor.counters)
            if counters["ftree_queries"] != len(tree) - tree.count("F"):
                raise AssertionError(f"{name}: counters {counters}")
            rows[name] = {"first_s": first_s, "launches": launches,
                          "counters": counters,
                          "dispatches": counters["dispatches"],
                          "native_calls": used}
            engines[name] = eng
        row = {"phase": "settings_inprocess", "queries": len(want),
               "lines_equal_oracle": True, "runs": rows}
        if dev.type == "cuda":
            # profile=False: no synchronizing call inside a round
            eng = engines["stage_group8"]
            row["sync_check_stage_group8"] = _sync_check(
                eng, lambda: eng.run_workload(batches))
        print(json.dumps(row))

        # the A/B: warm walls, one round against 64-query rounds and
        # per-query ftree ops, in turns
        ab = {"one_round": EngineConfig(stage_group=None),
              "stage_group64": EngineConfig(stage_group=64),
              "no_ftree_wave": EngineConfig(ftree_wave=False)}
        ab_eng = {name: Engine.from_paths(paths, cfg, device=dev)
                  for name, cfg in ab.items()}
        for eng in ab_eng.values():
            if eng.run_workload(batches) != want:
                raise AssertionError("A/B warm-up differs")
        walls = {name: [] for name in ab}
        for r in range(AB_RUNS):
            order = list(ab_eng.items())
            for name, eng in (order if r % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                got = eng.run_workload(batches)
                walls[name].append(time.perf_counter() - t0)
                if got != want:
                    raise AssertionError(f"A/B {name} differs")
        med = {name: float(np.median(w)) for name, w in walls.items()}
        iqr = {name: float(np.subtract(*np.percentile(w, [75, 25])))
               for name, w in walls.items()}
        print(json.dumps({
            "phase": "settings_ab", "queries": len(want), "warm_s": walls,
            "median_s": med, "interquartile_s": iqr,
            "stage_group64_no_slower": med["stage_group64"]
            <= med["one_round"]}))

        # native against Python host time: this catalog, then a star of
        # phase 4's shape (a 2^24-row fact, two 2^20-row dimensions)
        loads = {"contest": _native_vs_python(paths, text)}
        srng = np.random.default_rng(24)
        n, k = STAR_ROWS, DIM_KEYS
        star = [[srng.integers(0, k, n).astype(np.uint64),
                 srng.integers(0, k, n).astype(np.uint64),
                 srng.integers(0, 1000, n).astype(np.uint64)]]
        star += [[np.arange(k, dtype=np.uint64),
                  srng.integers(0, 1000, k).astype(np.uint64)]
                 for _ in range(2)]
        star_paths = []
        for i, cols in enumerate(star):
            star_paths.append(os.path.join(tmp, f"star{i}"))
            write_relation(star_paths[-1], cols)
        del star
        loads["star_2_24"] = _native_vs_python(star_paths)
        print(json.dumps({"phase": "native_vs_python", **loads}))
    return total


# ---- phase 4: data scale ----

def _scale_run(name, rels, q, expected, n_tuples, dev):
    import torch
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.config import EngineConfig
    from radixhashjoin_tpu_torch.models.engine import Engine

    before = dict(kernels.LAUNCHES)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = Engine(rels, EngineConfig(), device=dev)
    t0 = time.perf_counter()
    got = eng.run_workload([[q]])
    first_s = time.perf_counter() - t0
    if got != expected:
        raise AssertionError(f"{name}: {got} != oracle {expected}")
    if eng.batch_executor.counters["ftree_queries"] != 1:
        raise AssertionError(f"{name}: not on the factorized path")
    grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    if dev.type == "cuda" and min(grew[k] for k in WAVE_KERNELS) == 0:
        raise AssertionError(f"{name}: a kernel was not launched: {grew}")
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        if eng.run_workload([[q]]) != expected:
            raise AssertionError(f"{name}: warm rerun differs")
        warm.append(time.perf_counter() - t0)   # ends in a readback
    warm_s = float(np.median(warm))
    line = {"phase": "scale", "cell": name, "join_input_tuples": n_tuples,
            "first_run_s": first_s, "warm_query_s": warm,
            "tuples_per_s": n_tuples / warm_s, "launches": grew,
            "exact": True}
    if dev.type == "cuda":
        line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        line["device_profile"] = _profile(lambda: eng.run_workload([[q]]))
    return line


# the __global__ functions of csrc/ behind each wrapper's launch count
CSRC_KERNELS = {"bincount": ("bincount_smem_kernel", "bincount_cached_kernel"),
                "gather": ("gather_kernel",),
                "radix_hist": ("radix_hist_kernel",),
                "rank_hist": ("rank_hist_kernel",)}


def _profile(run, top=8, tries=3):
    """One warm run under torch.profiler: its host wall time, the summed
    device time of its kernels (one stream, so they do not overlap) and
    the top kernels by device time. The capture is held to the wrappers'
    own launch counts: one that recorded another number of csrc kernel
    launches than the wrappers made in that run is taken again, up to
    `tries` times, and then reported as not measured, with the wrappers
    whose launches it lost and its top kernels as captured."""
    import torch
    from radixhashjoin_tpu_torch import kernels
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(tries):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_s = time.perf_counter() - t0
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            dt = getattr(ev, "device_time_total", None)
            if dt is None:
                dt = getattr(ev, "cuda_time_total", 0)
            if dt and ev.device_type == torch.autograd.DeviceType.CUDA:
                rows.append((dt, ev.key, ev.count))
        if not rows:
            return "not measured (profiler recorded no device time)"
        made = {k: kernels.LAUNCHES[k] - before[k] for k in CSRC_KERNELS}
        got = {k: sum(c for _, name, c in rows if name.startswith(tuple(
            f"(anonymous namespace)::{f}(" for f in fns)))
            for k, fns in CSRC_KERNELS.items()}
        seen.append([sum(got.values()), sum(made.values())])
        if got == made:
            break
        # which wrapper's launches the capture lost
        seen[-1].append({k: [got[k], made[k]] for k in made
                         if got[k] != made[k]})
    else:
        rows.sort(reverse=True)
        return {"status": "not measured: the capture missed csrc kernel "
                          "launches",
                "csrc_launches_captured_made": seen,
                "top_as_captured": [{"kernel": k[:80], "device_us": dt,
                                     "calls": c}
                                    for dt, k, c in rows[:top]]}
    rows.sort(reverse=True)
    return {"wall_s_profiled": wall_s,
            "device_us_total": sum(r[0] for r in rows),
            "kernel_launches": sum(r[2] for r in rows),
            "csrc_launches_captured_made": seen,
            "top": [{"kernel": k[:80], "device_us": dt, "calls": c}
                    for dt, k, c in rows[:top]]}


def phase_scale(dev, zipf_rows=ZIPF_ROWS, star_rows=STAR_ROWS,
                n_keys=DIM_KEYS, triangle_rows=TRIANGLE_ROWS):
    """Phase 4, with phase 4c's distributed cells on its relations.
    Returns (lines, [(distributed line, its first run's launches)])."""
    from radixhashjoin_tpu_torch import bench_scale
    from radixhashjoin_tpu_torch.bench_scale import free_memory
    from radixhashjoin_tpu_torch.config import EngineConfig
    rng = np.random.default_rng(0)
    dist = []
    print(json.dumps({"phase": "scale", "note": (
        f"zipf fact 2^{zipf_rows.bit_length() - 1} rows (BASELINE config 4 "
        f"asks >= 100M), star fact 2^{star_rows.bit_length() - 1} rows "
        f"(scripts/bench_scale.py's size)")}))
    lines = []

    # BASELINE config 4 (bench_scale.zipf_join; load_s includes the oracle)
    t0 = time.perf_counter()
    zipf = bench_scale.zipf_join(zipf_rows, rng, n_keys)
    load_s = time.perf_counter() - t0
    line = _scale_run("zipf", zipf.rels, zipf.query, zipf.expected,
                      zipf_rows + n_keys, dev)
    line["load_s"] = load_s
    lines.append(line)
    print(json.dumps(line))
    # phase 4c on the same relations: the distributed layer, a world of
    # one (the wave, the heavy broadcast, the all_to_all exchange)
    for cell, cfg in (
            ("dist_zipf_ftree", EngineConfig(mesh_devices=1)),
            ("dist_zipf_heavy", EngineConfig(mesh_devices=1,
                                             factorized=False)),
            ("dist_zipf_exchange", EngineConfig(mesh_devices=1,
                                                factorized=False,
                                                skew_heavy_fraction=1.0))):
        dist.append(_dist_run(cell, zipf.rels, zipf.query, zipf.expected,
                              zipf_rows + n_keys, dev, cfg))
        free_memory(dev)
    del zipf

    # star (bench_scale.star): fact JOIN dim1 JOIN dim2
    t0 = time.perf_counter()
    star = bench_scale.star(star_rows, rng, n_keys)
    load_s = time.perf_counter() - t0
    args = (star.rels, star.query, star.expected, star_rows + 2 * n_keys, dev)
    line = _scale_run("star", *args)
    line["load_s"] = load_s
    lines.append(line)
    print(json.dumps(line))
    # the same star query through the per-query executor
    line = _per_query_run("star_per_query", *args)
    line["batch_path_warm_s"] = lines[-1]["warm_query_s"]
    lines.append(line)
    print(json.dumps(line))
    # the same star through the batch path's materialized fallback: the
    # dense fused stage (defer_attach, terminal, project_defer) and the
    # sort backend's per-op path
    for name, cfg, dense in (
            ("star_batch_materialized", EngineConfig(factorized=False), True),
            ("star_batch_sort", EngineConfig(join_backend="sort"), False)):
        line = _batch_fallback_run(name, *args, cfg, dense)
        lines.append(line)
        print(json.dumps(line))
    # phase 4c: the star through the exchange path: case 1, then case 2,
    # then the projections
    dist.append(_dist_run("dist_star_exchange", *args,
                          EngineConfig(mesh_devices=1, factorized=False)))
    del star, args
    free_memory(dev)

    for line in _triangle(rng, dev, triangle_rows):
        lines.append(line)
        print(json.dumps(line))
    return lines, dist


def _sync_check(eng, run):
    """One warm run under torch.cuda.set_sync_debug_mode("warn"): the
    synchronizing calls inside each stage round, and in the whole run
    beside its readbacks (each readback is one device-to-host copy, one
    synchronizing call)."""
    import warnings

    import torch

    def syncs(caught):
        return sum("synchronizing" in str(w.message) for w in caught)

    bex = eng.batch_executor
    rounds = []
    run_round = bex._run_round

    def counted(*a, **k):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_round(*a, **k)
        rounds.append(syncs(caught))
    bex._run_round = counted            # the instance attribute shadows it
    reads = bex.counters["readbacks"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del bex._run_round
    out = {"syncs_per_round": rounds,
           "syncs_in_run": syncs(caught) + sum(rounds),
           "readbacks_in_run": bex.counters["readbacks"] - reads}
    if any(rounds) or out["syncs_in_run"] != out["readbacks_in_run"]:
        raise AssertionError(f"synchronizing calls beyond the readbacks: "
                             f"{out}")
    return out


def _batch_fallback_run(name, rels, q, expected, n_tuples, dev, config,
                        dense=True):
    """One query through the batch path's materialized fallback under
    `config`: first run, three warm runs, the op kinds of its stages,
    readbacks and dispatches of one run, peak memory, kernel launches
    (the build and lookup on the dense backend; the sort backend runs
    neither), the sync check and a profiled run; exact against
    `expected`."""
    import torch
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.models import batch as batch_mod
    from radixhashjoin_tpu_torch.models.engine import Engine

    rounds = []
    run_stage = batch_mod.run_stage

    def recording(*a, **k):
        rounds.append([op[0] for op in a[7]])
        return run_stage(*a, **k)
    batch_mod.run_stage = recording
    try:
        before = dict(kernels.LAUNCHES)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        eng = Engine(rels, config, device=dev)
        t0 = time.perf_counter()
        got = eng.run_workload([[q]])
        first_s = time.perf_counter() - t0
        if got != expected:
            raise AssertionError(f"{name}: {got} != oracle {expected}")
        counters = dict(eng.batch_executor.counters)
        if counters["ftree_queries"] or eng.executor.counters["queries"]:
            raise AssertionError(f"{name}: not on the materialized "
                                 f"fallback: {counters}")
        grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        if (dev.type == "cuda" and dense
                and min(grew[k] for k in WAVE_KERNELS) == 0):
            raise AssertionError(f"{name}: a kernel was not launched: "
                                 f"{grew}")
        stage_ops = list(rounds)
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            if eng.run_workload([[q]]) != expected:
                raise AssertionError(f"{name}: warm rerun differs")
            warm.append(time.perf_counter() - t0)   # ends in a readback
        line = {"phase": "scale", "cell": name, "join_input_tuples": n_tuples,
                "backend": eng.batch_executor.join.kind,
                "fuse_stages": config.fuse_stages,
                "factorized": config.factorized,
                "first_run_s": first_s, "warm_query_s": warm,
                "tuples_per_s": n_tuples / float(np.median(warm)),
                "readbacks_per_run": counters["readbacks"],
                "dispatches_per_run": counters["dispatches"],
                "spec_retries": counters["spec_retries"],
                "stage_ops_per_round": stage_ops,
                "launches_first_run": grew, "exact": True}
        if dev.type == "cuda":
            line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            line["sync_check"] = _sync_check(
                eng, lambda: eng.run_workload([[q]]))
            line["device_profile"] = _profile(
                lambda: eng.run_workload([[q]]))
    finally:
        batch_mod.run_stage = run_stage
    return line


def _per_query_run(name, rels, q, expected, n_tuples, dev):
    """One query through Engine(batch_execution=False): first run, three
    warm runs, a profiled run; exact against `expected`."""
    import torch
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.config import EngineConfig
    from radixhashjoin_tpu_torch.models.engine import Engine

    before = dict(kernels.LAUNCHES)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = Engine(rels, EngineConfig(batch_execution=False), device=dev)
    t0 = time.perf_counter()
    got = eng.run_workload([[q]])
    first_s = time.perf_counter() - t0
    if got != expected:
        raise AssertionError(f"{name}: {got} != oracle {expected}")
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        if eng.run_workload([[q]]) != expected:
            raise AssertionError(f"{name}: warm rerun differs")
        warm.append(time.perf_counter() - t0)   # ends in a readback
    reads = eng.executor.counters["readbacks"] // 4
    line = {"phase": "scale", "cell": name, "join_input_tuples": n_tuples,
            "first_run_s": first_s, "warm_query_s": warm,
            "tuples_per_s": n_tuples / float(np.median(warm)),
            "readbacks_per_query": reads,
            "launches": {k: kernels.LAUNCHES[k] - before[k]
                         for k in before},
            "exact": True}
    if dev.type == "cuda":
        line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        line["device_profile"] = _profile(lambda: eng.run_workload([[q]]))
    return line


def _triangle(rng, dev, n):
    """A cyclic triangle R(a, b) ⋈ S(b, c) ⋈ T(c, a) of n-row relations,
    which the factorized wave cannot plan: n planted triangles over
    values below n, half of T's rows broken so that the closing
    predicate filters, against the port's oracle; through the per-query
    executor and through the batch path's materialized fallback."""
    from radixhashjoin_tpu_torch.oracle import OracleExecutor
    from radixhashjoin_tpu_torch.storage import Relation
    from radixhashjoin_tpu_torch.workload import parse_query

    t0 = time.perf_counter()
    a, b, c = (rng.integers(0, n, n).astype(np.uint64) for _ in range(3))
    pay = rng.integers(0, 1000, n).astype(np.uint64)
    ps, pt = rng.permutation(n), rng.permutation(n)
    ta = a.copy()
    broken = rng.random(n) < 0.5
    ta[broken] = rng.integers(0, n, int(broken.sum())).astype(np.uint64)
    rels = [Relation([a, b, pay]), Relation([b[ps], c[ps], pay[ps]]),
            Relation([c[pt], ta[pt]])]
    q = parse_query("0 1 2|0.1=1.0&1.1=2.0&2.1=0.0&0.2<900|0.2 1.2 2.0")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = OracleExecutor(rels).execute(q)
    oracle_s = time.perf_counter() - t0
    if want is None or min(want) == 0:
        raise AssertionError(f"triangle oracle gave a degenerate {want}")
    line = _per_query_run("triangle_per_query", rels, q,
                          [" ".join(map(str, want))], 3 * n, dev)
    line.update(load_s=load_s, oracle_s=oracle_s)
    from radixhashjoin_tpu_torch.config import EngineConfig
    batch = _batch_fallback_run("triangle_batch", rels, q,
                                [" ".join(map(str, want))], 3 * n, dev,
                                EngineConfig())
    batch["per_query_warm_s"] = line["warm_query_s"]
    return [line, batch]


# ---- phase 4c: the distributed layer in a world of one ----

def _dist_world(dev):
    """This process as the one rank of a world (NCCL on the card, gloo on
    the CPU), joined once; returns its Mesh."""
    import torch.distributed as dist
    from radixhashjoin_tpu_torch.parallel import multihost
    from radixhashjoin_tpu_torch.parallel.mesh import make_mesh
    if not dist.is_initialized():
        multihost.init_multihost(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                 device=dev.type)
    return make_mesh(1)


def _jax_readbacks(q, exchange):
    """Readbacks of one query in the reference's DistExecutor, from its
    structure: one stats readback per case-1 / case-2 join, one per
    projection plane (narrow data: one plane a projection) and one for
    the NULL flags; a factorized query reads back once. Its gather
    capacities are unbounded in a world of one, so no overflow readback."""
    if not exchange:
        return 1
    joined, n_probe = set(), 0
    for j in q.joins:
        if j.slot1 != j.slot2 and not (j.slot1 in joined
                                       and j.slot2 in joined):
            n_probe += 1
        joined |= {j.slot1, j.slot2}
    return n_probe + len(q.projections) + (1 if q.filters else 0)


def _dist_run(name, rels, q, expected, n_tuples, dev, config):
    """One query through the DistExecutor of a world of one: first run,
    three warm runs, readbacks and collectives a query beside the
    reference's readbacks, peak memory, the kernels launched in the first
    run (the factorized wave's build and lookup, the exchange path's rank
    kernel and lookup), and a profiled run; exact against `expected`.
    Returns (line, first-run launches)."""
    import torch
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.parallel.dist_executor import DistExecutor

    mesh = _dist_world(dev)
    exchange = not config.factorized
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ex = DistExecutor(rels, config, mesh=mesh)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    calls = dict(mesh.calls)
    t0 = time.perf_counter()
    got = ex.run_batch([q])
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    calls = {k: mesh.calls[k] - calls[k] for k in calls}
    if got != expected:
        raise AssertionError(f"{name}: {got} != oracle {expected}")
    path = "exchange_queries" if exchange else "ftree_queries"
    if ex.counters[path] != 1:
        raise AssertionError(f"{name}: not on the {path} path: "
                             f"{ex.counters}")
    need = ("rank_hist", "gather") if exchange else WAVE_KERNELS
    if dev.type == "cuda" and min(launches[k] for k in need) == 0:
        raise AssertionError(f"{name}: a kernel was not launched: "
                             f"{launches}")
    readbacks = ex.counters["readbacks"]
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        if ex.run_batch([q]) != expected:
            raise AssertionError(f"{name}: warm rerun differs")
        warm.append(time.perf_counter() - t0)   # ends in a readback
    line = {"phase": "dist", "cell": name, "world": mesh.size,
            "backend": "nccl" if dev.type == "cuda" else "gloo",
            "factorized": config.factorized,
            "skew_heavy_fraction": config.skew_heavy_fraction,
            "join_input_tuples": n_tuples, "first_run_s": first_s,
            "warm_query_s": warm,
            "tuples_per_s": n_tuples / float(np.median(warm)),
            "readbacks_per_query": readbacks,
            "reference_readbacks_per_query": _jax_readbacks(q, exchange),
            "collectives_per_query": calls,
            "gather_retries": ex.counters["gather_retries"],
            "launches_first_run": launches, "exact": True}
    if dev.type == "cuda":
        line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        line["device_profile"] = _profile(lambda: ex.run_batch([q]))
    print(json.dumps(line))
    del ex
    return line, launches


def _gloo_rank(mesh, stream):
    """One gloo rank of phase 4c's two-rank run on one card: the CLI's
    per-rank program on the 70-query stream; rank 0 returns its lines."""
    from radixhashjoin_tpu_torch.config import EngineConfig
    from radixhashjoin_tpu_torch.parallel.worker import serve
    out = io.StringIO()
    engine = serve(mesh, EngineConfig(mesh_devices=mesh.size),
                   io.StringIO(stream) if mesh.rank == 0 else None, out)
    return out.getvalue().splitlines(), engine.dist_executor.counters


def phase_dist_cli(dev, default_lines):
    """Phase 3c's 70 queries through `--mesh 1` (a subprocess, its own
    world of one) and through the same per-rank program in-process: lines
    equal to the oracle's and the default CLI's, 50 queries in one
    factorized wave and 20 through the exchange pipeline; then two gloo
    ranks sharing this card. Returns the in-process run's launches."""
    import torch
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.config import EngineConfig
    from radixhashjoin_tpu_torch.oracle import run_workload
    from radixhashjoin_tpu_torch.parallel import multihost
    from radixhashjoin_tpu_torch.parallel.worker import serve
    from radixhashjoin_tpu_torch.workload import parse_work_stream

    with tempfile.TemporaryDirectory() as tmp:
        paths, loaded, tree, work, _kinds = _contest_files(tmp, dev)
        want = run_workload(loaded, parse_work_stream(work))
        if default_lines != want:
            raise AssertionError("phase 3c's default CLI lines differ from "
                                 "the oracle's")
        stream = "\n".join(paths + ["Done"] + work) + "\n"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "radixhashjoin_tpu_torch", "--device",
             dev.type, "--mesh", "1"], input=stream, capture_output=True,
            text=True, cwd=REPO, timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"--mesh 1 CLI exit {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        if proc.stdout.splitlines() != want:
            raise AssertionError("--mesh 1 CLI lines differ from the oracle's")
        mesh = _dist_world(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        engine = serve(mesh, EngineConfig(mesh_devices=1), io.StringIO(stream),
                       out)
        first_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if out.getvalue().splitlines() != want:
            raise AssertionError("in-process --mesh 1 lines differ")
        counters = dict(engine.dist_executor.counters)
        if (counters["ftree_queries"], counters["ftree_waves"],
                counters["exchange_queries"]) != (len(tree) - tree.count("F"),
                                                   1, 20):
            raise AssertionError(f"--mesh 1 counters {counters}")
        batches = parse_work_stream(work)
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            if engine.run_workload(batches) != want:
                raise AssertionError("--mesh 1 warm rerun differs")
            warm.append(time.perf_counter() - t0)
        line = {"phase": "dist_cli", "world": 1, "queries": len(want),
                "lines_equal_oracle": True, "lines_equal_default_cli": True,
                "counters": counters, "cli_subprocess_s": cli_s,
                "inprocess_first_s": first_s, "inprocess_warm_s": warm,
                "launches": launches}
        if dev.type == "cuda":
            line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            line["device_profile"] = _profile(
                lambda: engine.run_workload(batches))
        print(json.dumps(line))
        del engine
        # two gloo ranks on this one card (NCCL puts one rank on a card)
        t0 = time.perf_counter()
        outs = multihost.run_ranks(_gloo_rank, 2, (stream,), device=dev,
                                   backend="gloo", timeout=600)
        if outs[0][0] != want:
            raise AssertionError("two gloo ranks: lines differ from the "
                                 "oracle's")
        print(json.dumps({"phase": "dist_cli_gloo2", "world": 2,
                          "device": str(dev), "backend": "gloo",
                          "lines_equal_oracle": True,
                          "counters": outs[0][1],
                          "seconds": time.perf_counter() - t0}))
    return launches


# ---- phase 4b: huge nodes (past 2^28 rows, the windowed pass) ----

def _huge_run(name, rels, q, expected, n_fact, n_tuples, bytes_per_row, dev):
    """One query whose fact node is past _BIG_WAVE_ROWS: first run
    (launch counts from zero: the main path of this phase), three warm runs, peak memory, the sync
    check, a profiled run, and the warm wall against the bound of the
    bytes the fused window pass must read (`bytes_per_row` a fact row,
    once, over 3.35 TB/s); exact against `expected`. Fails unless the
    build and lookup ran at least once a window."""
    import torch
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.bench_tables import bound_ms
    from radixhashjoin_tpu_torch.config import EngineConfig
    from radixhashjoin_tpu_torch.models.engine import Engine
    from radixhashjoin_tpu_torch.ops import factorized

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    eng = Engine(rels, EngineConfig(), device=dev)
    t0 = time.perf_counter()
    got = eng.run_workload([[q]])
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if got != expected:
        raise AssertionError(f"{name}: {got} != oracle {expected}")
    if eng.batch_executor.counters["ftree_queries"] != 1:
        raise AssertionError(f"{name}: not on the factorized path")
    windows = -(-n_fact // factorized._win_rows())
    if dev.type == "cuda" and min(launches[k] for k in WAVE_KERNELS) < windows:
        raise AssertionError(f"{name}: fewer launches than the "
                             f"{windows} windows: {launches}")
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        if eng.run_workload([[q]]) != expected:
            raise AssertionError(f"{name}: warm rerun differs")
        warm.append(time.perf_counter() - t0)   # ends in a readback
    warm_s = float(np.median(warm))
    bound = bound_ms(bytes_per_row * n_fact)
    line = {"phase": "huge", "cell": name,
            "fact_rows": n_fact, "join_input_tuples": n_tuples,
            "windows": windows, "window_rows": factorized._win_rows(),
            "first_run_s": first_s, "warm_query_s": warm,
            "tuples_per_s": n_tuples / warm_s, "launches": launches,
            "bytes_per_fact_row": bytes_per_row, "bytes_bound_ms": bound,
            "bytes_bound_share": bound / (warm_s * 1e3), "exact": True}
    if dev.type == "cuda":
        line["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        # the span of a warm run on the card's clock (CUDA events)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        eng.run_workload([[q]])
        ev[1].record()
        torch.cuda.synchronize()
        line["event_ms"] = ev[0].elapsed_time(ev[1])
        line["sync_check"] = _sync_check(eng, lambda: eng.run_workload([[q]]))
        line["device_profile"] = _profile(lambda: eng.run_workload([[q]]),
                                          top=10)
    del eng
    return line, launches


def phase_huge(dev, zipf_rows=HUGE_ZIPF_ROWS, star_rows=HUGE_STAR_ROWS,
               n_keys=DIM_KEYS):
    """Facts past the 2^28-row huge-node threshold through
    Engine.run_workload: the Zipf join of phase 4 at 2^29 + 12345 rows
    and the star of scripts/bench_scale.py:315-349 (Zipf key 1, uniform
    key 2, three sums) at 2^29 + 4099 rows, each against its closed-form
    NumPy oracle. Returns the lines and the launches of their first
    runs, summed."""
    from radixhashjoin_tpu_torch import bench_scale
    from radixhashjoin_tpu_torch.bench_scale import free_memory
    rng = np.random.default_rng(29)
    lines, total = [], {}

    def run(*args):
        line, launches = _huge_run(*args, dev)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        lines.append(line)
        print(json.dumps(line))
        free_memory(dev)

    # the Zipf join of phase 4 (bench_scale.zipf_join), past 2^29 rows
    # with a ragged tail; the fused pass reads the key (4 B) and the
    # uint16 plane (2 B) of a fact row (scripts/bench_scale.py:312)
    t0 = time.perf_counter()
    case = bench_scale.zipf_join(zipf_rows, rng, n_keys)
    print(json.dumps({"phase": "huge", "cell": "zipf_huge",
                      "setup_s": time.perf_counter() - t0}))
    run("zipf_huge", case.rels, case.query, case.expected, zipf_rows,
        zipf_rows + n_keys, 6)
    del case
    free_memory(dev)

    # the star at config-5 scale (bench_scale.star_big): key1 + key2 (4 B
    # each) + the uint16 plane (2 B) a fact row (scripts/bench_scale.py:358)
    t0 = time.perf_counter()
    case = bench_scale.star_big(star_rows, rng, n_keys)
    print(json.dumps({"phase": "huge", "cell": "star_huge",
                      "setup_s": time.perf_counter() - t0}))
    run("star_huge", case.rels, case.query, case.expected, star_rows,
        star_rows + 2 * n_keys, 10)
    del case
    free_memory(dev)
    return lines, total


# ---- phase 5: the kernel shootout ----

def phase_shootout(dev, log_rows=SHOOTOUT_LOG_ROWS):
    """`bench_kernels --log-rows 26` in-process, its lines printed; the
    launch counts of this run show the radix kernels' path."""
    from radixhashjoin_tpu_torch import bench_kernels, kernels
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    rc = bench_kernels.main(["--log-rows", str(log_rows), "--device",
                             dev.type], out)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    print(out.getvalue(), end="")
    if rc != 0:
        raise AssertionError(f"bench_kernels exited {rc}")
    if min(launches.values()) == 0:
        raise AssertionError(f"the shootout skipped a kernel: {launches}")
    print(json.dumps({"phase": "shootout", "log_rows": log_rows,
                      "seconds": seconds, "launches": launches}))
    return launches


# ---- phase 6: the port's bench entry points ----

# the metric names bench_scale prints under BENCH_SCALE_ARGV: every one of
# the reference script's but the chain's, which this phase runs past 2^28
BENCH_SCALE_METRICS = {
    "dense_probe_uniform_tuples_per_s", "dense_probe_fk_tuples_per_s",
    "dense_probe_narrow_domain_tuples_per_s",
    "star_join_engine_tuples_per_s", "star_join_smalldim_engine_tuples_per_s",
    "zipf_join_engine_tuples_per_s", "star_join_big_engine_tuples_per_s",
    "skewaware_dist_join_tuples_per_s"}


def _add_launches(what, launches, keys, dev, total):
    """Add one run's launches to `total`; on the card, raise unless each
    kernel in `keys` launched in that run."""
    if dev.type == "cuda" and any(launches[k] == 0 for k in keys):
        raise AssertionError(f"{what} skipped a kernel: {launches}")
    for k, v in launches.items():
        total[k] += v


def _bench_main(module, argv, dev):
    """module.main(argv + --device) in-process, as a user runs it: its
    JSON lines, printed, each held to "exact" where it says so; raises
    unless it exits 0."""
    out = io.StringIO()
    t0 = time.perf_counter()
    rc = module.main(list(argv) + ["--device", dev.type], out)
    seconds = time.perf_counter() - t0
    print(out.getvalue(), end="")
    if rc != 0:
        raise AssertionError(f"{module.__name__} {argv} exited {rc}")
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    if not lines or any(ln.get("exact", True) is not True for ln in lines):
        raise AssertionError(f"{module.__name__} {argv}: {lines}")
    print(json.dumps({"phase": "bench", "entry": module.__name__,
                      "argv": list(argv), "lines": len(lines),
                      "seconds": seconds}))
    return lines


def phase_bench(dev, chain_rows=CHAIN_ROWS, scale_argv=BENCH_SCALE_ARGV,
                planner_argvs=PLANNER_ARGVS):
    """The port's bench entry points as users run them: bench_scale's
    configs (the three dense probes at 2^26 rows a side, the star and the
    small-dimension star at 2^24 fact rows, the Zipf join and the big star
    at 2^24, the skew-aware join at 2^24 rows in a world of one NCCL
    rank), the two-deep chain at chain_rows a fact through the huge-node
    pass (phase 4b's measurements: launches of its first run, peak memory,
    the sync check; its data and closed form from bench_scale.chain), the
    70-query bench twin, bench_planner at both sizes and bench_microops;
    every line exact.

    Each run's launches are counted from 0 by its entry point (a line's
    `launches`: a bench_scale config's exactness run, the twin's cold
    pass, the planner's first run of each order) or by _huge_run (the
    chain's first run). On the card each dense probe, engine config, the
    chain and the twin must launch the build and lookup, and the skew join
    the rank kernel; the planner's per-query path joins with the sort
    probe and launches none. The timed calls and bench_microops' timing
    loops are not counted. Returns the counted runs' launches, summed."""
    from radixhashjoin_tpu_torch import (bench, bench_microops, bench_planner,
                                         bench_scale, kernels)
    from radixhashjoin_tpu_torch.bench_scale import free_memory
    total = {k: 0 for k in kernels.LAUNCHES}
    lines = _bench_main(bench_scale, scale_argv, dev)
    names = {ln["metric"] for ln in lines}
    if names != BENCH_SCALE_METRICS:
        raise AssertionError(f"bench_scale metrics {sorted(names)}")
    for ln in lines:
        keys = (("rank_hist",) if ln["metric"].startswith("skewaware")
                else WAVE_KERNELS)
        _add_launches(ln["metric"], ln["launches"], keys, dev, total)

    # the chain: the CLI's --zipf-only --chain-rows data at this row count
    t0 = time.perf_counter()
    case = bench_scale.chain(chain_rows, np.random.default_rng(0))
    print(json.dumps({"phase": "bench", "cell": "chain_huge",
                      "setup_s": time.perf_counter() - t0}))
    line, first = _huge_run("chain_huge", case.rels, case.query,
                            case.expected, chain_rows, 2 * chain_rows,
                            8 + 6 + 10, dev)
    line.update(bench_scale.chain_line(
        chain_rows, case.expected[0], float(np.median(line["warm_query_s"])),
        dev))
    print(json.dumps(line))
    del case
    free_memory(dev)
    _add_launches("chain_huge", first, WAVE_KERNELS, dev, total)

    twin, = _bench_main(bench, [], dev)
    if dev.type == "cuda" and not isinstance(twin["value"], float):
        raise AssertionError(f"bench: {twin}")
    _add_launches("bench", twin["launches"], WAVE_KERNELS, dev, total)
    for argv in planner_argvs:
        planner, = _bench_main(bench_planner, argv, dev)
        for order in ("written", "reordered"):
            _add_launches(f"bench_planner {order}",
                          planner["launches_" + order], (), dev, total)
    _bench_main(bench_microops, [], dev)
    print(json.dumps({"phase": "bench", "launches": total}))
    return total


# ---- phase 7: the pipelined exchange and the distributed entry points ----

DIST_SCALE_METRICS = [
    "dist_star_ftree_tuples_per_s", "dist_mem_d_ftree_star",
    "dist_exchange_join_tuples_per_s", "dist_mem_d_case1_probe",
    "dist_mem_d_case1_expand", "dist_mem_d_project_gcap",
    "dist_mem_d_project_worst_case"]


def _overlap(trace_path):
    """From a chrome trace: NCCL's device ops (each device event inside
    the profiler's "nccl:*" span on NCCL's stream: a kernel, or, in a
    world of one, a device-to-device copy), and the microseconds each
    overlaps kernels on the other streams (the compute stream's; one
    stream's kernels do not overlap each other)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "gpu_user_annotation"
             and e["name"].startswith("nccl:")]

    def inside(e, a):
        return (e["tid"] == a["tid"] and a["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= a["ts"] + a["dur"])
    nccl = [e for e in dev if "nccl" in e["name"].lower()
            or any(inside(e, a) for a in spans)]
    streams = {e["tid"] for e in nccl}
    compute = [e for e in dev if e["cat"] == "kernel"
               and e["tid"] not in streams]
    per = []
    for a in nccl:
        lap = sum(max(0.0, min(a["ts"] + a["dur"], b["ts"] + b["dur"])
                      - max(a["ts"], b["ts"])) for b in compute)
        per.append(lap)
    by_stream = {}
    for e in dev:
        by_stream[str(e["tid"])] = by_stream.get(str(e["tid"]), 0) + 1
    return {"nccl_spans": sorted({a["name"] for a in spans}),
            "nccl_device_ops": len(nccl),
            "nccl_op_names": sorted({e["name"][:60] for e in nccl}),
            "nccl_us": sum(e["dur"] for e in nccl),
            "nccl_streams": sorted(map(str, streams)),
            "device_events_by_stream": by_stream,
            "compute_kernels": len(compute),
            "overlapping_nccl_ops": sum(lap > 0 for lap in per),
            "overlapped_us": sum(per),
            "overlapped_us_by_op": per}


def _overlap_profile(run):
    """One warm run under torch.profiler, its chrome trace read by
    _overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return _overlap(path)


def _exchange_round_syncs(spy):
    """Where the captured exchange round (d_case1_probe, d_case1_expand,
    d_project on their last arguments) made synchronizing calls under
    torch.cuda.set_sync_debug_mode("warn"): one "file:line" each."""
    import warnings

    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name in ("d_case1_probe", "d_case1_expand", "d_project"):
                a, k = spy.calls[name]
                spy.orig[name](*a, **k)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
            if "synchronizing" in str(w.message)]


def _quartiles(xs):
    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return {"median": float(med), "iqr": float(q3 - q1),
            "min": float(min(xs)), "max": float(max(xs))}


def _chunk_ab(name, case, n_tuples, dev, mesh, total, **cfg):
    """One phase 4c exchange cell at K = 1 and K = 4 (exchange, gather and
    broadcast chunks): each executor's first run exact, its launches
    counted from 0 (the rank kernel and the lookup must launch); then
    DIST_AB_PAIRS alternating pairs of warm runs, each exact. Returns
    (line, the K = 4 executor)."""
    from radixhashjoin_tpu_torch import kernels
    from radixhashjoin_tpu_torch.config import EngineConfig
    from radixhashjoin_tpu_torch.parallel.dist_executor import DistExecutor
    exs, first, counted = {}, {}, {}
    for k in (1, 4):
        exs[k] = DistExecutor(case.rels, EngineConfig(
            mesh_devices=1, factorized=False, exchange_chunks=k,
            gather_chunks=k, broadcast_chunks=k, **cfg), mesh=mesh)
        t0 = time.perf_counter()
        got, launches = kernels.counted(lambda: exs[k].run_batch(
            [case.query]))
        first[k] = time.perf_counter() - t0
        if got != case.expected:
            raise AssertionError(f"{name} K={k}: {got} != {case.expected}")
        _add_launches(f"{name} K={k}", launches, ("rank_hist", "gather"),
                      dev, total)
        counted[k] = launches
    walls = {1: [], 4: []}
    for i in range(DIST_AB_PAIRS):
        for k in ((1, 4) if i % 2 == 0 else (4, 1)):
            t0 = time.perf_counter()
            got = exs[k].run_batch([case.query])    # ends in a readback
            walls[k].append(time.perf_counter() - t0)
            if got != case.expected:
                raise AssertionError(f"{name} K={k}: warm run differs")
    line = {"phase": "dist_pipeline", "cell": name,
            "join_input_tuples": n_tuples, "first_run_s": first,
            "launches_first_run": counted, "warm_s_k1": walls[1], "warm_s_k4": walls[4],
            "k1": _quartiles(walls[1]), "k4": _quartiles(walls[4]),
            "exact": True}
    return line, exs[4]


def phase_dist_pipeline(dev, zipf_rows=ZIPF_ROWS, star_rows=STAR_ROWS,
                        n_keys=DIM_KEYS, scale_argv=DIST_SCALE_ARGV,
                        eff_argv=SCALE_EFF_ARGV):
    """Phase 7: bench_dist_scale and scale_efficiency as users run them,
    then phase 4c's exchange cells at K = 1 and K = 4, the overlap
    profile and the sync check of the K = 4 Zipf cell. Returns the
    counted runs' launches, summed."""
    from radixhashjoin_tpu_torch import (bench_dist_scale, bench_scale,
                                         kernels, scale_efficiency)
    from radixhashjoin_tpu_torch.bench_scale import free_memory
    from radixhashjoin_tpu_torch.parallel import multihost
    t0 = time.perf_counter()
    total = {k: 0 for k in kernels.LAUNCHES}
    lines = _bench_main(bench_dist_scale, scale_argv, dev)
    if [ln["metric"] for ln in lines] != DIST_SCALE_METRICS:
        raise AssertionError(f"bench_dist_scale metrics "
                             f"{[ln['metric'] for ln in lines]}")
    _add_launches("dist_star_ftree", lines[0]["launches"], WAVE_KERNELS,
                  dev, total)
    _add_launches("dist_exchange_join", lines[2]["launches"],
                  ("rank_hist", "gather"), dev, total)
    free_memory(dev)

    lines = _bench_main(scale_efficiency, eff_argv, dev)
    worlds = [ln for ln in lines
              if ln["metric"] == "dist_engine_join_tuples_per_s"]
    want = ([("nccl", 1), ("gloo", 2)] if dev.type == "cuda"
            else [("gloo", None)] * 2)
    if [(ln["backend"], ln["ranks_per_card"]) for ln in worlds] != want:
        raise AssertionError(f"scale_efficiency worlds: {worlds}")
    for ln in worlds:
        _add_launches(f"scale_efficiency N={ln['devices']}", ln["launches"],
                      WAVE_KERNELS, dev, total)

    # phase 4's relations again (same draws), through phase 4c's
    # exchange cells at K = 1 and K = 4
    rng = np.random.default_rng(0)
    mesh = _dist_world(dev)
    try:
        zipf = bench_scale.zipf_join(zipf_rows, rng, n_keys)
        with bench_dist_scale.Spy() as spy:
            line, ex4 = _chunk_ab("dist_zipf_exchange", zipf,
                                  zipf_rows + n_keys, dev, mesh, total,
                                  skew_heavy_fraction=1.0)
            calls = dict(mesh.calls)
            if ex4.run_batch([zipf.query]) != zipf.expected:  # captured
                raise AssertionError("dist_zipf_exchange: captured run")
            line["collectives_per_query_k4"] = {
                c: mesh.calls[c] - calls[c] for c in calls}
            if dev.type == "cuda":
                a, k = spy.calls["d_case1_probe"]
                probe = spy.orig["d_case1_probe"]
                line["overlap_d_case1_probe_k4"] = ov = _overlap_profile(
                    lambda: probe(*a, **k))
                if not ov["overlapping_nccl_ops"]:
                    raise AssertionError(f"no NCCL device op overlaps a "
                                         f"compute kernel: {ov}")
                syncs = _exchange_round_syncs(spy)
                line["syncs_in_exchange_round"] = len(syncs)
                if syncs:
                    raise AssertionError(f"the exchange round made "
                                         f"synchronizing calls at {syncs}")
                del a, k
            spy.calls.clear()
        print(json.dumps(line))
        del zipf, ex4
        free_memory(dev)
        star = bench_scale.star(star_rows, rng, n_keys)
        line, _ex4 = _chunk_ab("dist_star_exchange", star,
                               star_rows + 2 * n_keys, dev, mesh, total)
        print(json.dumps(line))
        del star, _ex4
        free_memory(dev)
    finally:
        multihost.shutdown()
    print(json.dumps({"phase": "dist_pipeline", "launches": total,
                      "seconds": time.perf_counter() - t0}))
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from radixhashjoin_tpu_torch import kernels
    dev = torch.device("cuda", 0)

    print(_nvidia_smi())
    print(json.dumps({"phase": "env", "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "python": sys.version.split()[0]}))
    b = kernels.build()
    print(json.dumps({"phase": "build", "seconds": b["seconds"],
                      "libraries": {k: os.path.relpath(p, REPO)
                                    for k, p in b["paths"].items()},
                      "ptxas": [ln.strip() for ln in b["log"].splitlines()
                                if "Used" in ln or "spill" in ln]}))
    timed, errs = phase_kernels(dev)
    launches = phase_cli(dev)
    default_lines = phase_fallback_cli(dev)
    launches_settings = phase_settings_cli(dev)
    _lines, dist = phase_scale(dev)
    _lines, launches_huge = phase_huge(dev)
    if min(launches_huge[k] for k in WAVE_KERNELS) == 0:
        raise AssertionError(f"the huge phase skipped a kernel: "
                             f"{launches_huge}")
    # the distributed phase's first runs: its four cells and the
    # in-process --mesh 1 run, each counted from zero
    launches_dist = phase_dist_cli(dev, default_lines)
    from radixhashjoin_tpu_torch.parallel import multihost
    multihost.shutdown()                 # phase 4c's world of one
    for _line, first in dist:
        launches_dist = {k: launches_dist[k] + first[k] for k in first}
    if min(launches_dist[k] for k in WAVE_KERNELS + ("rank_hist",)) == 0:
        raise AssertionError(f"the distributed phase skipped a kernel: "
                             f"{launches_dist}")
    # the wave's kernels on every main-path run: the CLI's, the settings
    # phase's, the huge phase's and the distributed phase's first runs
    launches = {k: launches[k] + launches_settings[k]
                + launches_huge.get(k, 0) + launches_dist[k]
                for k in launches}
    launches_radix = phase_shootout(dev)
    launches_bench = phase_bench(dev)
    launches_pipe = phase_dist_pipeline(dev)
    launches = {k: launches[k] + launches_bench[k] + launches_pipe[k]
                for k in launches}
    launches_dist = {k: launches_dist[k] + launches_bench[k]
                     + launches_pipe[k] for k in launches_dist}
    for pkg in ("jax", "radixhashjoin_tpu"):
        if pkg in sys.modules:
            raise AssertionError(f"the port's run imported {pkg}")
    tables = "radixhashjoin_tpu_torch/csrc/tables.cu"
    radix = "radixhashjoin_tpu_torch/csrc/radix.cu"
    rows = [
        ("weighted_bincount_cuda", "bincount", tables,
         "radixhashjoin_tpu/ops/tables.py:283", launches),
        ("table_gather_cuda", "gather", tables,
         "radixhashjoin_tpu/ops/tables.py:564", launches),
        ("radix_histogram_cuda", "radix_hist", radix,
         "radixhashjoin_tpu/ops/pallas_radix.py:55", launches_radix),
        ("rank_hist_cuda", "rank_hist", radix,
         "radixhashjoin_tpu/ops/pallas_partition.py:92", launches_dist)]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[key], "max_abs_err": errs[key],
         "ms": timed[key]["ms"], "plain_ms": timed[key]["plain_ms"],
         "bound_ms": timed[key]["bound_ms"],
         "bound_by": timed[key]["bound_by"],
         "library_ms": timed[key]["library_ms"],
         "library_call": timed[key]["library_call"],
         "case": timed[key]["case"]}
        for name, key, src, rep, counts in rows]}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
