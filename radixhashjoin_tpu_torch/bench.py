"""End-to-end benchmark of the port (counterpart: bench.py at the repo
root): a whole workload through Engine.run_workload, held exact, then
timed. Prints ONE JSON line with the reference's keys.

    python -m radixhashjoin_tpu_torch.bench                # synthetic
    python -m radixhashjoin_tpu_torch.bench --data DIR     # golden layout
    python -m radixhashjoin_tpu_torch.bench --device cpu --tuples 20000
    RHJ_PROFILE=1 python -m radixhashjoin_tpu_torch.bench  # + the profiler

Data. The reference reads the contest's `small` set (r0 … r13,
small.work, small.result), which is in neither this repository nor the
card's machine. By default the benchmark therefore runs a synthetic
workload of the same shape: 14 uint64 relations of ~270K tuples in all
(`make_contest_catalog`, seed 2018), 50 tree-shaped queries in 5 batches
(`make_tree_queries`) and 20 queries the factorized wave does not plan,
in two more (`make_fallback_queries`, seed 7: cycles, same-slot
predicates, no joins); its expected lines are the port's NumPy oracle's
(oracle.py). `--data DIR` reads the reference's layout instead, with
small.result as the expected lines.

Run, as the reference's: one pass held exact against the expected lines
(its wall is `cold_wall_s`: first-use costs such as the kernels' build;
`launches` are its kernel launches, counted from 0),
then the best of `WARM_PASSES` passes, the batch executor's counters
reset before each and printed from the last; every pass is held exact.
Walls are host-clock seconds around run_workload, which ends in a
readback. On the CPU (--device cpu) every pass runs and is held exact on
the plain versions, and nothing is timed: the walls say "not measured".
Without a card the default device cuda exits 2. RHJ_PROFILE set prints
the batch executor's per-operator report to stderr after the timed
passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Sequence, TextIO

import numpy as np
import torch

from . import kernels
from .config import EngineConfig
from .models.engine import Engine, resolve_device
from .oracle import run_workload
from .storage import Relation, load_relation
from .workload import parse_query, parse_work_stream

CONTEST_SEED = 2018
FALLBACK_SEED = 7
CONTEST_TUPLES = 270_000
WARM_PASSES = 3


def make_contest_catalog(rng, n_rel=14, total=CONTEST_TUPLES):
    """14 uint64 relations, ~270K tuples in all: column 0 a dense id,
    further columns foreign keys into a shared 2^15 domain or payload
    values below 2^20 (the contest's value ranges)."""
    sizes = rng.dirichlet(np.full(n_rel, 2.0)) * total
    rels = []
    for n in np.maximum(sizes.astype(np.int64), 50):
        cols = [rng.permutation(n).astype(np.uint64)]
        for _ in range(int(rng.integers(1, 5))):
            hi = int(rng.choice([1 << 15, 1 << 20]))
            cols.append(rng.integers(0, hi, n).astype(np.uint64))
        rels.append(cols)
    return rels


def make_tree_queries(rng, rels, n_queries=50, batch=10):
    """Tree-shaped queries (every join attaches a fresh slot, 1-3 joins),
    1-2 filters, 1-3 projections, batches of `batch` ended by F."""
    lines = []
    for qi in range(n_queries):
        nslots = int(rng.integers(2, 5))
        slots = [int(rng.integers(0, len(rels))) for _ in range(nslots)]
        ncols = [len(rels[s]) for s in slots]
        preds = []
        for s in range(1, nslots):
            p = int(rng.integers(0, s))
            preds.append(f"{p}.{int(rng.integers(0, ncols[p]))}="
                         f"{s}.{int(rng.integers(0, ncols[s]))}")
        for _ in range(int(rng.integers(1, 3))):
            s = int(rng.integers(0, nslots))
            c = int(rng.integers(0, ncols[s]))
            col = rels[slots[s]][c]
            op = str(rng.choice(["<", ">", "="], p=[0.45, 0.45, 0.1]))
            k = int(col[int(rng.integers(0, len(col)))])
            preds.append(f"{s}.{c}{op}{k}")
        projs = [f"{int(s)}.{int(rng.integers(0, ncols[s]))}"
                 for s in rng.integers(0, nslots, int(rng.integers(1, 4)))]
        lines.append(f"{' '.join(map(str, slots))}|{'&'.join(preds)}|"
                     f"{' '.join(projs)}")
        if qi % batch == batch - 1:
            lines.append("F")
    return lines


def make_fallback_queries(rng, rels, batch_executor, n_queries=20):
    """Queries the factorized wave does not plan, in turn: cycles over
    three relations, same-slot predicates without cross joins, and
    filter-only queries. Each is kept only if the batch executor's tree
    planner leaves it to the materialized fallback (no joins, or no
    factorized plan)."""
    def col_of(slots, s):
        return int(rng.integers(0, len(rels[slots[s]])))

    def filt(slots):
        s = int(rng.integers(0, len(slots)))
        c = col_of(slots, s)
        col = rels[slots[s]][c]
        op = str(rng.choice(["<", ">", "="], p=[0.45, 0.45, 0.1]))
        return f"{s}.{c}{op}{int(col[int(rng.integers(0, len(col)))])}"

    def projs(slots):
        return " ".join(f"{int(s)}.{col_of(slots, int(s))}" for s in
                        rng.integers(0, len(slots), int(rng.integers(1, 4))))

    lines, kinds, tries = [], [], 0
    while len(lines) < n_queries:
        tries += 1
        if tries > 50 * n_queries:
            raise AssertionError("could not generate fallback queries")
        kind = ("cycle", "same_slot", "no_join")[len(lines) % 3]
        if kind == "cycle":
            slots = [int(x) for x in rng.choice(len(rels), 3, replace=False)]
            preds = [f"0.{col_of(slots, 0)}=1.{col_of(slots, 1)}",
                     f"1.{col_of(slots, 1)}=2.{col_of(slots, 2)}",
                     f"2.{col_of(slots, 2)}=0.{col_of(slots, 0)}"]
        elif kind == "same_slot":
            slots = [int(x) for x in rng.integers(0, len(rels),
                                                  int(rng.integers(1, 3)))]
            a, b = rng.choice(len(rels[slots[0]]), 2, replace=False)
            preds = [f"0.{int(a)}=0.{int(b)}"]
        else:
            slots = [int(x) for x in rng.integers(0, len(rels),
                                                  int(rng.integers(1, 3)))]
            preds = []
        preds += [filt(slots) for _ in range(int(rng.integers(
            0 if preds else 1, 3)))]
        line = f"{' '.join(map(str, slots))}|{'&'.join(preds)}|" \
               f"{projs(slots)}"
        q = parse_query(line)
        if not q.joins or batch_executor._ftree_plan_for(q) is None:
            lines.append(line)
            kinds.append(kind)
    return lines, kinds


def contest_work(tree: List[str], extra: List[str]) -> List[str]:
    """The 70-query work stream: the tree queries' batches, then the
    fallback queries in two batches of ten."""
    return tree + extra[:10] + ["F"] + extra[10:] + ["F"]


def contest_catalog(tuples: int = CONTEST_TUPLES):
    """The synthetic catalog's columns and its 50 tree queries' lines, from
    one default_rng(CONTEST_SEED)."""
    rng = np.random.default_rng(CONTEST_SEED)
    cols = make_contest_catalog(rng, total=tuples)
    return cols, make_tree_queries(rng, cols)


def fallback_queries(cols, batch_executor):
    """The 20 fallback queries' lines and kinds, from
    default_rng(FALLBACK_SEED), as `batch_executor`'s tree planner picks
    them."""
    return make_fallback_queries(np.random.default_rng(FALLBACK_SEED), cols,
                                 batch_executor)


def contest_workload(engine_for, tuples: int = CONTEST_TUPLES):
    """The synthetic workload: (engine, batches, the oracle's lines),
    `engine_for(relations)` building the engine whose tree planner picks
    the fallback queries."""
    cols, tree = contest_catalog(tuples)
    rels = [Relation(c) for c in cols]
    engine = engine_for(rels)
    extra, _kinds = fallback_queries(cols, engine.batch_executor)
    batches = parse_work_stream(contest_work(tree, extra))
    return engine, batches, run_workload(rels, batches)


def golden_workload(engine_for, data: str):
    """The reference's layout under `data`: (engine, batches, the lines
    of small.result)."""
    engine = engine_for([load_relation(os.path.join(data, f"r{i}"))
                         for i in range(14)])
    with open(os.path.join(data, "small.work")) as f:
        batches = parse_work_stream(f)
    with open(os.path.join(data, "small.result")) as f:
        golden = [ln.rstrip("\n") for ln in f]
    return engine, batches, golden


def main(argv: Optional[Sequence[str]] = None,
         out: TextIO = sys.stdout) -> int:
    p = argparse.ArgumentParser(
        prog="python -m radixhashjoin_tpu_torch.bench",
        description="end-to-end workload benchmark: one JSON line")
    p.add_argument("--data", metavar="DIR",
                   help="r0..r13, small.work and small.result (default: "
                        "the synthetic contest-shaped workload)")
    p.add_argument("--tuples", type=int, default=CONTEST_TUPLES,
                   help="tuples of the synthetic catalog")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    profile = bool(os.environ.get("RHJ_PROFILE"))

    def engine_for(rels):
        return Engine(rels, EngineConfig(profile=profile), device=dev)
    if args.data:
        engine, batches, want = golden_workload(engine_for, args.data)
    else:
        engine, batches, want = contest_workload(engine_for, args.tuples)
    bex = engine.batch_executor
    on_card = dev.type == "cuda"

    t0 = time.perf_counter()
    got, launches = kernels.counted(lambda: engine.run_workload(batches))
    cold_wall = time.perf_counter() - t0
    if got != want:
        print(json.dumps({"metric": "small_workload_wall_s", "value": -1,
                          "unit": "s", "vs_baseline": None,
                          "error": "output mismatch vs the expected lines"}),
              file=out)
        return 1
    if profile:
        bex.profiler.reset()
    wall = float("inf")
    for _ in range(WARM_PASSES):
        bex.counters = {k: 0 for k in bex.counters}
        t0 = time.perf_counter()
        got = engine.run_workload(batches)
        wall = min(wall, time.perf_counter() - t0)
        if got != want:
            raise AssertionError("a warm pass differs from the expected "
                                 "lines")
    if profile:
        print(bex.profiler.report(), file=sys.stderr)
    print(json.dumps({
        "metric": "small_workload_wall_s",
        "value": wall if on_card else "not measured",
        "unit": "s",
        # the reference binary's 201.1 s was timed on another host, never
        # on the card's, so no ratio against it is made
        "vs_baseline": None,
        "cold_wall_s": cold_wall if on_card else "not measured",
        **bex.counters,
        "queries": len(want), "launches": launches, "exact": True,
        "data": args.data or f"synthetic contest-shaped, {args.tuples} "
                             f"tuples (seeds {CONTEST_SEED}, "
                             f"{FALLBACK_SEED})",
        "device": (torch.cuda.get_device_name(dev) if on_card
                   else "cpu")}), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
