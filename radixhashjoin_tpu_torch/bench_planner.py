"""Join-reordering planner measurement of the port (counterpart:
scripts/bench_planner.py): the workload where the written join order is
adversarial, run with EngineConfig.enable_join_reordering off and on, exact
against the port's oracle both ways. Prints ONE JSON line.

    python -m radixhashjoin_tpu_torch.bench_planner [--log-rows 18]
    python -m radixhashjoin_tpu_torch.bench_planner --device cpu --log-rows 12

  R0 (fact A, N rows):  col0 = a key with N/D copies of each of D values,
                        col1 = a key into R2, col2 = values
  R1 (fact B, N rows):  col0 = the same D-value key
  R2 (dim, M = 2^14 rows): col0 = a unique key, col1 = values

  query: 0 1 2 | 0.0=1.0 & 0.1=2.0 & 2.0<16 | 0.2 1.1 2.1

The written order joins fact with fact first (about N · N/D intermediate
pairs); the planner (models/planner.py, the reference's estimator in
models/stats.py) prices the filtered dimension join cheapest and hoists
it. The factorized wave never materializes intermediates, so the order
matters on the materialized path: both runs use factorized=False and
join_backend="sort" (the batch executor's per-op sort join, one query a
call), as the reference's materializing runs do. The materialized
join's cap of 2^31 - 1 pairs (JoinCapacityError) stays.

Each run is held exact against OracleExecutor on each of WARMUP untimed
calls (`launches_written`, `launches_reordered`: the kernel launches of
the first, counted from 0; the sort join probes with ops/join.py, so
the build and lookup kernels are not on this path); then one call is
timed by the host clock (it ends in a readback). On the CPU (--device
cpu) both runs are held exact on the plain versions and nothing is
timed: the walls say "not measured".
Without a card the default device cuda exits 2. The relations come from
np.random.default_rng(7), as the reference's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Sequence, TextIO

import numpy as np
import torch

from . import kernels
from .bench_kernels import WARMUP
from .config import EngineConfig
from .models.engine import Engine, resolve_device
from .models.planner import reorder_joins
from .oracle import OracleExecutor
from .storage import Relation
from .workload import FilterPred, JoinPred, Projection, Query

SEED = 7
DIM_ROWS = 1 << 14
SEL_K = 16                    # the dimension filter keeps col0 < 16

QUERY = Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
              [FilterPred(2, 0, "<", SEL_K)],
              [Projection(0, 2), Projection(1, 1), Projection(2, 1)])


def make_relations(n: int, d: int, rng: np.random.Generator
                   ) -> List[Relation]:
    """R0, R1, R2 of the module doc: n fact rows, d distinct fact keys."""
    m = DIM_ROWS
    r0 = Relation([rng.integers(0, d, n).astype(np.uint64),
                   rng.integers(0, m, n).astype(np.uint64),
                   rng.integers(0, 1000, n).astype(np.uint64)])
    r1 = Relation([rng.integers(0, d, n).astype(np.uint64),
                   rng.integers(0, 1000, n).astype(np.uint64)])
    r2 = Relation([np.arange(m, dtype=np.uint64),
                   rng.integers(0, 1000, m).astype(np.uint64)])
    return [r0, r1, r2]


def chosen_order(rels: Sequence[Relation]) -> List[str]:
    """The planner's join order for QUERY, as "slot.col=slot.col"."""
    return [f"{j.slot1}.{j.col1}={j.slot2}.{j.col2}"
            for j in reorder_joins(QUERY, rels).joins]


def main(argv: Optional[Sequence[str]] = None,
         out: TextIO = sys.stdout) -> int:
    p = argparse.ArgumentParser(
        prog="python -m radixhashjoin_tpu_torch.bench_planner",
        description="join reordering off and on, on the materialized "
                    "path: one JSON line")
    p.add_argument("--log-rows", type=int, default=18)
    p.add_argument("--log-distinct", type=int, default=14)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_planner: {e}", file=sys.stderr)
        return 2
    n, d = 1 << args.log_rows, 1 << args.log_distinct
    rels = make_relations(n, d, np.random.default_rng(SEED))
    expect = OracleExecutor(rels).execute(QUERY)
    on_card = dev.type == "cuda"
    line = {"metric": "planner_reorder_wall_s",
            "platform": "gpu" if on_card else "cpu",
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "rows": n, "distinct": d, "dim_rows": DIM_ROWS, "sel_k": SEL_K,
            # the written order's first join: n rows against n rows over d
            # values
            "written_first_join_pairs_est": n * n // d,
            "chosen_order": chosen_order(rels), "unit": "s"}
    for label, flag in (("written", False), ("reordered", True)):
        eng = Engine(rels, EngineConfig(factorized=False,
                                        join_backend="sort",
                                        enable_join_reordering=flag),
                     device=dev)
        for i in range(WARMUP if on_card else 1):
            got, counts = kernels.counted(lambda: eng.execute(QUERY))
            if i == 0:
                line["launches_" + label] = counts
            if got != expect:
                raise AssertionError(f"{label}: {got} != oracle {expect}")
        if on_card:
            t0 = time.perf_counter()
            got = eng.execute(QUERY)               # ends in a readback
            line[label] = time.perf_counter() - t0
            if got != expect:
                raise AssertionError(f"{label}: timed run gave {got}")
        else:
            line[label] = "not measured"
        del eng
    line["speedup"] = (line["written"] / max(line["reordered"], 1e-9)
                       if on_card else "not measured")
    line["exact_vs_oracle"] = True
    print(json.dumps(line), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
