"""Scaling-efficiency harness of the port (counterpart:
scripts/scale_efficiency.py): engine-level distributed join throughput
at N = {1, 2, 4, 8} ranks, and the efficiency of each N relative to N = 1.

    python -m radixhashjoin_tpu_torch.scale_efficiency [--rows 18] [--ns 1,2,4,8]
    python -m radixhashjoin_tpu_torch.scale_efficiency --device cpu \\
        --rows 12 --ns 1,2

Each N runs in a world of its own (parallel.multihost.run_ranks, the
counterpart of the reference's one subprocess a device count). The
measured step is the engine's real multi-rank join: DistExecutor on two
relations of 2^rows uniform keys below 2^rows / 4 with values below
1000, joined on the key, both value sums projected (the reference's
data, default_rng(0)): the factorized wave, or with --exchange the
case-1 exchange (skew-aware level-0 all_to_all, rank-local sort join,
expansion, cross-rank projections). Each run's lines are held to the
closed form (the sums weighted by the other side's key counts) on its
first, warm run; then, on the card only, the mean of 3 timed runs.

Prints one dist_engine_join_tuples_per_s line per N, then one
scaling_efficiency line per N relative to N = 1. Each line names its
backend and ranks_per_card: N ranks up to the visible cards run NCCL,
one a card; more run gloo ranks sharing card 0, which (like the
reference's virtual CPU devices) validates the harness and the program's
structure, not the scaling. On the CPU (--device cpu) the ranks are gloo
processes and every time says "not measured". Without a card the default
device cuda exits 2.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence, TextIO

import numpy as np
import torch

from . import kernels
from .bench_scale import (NOT_MEASURED, U64, _emit, _rate, _u64_sum, _vals,
                          free_memory)
from .config import EngineConfig
from .models.engine import resolve_device
from .parallel import multihost
from .storage import Relation
from .workload import JoinPred, Projection, Query

ITERS = 3
QUERY = Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
              [Projection(0, 1), Projection(1, 1)])


def uniform_join(log_rows: int):
    """The reference's two relations of n = 2^log_rows rows and the
    closed form's line: each side's values weighted by the other side's
    count of its key."""
    n = 1 << log_rows
    rng = np.random.default_rng(0)
    cols = [(_vals(rng, n // 4, n), _vals(rng, 1000, n)) for _ in range(2)]
    (ka, av), (kb, bv) = cols
    cnt_a, cnt_b = (np.bincount(k.astype(np.intp), minlength=n // 4)
                    .astype(U64) for k in (ka, kb))
    line = (f"{_u64_sum(av * cnt_b[ka.astype(np.intp)])} "
            f"{_u64_sum(bv * cnt_a[kb.astype(np.intp)])}")
    return [Relation(list(c)) for c in cols], line


def worker(mesh, log_rows: int, exchange: bool) -> dict:
    """One rank of an N-rank world: the join, held exact on its warm run
    (its kernel launches counted from 0), then ITERS timed runs on the
    card. Returns this rank's result."""
    import torch.distributed as dist

    from .parallel.dist_executor import DistExecutor
    rels, want = uniform_join(log_rows)
    ex = DistExecutor(rels, EngineConfig(factorized=not exchange),
                      mesh=mesh)
    got, launches = kernels.counted(lambda: ex.run_batch([QUERY]))
    if got != [want]:
        raise AssertionError(f"{mesh.size} ranks: lines {got} != closed "
                             f"form {want}")
    path = "exchange_queries" if exchange else "ftree_queries"
    if ex.counters[path] != 1:
        raise AssertionError(f"not on the {path} path: {ex.counters}")
    seconds = None
    if mesh.device.type == "cuda":
        t0 = time.perf_counter()
        for _ in range(ITERS):
            got = ex.run_batch([QUERY])          # ends in a readback
        seconds = (time.perf_counter() - t0) / ITERS
        if got != [want]:
            raise AssertionError(f"timed run gave {got}")
    del ex
    free_memory(mesh.device)
    return {"seconds": seconds, "sums": got[0], "launches": launches,
            "backend": dist.get_backend()}


def main(argv: Optional[Sequence[str]] = None,
         out: TextIO = sys.stdout) -> int:
    p = argparse.ArgumentParser(
        prog="python -m radixhashjoin_tpu_torch.scale_efficiency",
        description="distributed join throughput by rank count")
    p.add_argument("--rows", type=int, default=18, help="log2 rows a side")
    p.add_argument("--ns", default="1,2,4,8",
                   help="rank counts, comma-separated")
    p.add_argument("--exchange", action="store_true",
                   help="force the exchange path (factorized off)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"scale_efficiency: {e}", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    n_rows = 1 << args.rows
    values = {}
    shape = {}
    for n in (int(x) for x in args.ns.split(",")):
        if dev.type == "cpu":
            where, backend, per_card = "cpu", None, None
        elif n <= cards:
            where, backend, per_card = "cuda", None, 1
        else:                            # ranks sharing card 0
            where, backend, per_card = torch.device("cuda", 0), "gloo", n
        rec = multihost.run_ranks(worker, n, (args.rows, args.exchange),
                                  device=where, backend=backend,
                                  timeout=1800)[0]
        line = _emit(out, {
            "metric": "dist_engine_join_tuples_per_s",
            "path": "exchange" if args.exchange else "ftree",
            "devices": n, "backend": rec["backend"],
            "ranks_per_card": per_card, "rows_per_side": n_rows,
            **_rate(2 * n_rows, rec["seconds"]), "sums": rec["sums"],
            "launches": rec["launches"], "exact": True})
        values[n] = line["value"]
        shape[n] = {"backend": rec["backend"], "ranks_per_card": per_card}
    if 1 in values:
        for n, v in sorted(values.items()):
            eff = (v / (values[1] * n) if isinstance(v, float)
                   and isinstance(values[1], float) else NOT_MEASURED)
            _emit(out, {"metric": "scaling_efficiency", "devices": n,
                        **shape[n], "value": eff,
                        "unit": "fraction_of_linear"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
