"""Data-scale distributed benchmark of the port (counterpart:
scripts/bench_dist_scale.py): both distributed engine paths at
2^rows-per-chip rows a rank, one JSON line per measurement, with the
reference script's metric names and flags.

    python -m radixhashjoin_tpu_torch.bench_dist_scale [--rows-per-chip 22]
    python -m radixhashjoin_tpu_torch.bench_dist_scale --device cpu \\
        --devices 2 --rows-per-chip 12

Configs, drawn from one np.random.default_rng(0) stream in the
reference's order:

  dist_star_ftree_tuples_per_s     A: fact(k1, k2, v) ⋈ dim1 ⋈ dim2, two
                                   2^20-row dimensions (bench_scale.star),
                                   through the DistExecutor's factorized
                                   wave (d_ftree), one wave
  dist_exchange_join_tuples_per_s  B (not with --ftree-only): two sides of
                                   permutation keys (every row matches
                                   once) through the case-1 exchange
                                   (d_case1_probe, d_case1_expand) and
                                   d_project's cross-rank gathers at
                                   global rowids; gather_chunks=1, so the
                                   request matrix shrinks by the capacity
                                   bound alone

Each path's lines are held to the closed-form NumPy oracle before
anything is timed (the star's unique dimension keys and the permutation
keys make each sum a direct formula), and the star to one factorized
query. Timing, on the card only: the host clock around ITERS runs after
WARMUP untimed ones (the first held exact), each ending in a readback.

Per-rank memory: the executor's operators are wrapped inside every rank
(the reference's spy), recording each one's last call; after a config's
timed runs each is called once more on those arguments under
torch.cuda.reset_peak_memory_stats(): `argument` and `output` are the
bytes of its tensors, `peak_above_entry` the allocator's peak above what
was allocated when the call began. The reference reads XLA's compiled
memory statistics instead (the port measures at run time: ROADMAP §3);
d_project is called again with gcap=0 for the worst-case line. On the
CPU (--device cpu) every check runs and every byte and time field says
"not measured". Without a card the default device cuda exits 2.

--devices N: N ranks (0: the visible cards on cuda, 1 on the CPU); one
rank runs in this process as a world of one (NCCL on the card), more
are spawned (one a card, gloo on the CPU). --overfill gives each rank
1.25x 2^rows-per-chip real rows, so a shard's slice crosses the
huge-node threshold at 2^28 rows a rank and the validity mask covers
the pad.
"""

from __future__ import annotations

import argparse
import inspect
import sys
import time
from typing import List, Optional, Sequence, TextIO

import numpy as np
import torch

from . import bench_scale, kernels
from .bench_kernels import WARMUP
from .bench_scale import (ITERS, N_KEYS, NOT_MEASURED, U64, Case, _emit,
                          _rate, _u64_sum, _vals, free_memory)
from .config import EngineConfig
from .models.engine import resolve_device
from .parallel import dist_executor, multihost
from .storage import Relation
from .workload import JoinPred, Projection, Query

# the executor's operators whose memory the bench reports
SPIED = ("d_ftree", "d_case1_probe", "d_case1_expand", "d_project")

EXCHANGE_QUERY = Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
                       [Projection(0, 1), Projection(1, 1)])


def exchange(n: int, rng: np.random.Generator) -> Case:
    """Config B: A(ka, av) ⋈ B(kb, bv) on permutation keys of n rows a
    side, so every row matches exactly once and each sum is its side's
    value sum."""
    ka, kb = (rng.permutation(n).astype(U64) for _ in range(2))
    av, bv = _vals(rng, 1000, n), _vals(rng, 1000, n)
    return Case([Relation([ka, av]), Relation([kb, bv])], EXCHANGE_QUERY,
                [f"{_u64_sum(av)} {_u64_sum(bv)}"])


class Spy:
    """Wraps the executor's module-level operator names (SPIED) while
    open: `calls[name]` is the (args, kwargs) of each one's last call,
    `orig[name]` the operator itself."""

    def __enter__(self):
        self.orig = {name: getattr(dist_executor, name) for name in SPIED}
        self.calls = {}
        for name, fn in self.orig.items():
            setattr(dist_executor, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def run(*a, **k):
            self.calls[name] = (a, k)
            return fn(*a, **k)
        return run

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(dist_executor, name, fn)


def _tensors(obj) -> dict:
    """{(data_ptr, shape, dtype): bytes} of the tensors in a nest of
    tuples and lists, each counted once."""
    if isinstance(obj, torch.Tensor):
        return {(obj.data_ptr(), tuple(obj.shape), obj.dtype):
                obj.numel() * obj.element_size()}
    out = {}
    if isinstance(obj, (tuple, list)):
        for o in obj:
            out.update(_tensors(o))
    return out


def mem_line(tag: str, fn, a, k, dev: torch.device, **extra) -> dict:
    """fn(*a, **k) once more, its memory on this rank: argument and output
    bytes, and the allocator's peak above its entry (the card only)."""
    fields = dict.fromkeys(("argument", "output", "peak_above_entry"),
                           NOT_MEASURED)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*a, **k)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        fields = {"argument": sum(_tensors((a, list(k.values()))).values()),
                  "output": sum(_tensors(out).values()),
                  "peak_above_entry":
                      torch.cuda.max_memory_allocated(dev) - base}
    del out
    return {"metric": f"dist_mem_{tag}", "unit": "bytes_per_chip", **fields,
            **extra}


def _exact_then_timed(ex, case: Case, dev: torch.device, path: str):
    """The case's query through the executor: held exact on its first
    run (whose kernel launches are counted from 0), which must take the
    executor's `path` ("ftree_queries" or "exchange_queries"), then on
    the card WARMUP - 1 untimed and ITERS timed runs. Returns (lines,
    seconds a run or None off the card, launches)."""
    what = f"{path} config"
    got, launches = kernels.counted(lambda: ex.run_batch([case.query]))
    if got != case.expected:
        raise AssertionError(f"{what}: lines {got} != closed form "
                             f"{case.expected}")
    if ex.counters[path] != 1:
        raise AssertionError(f"{what}: not one query on that path: "
                             f"{ex.counters}")
    seconds = None
    if dev.type == "cuda":
        for _ in range(WARMUP - 1):
            ex.run_batch([case.query])
        t0 = time.perf_counter()
        for _ in range(ITERS):
            got = ex.run_batch([case.query])      # ends in a readback
        seconds = (time.perf_counter() - t0) / ITERS
        if got != case.expected:
            raise AssertionError(f"{what}: timed run gave {got}")
    return got, seconds, launches


def _catalog_bytes(ex, dev: torch.device):
    if dev.type != "cuda":
        return NOT_MEASURED
    return sum(t.numel() * t.element_size()
               for t in ex.catalog._cols.values())


def bench_rank(mesh, args) -> List[dict]:
    """One rank's whole run; every rank returns the same lines (rank 0's
    are printed)."""
    import torch.distributed as dist

    from .parallel.dist_executor import DistExecutor
    dev = mesh.device
    ndev = mesh.size
    per = 1 << args.rows_per_chip
    n = ndev * per * 5 // 4 if args.overfill else ndev * per
    rng = np.random.default_rng(0)
    common = {"devices": ndev, "backend": dist.get_backend()}
    lines = []
    with Spy() as spy:
        # config A: the star through the distributed factorized wave
        case = bench_scale.star(n, rng, N_KEYS)
        ex = DistExecutor(case.rels, EngineConfig(), mesh=mesh)
        got, seconds, launches = _exact_then_timed(ex, case, dev,
                                                   "ftree_queries")
        lines.append({"metric": "dist_star_ftree_tuples_per_s", **common,
                      "fact_rows": n, "rows_per_chip": per,
                      "dim_rows": N_KEYS, "exact_vs_oracle": True,
                      "catalog_bytes_per_chip": _catalog_bytes(ex, dev),
                      **_rate(n + 2 * N_KEYS, seconds), "sums": got[0],
                      "launches": launches, "exact": True})
        a, k = spy.calls["d_ftree"]
        lines.append(mem_line("d_ftree_star", spy.orig["d_ftree"], a, k, dev,
                              rows_per_chip=per, devices=ndev))
        del ex, case, a, k
        spy.calls.clear()
        free_memory(dev)
        if args.ftree_only:
            return lines

        # config B: the case-1 exchange, then d_project's gathers
        case = exchange(n, rng)
        ex = DistExecutor(case.rels, EngineConfig(factorized=False,
                                                  gather_chunks=1),
                          mesh=mesh)
        got, seconds, launches = _exact_then_timed(ex, case, dev,
                                                   "exchange_queries")
        lines.append({"metric": "dist_exchange_join_tuples_per_s", **common,
                      "rows_per_side": n, "rows_per_chip": per,
                      "exact_vs_oracle": True,
                      "gather_retries": ex.counters["gather_retries"],
                      **_rate(2 * n, seconds), "sums": got[0],
                      "launches": launches, "exact": True})
        del ex
        for name in ("d_case1_probe", "d_case1_expand"):
            a, k = spy.calls[name]
            extra = ({"out_cap": a[0]} if name == "d_case1_expand" else {})
            lines.append(mem_line(name, spy.orig[name], a, k, dev,
                                  rows_per_chip=per, devices=ndev, **extra))
        # the request-matrix shrink: the executor's gcap against the
        # worst-case capacity, on the same arguments
        fn = spy.orig["d_project"]
        bound = inspect.signature(fn).bind(*spy.calls["d_project"][0],
                                           **spy.calls["d_project"][1])
        for tag, gcap in (("d_project_gcap", bound.arguments.get("gcap", 0)),
                          ("d_project_worst_case", 0)):
            bound.arguments["gcap"] = gcap
            lines.append(mem_line(tag, fn, bound.args, bound.kwargs, dev,
                                  gcap=gcap, rows_per_chip=per,
                                  devices=ndev))
        spy.calls.clear()
    free_memory(dev)
    return lines


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m radixhashjoin_tpu_torch.bench_dist_scale",
        description="data-scale distributed benchmark: one JSON line per "
                    "measurement")
    p.add_argument("--rows-per-chip", type=int, default=22,
                   help="log2 fact rows a rank (default 2^22)")
    p.add_argument("--devices", type=int, default=0,
                   help="ranks (0 = the visible cards on cuda, 1 on the "
                        "CPU)")
    p.add_argument("--ftree-only", action="store_true",
                   help="skip the exchange config")
    p.add_argument("--overfill", action="store_true",
                   help="1.25x 2^rows-per-chip real rows a rank, so a "
                        "shard's slice crosses the huge-node threshold")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         out: TextIO = sys.stdout) -> int:
    args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_dist_scale: {e}", file=sys.stderr)
        return 2
    ndev = args.devices or (torch.cuda.device_count() if dev.type == "cuda"
                            else 1)
    for line in multihost.run_world(bench_rank, ndev, (args,), device=dev):
        _emit(out, line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
