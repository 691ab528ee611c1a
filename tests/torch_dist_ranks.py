"""Rank-side halves of the port's distributed tests
(tests/test_torch_parallel.py, tests/test_torch_dist_engine.py).

Each function here is the target of parallel.multihost.run_ranks: it
runs in a spawned gloo rank, takes every case of one world size at once
(one spawned group per test module and world size), and returns plain
Python / numpy results to the pytest process, which holds them against
the JAX package and the oracle. This module imports the port only, never
jax: the spawned ranks import it by name.
"""

from __future__ import annotations

import numpy as np
import torch

from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.ops import factorized
from radixhashjoin_tpu_torch.oracle import format_result
from radixhashjoin_tpu_torch.parallel import dist_join, dist_ops
from radixhashjoin_tpu_torch.parallel.dist_executor import DistExecutor
from radixhashjoin_tpu_torch.storage import Relation
from radixhashjoin_tpu_torch.utils import limbs
from radixhashjoin_tpu_torch.workload import parse_query


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _record_digits(seen: list):
    """Wrap the distributed layer's partition_by_digit so that every
    digit vector it bins is recorded as (min, max, n_bins)."""
    orig = dist_ops.partition_by_digit

    def checked(digit, payloads, n_bins):
        if digit.numel():
            seen.append((int(digit.min()), int(digit.max()), n_bins))
        return orig(digit, payloads, n_bins)
    dist_ops.partition_by_digit = checked
    dist_join.partition_by_digit = checked


def ops_cases(mesh, cases):
    """The radix-exchange join, the rowid gather and the int64 all_reduce
    on this rank's shard of each case. Returns (results, digit ranges)."""
    torch.set_num_threads(1)
    seen: list = []
    _record_digits(seen)
    r = mesh.rank
    out = []
    for c in cases:
        kind = c["kind"]
        if kind in ("exchange", "count_sum", "skewaware"):
            lv, rv = _t(c["lv"][r]), _t(c["rv"][r])
            lc, rc = int(c["lc"][r]), int(c["rc"][r])
            if kind == "exchange":
                lf, rf, ovf = dist_join.radix_exchange(
                    mesh, lv, lc, rv, rc, mesh.size, c["capacity"])
                out.append((lf.numpy(), rf.numpy(), int(ovf)))
            elif kind == "count_sum":
                out.append(dist_join.dist_join_count_sum(
                    mesh, lv, lc, rv, rc, c["capacity"]))
            else:
                out.append(dist_join.dist_join_skewaware(
                    mesh, lv, lc, rv, rc, c["capacity"],
                    c["heavy_fraction"]))
        elif kind == "gather":
            col = _t(c["col"][r])
            idxs, live = _t(c["idxs"]), _t(c["live"])
            res = {}
            for key, chunks, cap in (("base", 1, 0), ("chunked", 8, 0),
                                     ("bounded", 1, c["gcap"])):
                v, ovf = dist_ops._dist_gather(mesh, col, idxs, live,
                                               chunks, cap)
                res[key] = (v.numpy(), bool(ovf))
            out.append(res)
        elif kind == "wrap":
            t = torch.tensor([c["parts"][r]], dtype=torch.int64)
            out.append(int(mesh.all_reduce(t)[0]))
        else:
            raise ValueError(kind)
    return out, seen


def _gather_cap_8(self, m):
    return 8


_PATCHES = {
    "big_wave_rows": (factorized, "_BIG_WAVE_ROWS"),
    "big_window_rows": (limbs, "_BIG_WINDOW_ROWS"),
    "gather_cap": (DistExecutor, "_gather_cap"),
}
_PATCH_VALUES = {"gather_cap": {8: _gather_cap_8}}


def engine_cases(mesh, cases):
    """Each case: (relation column lists, query lines, EngineConfig
    kwargs, patches, mode) through a DistExecutor over this rank's shards;
    mode "batch" runs the queries as one batch (run_batch), "execute" one
    by one. Returns [(lines, counters)] by case."""
    torch.set_num_threads(1)
    out = []
    for cols, lines, cfg, patches, mode in cases:
        saved = {}
        for name, value in patches.items():
            obj, attr = _PATCHES[name]
            saved[name] = getattr(obj, attr)
            setattr(obj, attr, _PATCH_VALUES.get(name, {}).get(value, value))
        try:
            rels = [Relation([np.asarray(c, np.uint64) for c in cs])
                    for cs in cols]
            ex = DistExecutor(rels, EngineConfig(mesh_devices=mesh.size,
                                                 **cfg), mesh=mesh)
            queries = [parse_query(ln) for ln in lines]
            if mode == "batch":
                got = ex.run_batch(queries)
            else:
                got = [format_result(ex.execute(q), len(q.projections))
                       for q in queries]
            out.append((got, dict(ex.counters)))
        finally:
            for name, value in saved.items():
                obj, attr = _PATCHES[name]
                setattr(obj, attr, value)
    return out
