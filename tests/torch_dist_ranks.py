"""Rank-side halves of the port's distributed tests
(tests/test_torch_parallel.py, tests/test_torch_dist_engine.py,
tests/test_torch_exchange_overlap.py, tests/test_torch_dist_bench.py).

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
from radixhashjoin_tpu_torch import bench_dist_scale
from radixhashjoin_tpu_torch.parallel import dist_join, dist_ops
from radixhashjoin_tpu_torch.parallel.dist_executor import DistExecutor
from radixhashjoin_tpu_torch.parallel.mesh import Mesh
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


# ---- the pipelined chunk loops (tests/test_torch_exchange_overlap.py) ----

class RecordingMesh(Mesh):
    """A Mesh over the same world that appends each collective's issue
    ("issue", id, kind) and wait ("wait", id) to `log`; a blocking call
    logs its issue and its wait back to back."""

    def __init__(self, mesh: Mesh, log: list):
        super().__init__(mesh.rank, mesh.size, mesh.device, mesh.group)
        self.log = log
        self._issued = 0

    def _record(self, kind, pending, async_op):
        i = self._issued
        self._issued += 1
        self.log.append(("issue", i, kind))
        wait = pending.wait

        def logged():
            self.log.append(("wait", i))
            return wait()
        pending.wait = logged
        return pending if async_op else pending.wait()

    def all_to_all(self, t, async_op=False):
        return self._record("all_to_all", super().all_to_all(t, True),
                            async_op)

    def all_gather(self, t, async_op=False):
        return self._record("all_gather", super().all_gather(t, True),
                            async_op)


def _log_compute(log: list):
    """Wrap dist_ops' probe, right-side sort and local gather so that each
    call appends ("probe",), ("sort",) or ("gather",) to `log`."""
    for name, tag in (("_searchsorted", "probe"), ("_stable_argsort", "sort"),
                      ("gather_clamped", "gather")):
        fn = getattr(dist_ops, name)

        def logged(*a, _fn=fn, _tag=tag):
            log.append((_tag,))
            return _fn(*a)
        setattr(dist_ops, name, logged)


def _local(mesh, shards):
    return _t(shards[mesh.rank])


def overlap_cases(mesh, case1, gather, bcast, engine):
    """The chunk loops of dist_ops on this rank's shards, each call under
    a RecordingMesh: d_case1_probe (and its pairs) at K = 1, 2, 4;
    _dist_gather at 4 and 1 sub-gathers; d_eq_mat's pair-set test,
    d_case2_probe and d_case2_expand at 4 and 1 broadcast chunks; then the
    engine cases (engine_cases). Returns {name: (result, log, the
    RecordingMesh's calls)} and the engine cases' results."""
    torch.set_num_threads(1)
    log: list = []
    _log_compute(log)
    out = {}

    def run(name, fn):
        log.clear()
        rmesh = RecordingMesh(mesh, log)
        res = fn(rmesh)
        out[name] = (res, list(log), dict(rmesh.calls))

    lrows = _local(mesh, case1["lrows"])
    rrows = _local(mesh, case1["rrows"])
    colA, colB = _local(mesh, case1["colA"]), _local(mesh, case1["colB"])
    lc = torch.tensor(int(case1["lc"][mesh.rank]), dtype=torch.int32)
    rc = torch.tensor(int(case1["rc"][mesh.rank]), dtype=torch.int32)
    for k in (1, 2, 4):
        def case1_k(rmesh, k=k):
            res = dist_ops.d_case1_probe(rmesh, case1["heavy"], k, colA,
                                         colB, lrows, lc, rrows, rc)
            total = int(res[6])
            pairs = dist_ops.d_case1_expand(max(total, 1), *res[:6])
            return pairs[:, :total].numpy(), res[7].numpy()
        run(f"case1_k{k}", case1_k)

    col = _local(mesh, gather["col"])
    idxs, live = _t(gather["idxs"]), _t(gather["live"])
    for k in (4, 1):
        run(f"gather_k{k}", lambda rmesh, k=k: tuple(
            np.asarray(v) for v in dist_ops._dist_gather(rmesh, col, idxs,
                                                         live, k, 0)))

    mat = _t(bcast["mat"][mesh.rank])
    icnt = torch.tensor(int(bcast["icnt"][mesh.rank]), dtype=torch.int32)
    cA, cB = _local(mesh, bcast["colA"]), _local(mesh, bcast["colB"])
    frows = _local(mesh, bcast["frows"])
    fc = torch.tensor(int(bcast["fc"][mesh.rank]), dtype=torch.int32)
    for k in (4, 1):
        def eq_mat(rmesh, k=k):
            m, c, found, ovf = dist_ops.d_eq_mat(rmesh, 0, 1, True, cA, cB,
                                                 mat, icnt, bchunks=k)
            return m[:, :int(c)].numpy(), int(found), bool(ovf)
        run(f"eq_mat_k{k}", eq_mat)

        def case2(rmesh, k=k):
            lv, off, _cum, total, stats = dist_ops.d_case2_probe(
                rmesh, 0, cA, mat, icnt, cB, frows, fc, bchunks=k)
            total = int(total)
            return (dist_ops.d_case2_expand(rmesh, max(total, 1), mat, lv,
                                            cB, frows, fc, off, bchunks=k)
                    [:, :total].numpy(), stats.numpy())
        run(f"case2_k{k}", case2)
    return out, engine_cases(mesh, engine)


# ---- the distributed benches (tests/test_torch_dist_bench.py) ----

def dist_bench(mesh, argv, patches):
    """bench_dist_scale's per-rank run on argv, under the _PATCHES named
    in `patches` (shrunken huge-node thresholds). Returns its lines and
    how many windowed huge-node passes (factorized._fused_node_pass)
    ran."""
    torch.set_num_threads(1)
    for name, value in patches.items():
        obj, attr = _PATCHES[name]
        setattr(obj, attr, value)
    passes = []
    fused = factorized._fused_node_pass

    def counted(*a, **k):
        passes.append(1)
        return fused(*a, **k)
    factorized._fused_node_pass = counted
    lines = bench_dist_scale.bench_rank(mesh, bench_dist_scale.parse_args(
        list(argv) + ["--device", "cpu"]))
    return lines, len(passes)
