"""The port's host modules (radixhashjoin_tpu_torch: config, storage,
workload, oracle, utils.primes, utils.profiling) against their
counterparts in the JAX package, on the same files, streams, queries,
numbers and operator stats: equal values, stats, parsed queries, result
lines, primes and report tables (exact, tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from radixhashjoin_tpu import config as jconfig
from radixhashjoin_tpu import oracle as joracle
from radixhashjoin_tpu import storage as jstorage
from radixhashjoin_tpu import workload as jworkload
from radixhashjoin_tpu.utils import primes as jprimes
from radixhashjoin_tpu.utils import profiling as jprofiling
from radixhashjoin_tpu_torch import config as tconfig
from radixhashjoin_tpu_torch import oracle as toracle
from radixhashjoin_tpu_torch import storage as tstorage
from radixhashjoin_tpu_torch import utils as tutils
from radixhashjoin_tpu_torch import workload as tworkload
from radixhashjoin_tpu_torch.utils import profiling as tprofiling

from test_factorized import _rels

torch.set_num_threads(1)

U64 = np.uint64


def _stream_lines(rng, rels, n_queries=24):
    """Random work-stream lines: joins of any shape (cycles, same-slot
    and case-1 wipes included), filters, projections, F every 5."""
    lines = []
    for qi in range(n_queries):
        nslots = int(rng.integers(1, 5))
        slots = [int(rng.integers(0, len(rels))) for _ in range(nslots)]
        ncols = [rels[s].num_columns for s in slots]
        preds = []
        for _ in range(int(rng.integers(0, 4))):
            a, b = (int(x) for x in rng.integers(0, nslots, 2))
            preds.append(f"{a}.{int(rng.integers(0, ncols[a]))}"
                         f"{rng.choice(['=', '<', '>'])}"
                         f"{b}.{int(rng.integers(0, ncols[b]))}")
        for _ in range(int(rng.integers(0, 3))):
            s = int(rng.integers(0, nslots))
            preds.append(f"{s}.{int(rng.integers(0, ncols[s]))}"
                         f"{rng.choice(['=', '<', '>'])}"
                         f"{int(rng.integers(0, 70))}")
        projs = [f"{int(s)}.0" for s in rng.integers(0, nslots,
                                                     int(rng.integers(1, 4)))]
        lines.append(f"{' '.join(map(str, slots))}|{'&'.join(preds)}|"
                     f"{' '.join(projs)}")
        if qi % 5 == 4:
            lines.append("F")
    return lines


def _fields(q):
    return (q.slots, [dataclasses.astuple(j) for j in q.joins],
            [dataclasses.astuple(f) for f in q.filters],
            [dataclasses.astuple(p) for p in q.projections], q.text)


@pytest.mark.parametrize("seed", range(3))
def test_parse_and_oracle_match_reference(seed):
    rng = np.random.default_rng(300 + seed)
    jrels = _rels(rng, vmax=16)
    trels = [tstorage.Relation(list(r.values)) for r in jrels]
    lines = _stream_lines(rng, jrels)
    ours = tworkload.parse_work_stream(ln + "\n" for ln in lines)
    ref = jworkload.parse_work_stream(ln + "\n" for ln in lines)
    assert [[_fields(q) for q in b] for b in ours] == \
        [[_fields(q) for q in b] for b in ref]
    got = toracle.run_workload(trels, ours)
    want = joracle.run_workload(jrels, ref)
    assert got == want
    assert any(line.startswith("NULL") for line in want)
    assert any(not line.startswith("NULL") for line in want)


def test_oracle_wraps_u64_like_reference():
    top = 2**64 - 3
    cols = [np.array([top, top, 5], U64), np.array([1, 1, 2], U64)]
    q = "0 0|0.1=1.1|0.0 1.0"
    trel, jrel = tstorage.Relation(cols), jstorage.Relation(cols)
    got = toracle.run_workload([trel], [[tworkload.parse_query(q)]])
    want = joracle.run_workload([jrel], [[jworkload.parse_query(q)]])
    assert got == want == [f"{(4 * top + 5) % 2**64} {(4 * top + 5) % 2**64}"]


def test_init_stream_matches_reference():
    lines = ["r0\n", "\n", "/data/r1\n", "Done\n", "0 1|0.0=1.0|0.0\n"]
    assert (tworkload.parse_init_stream(iter(lines))
            == jworkload.parse_init_stream(iter(lines)) == ["r0", "/data/r1"])


def test_relation_files_and_stats_match_reference(tmp_path):
    rng = np.random.default_rng(7)
    cols = [rng.integers(0, 2**63, 500, dtype=np.uint64),
            rng.integers(0, 40, 500).astype(U64),
            np.full(500, 2**31 - 1, U64)]
    path = str(tmp_path / "r0")
    tstorage.write_relation(path, cols)
    jpath = str(tmp_path / "j0")
    jstorage.write_relation(jpath, cols)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    ours, ref = tstorage.load_relation(path), jstorage.load_relation(path)
    assert (ours.num_tuples, ours.num_columns) == (ref.num_tuples,
                                                   ref.num_columns)
    for a, b in zip(ours.values, ref.values):
        np.testing.assert_array_equal(a, b)
    assert ([dataclasses.astuple(s) for s in ours.stats]
            == [dataclasses.astuple(s) for s in ref.stats])
    for c in (1, 2):
        np.testing.assert_array_equal(ours.narrow_column(c),
                                      ref.narrow_column(c))
    empty = tstorage.Relation([np.zeros(0, U64)])
    assert dataclasses.astuple(empty.stats[0]) == (0, 0, 0)
    with open(path, "ab") as f:
        f.write(b"\0" * 8)
    with pytest.raises(AssertionError, match="size mismatch"):
        tstorage.load_relation(path)


@pytest.mark.parametrize("case", ["small_range", "below_rows",
                                  "range_edge", "wide", "one_row"])
def test_relation_stats_by_bincount_match_reference(case):
    """Columns whose values lie below max(rows, 2**20) take their stats
    from one bincount (storage.small_value_counts), the rest from
    np.unique as in the reference: the same min, max and distinct count
    either way."""
    rng = np.random.default_rng(len(case))
    n = 5000
    if case == "small_range":
        col = rng.integers(1000, 3000, n)
    elif case == "below_rows":
        n = (1 << 20) + 4096
        col = rng.integers((1 << 20) - 7, n, n)
    elif case == "range_edge":
        col = rng.integers(0, 1 << 20, n)
        col[:2] = [(1 << 20) - 1, 17]
    elif case == "wide":
        col = rng.integers(1 << 20, 1 << 40, n)
    else:
        n, col = 1, np.array([123456])
    col = col.astype(U64)
    vmax = int(col.max())
    counts = tstorage.small_value_counts(col, vmax)
    assert (counts is None) == (case == "wide")
    ours, ref = tstorage.Relation([col]), jstorage.Relation([col])
    assert (dataclasses.astuple(ours.stats[0])
            == dataclasses.astuple(ref.stats[0]))


def test_config_defaults_match_reference():
    """Every field the port keeps has the reference's default (stage_group
    64 too, by the card's A/B of 64-query rounds against one round);
    every field the reference's engine reads is kept but four. The port
    drops batch_execution (the per-query executor: the batch executor
    answers every query shape, and join_backend="sort" gives its
    materializing sort join), ftree_scatter and ftree_gather (the table
    variants, which lost to the hand kernels on the card: the tensor's
    device picks the one build and lookup) and ftree_window_sort (the
    sorted huge-node windows, which change no result: one unsorted pass
    runs)."""
    ours = dataclasses.asdict(tconfig.EngineConfig())
    ref = dataclasses.asdict(jconfig.EngineConfig())
    assert set(ours) <= set(ref)
    assert {k: v for k, v in ours.items() if v != ref[k]} == {}
    read = {"force_oracle", "fuse_stages", "stage_group",
            "defer_middle", "speculate_expansions", "speculate_slack",
            "speculate_max", "factorized", "ftree_wave",
            "use_native_runtime", "profile", "skew_heavy_fraction",
            "exchange_chunks", "gather_chunks", "broadcast_chunks",
            "gather_capacity", "enable_join_reordering", "join_backend",
            "max_dense_domain", "mesh_devices", "min_pad", "pad_base"}
    dropped = {"batch_execution", "ftree_scatter", "ftree_gather",
               "ftree_window_sort"}
    assert set(ours) == read
    assert dropped <= set(ref) and not dropped & set(ours)


def test_primes_match_reference():
    ns = list(range(-3, 2000)) + [2**31 - 1, 2**31, 10**9 + 7, 10**12 + 39]
    for name in ("is_prime", "next_prime", "next_pow2"):
        assert ([getattr(tutils, name)(n) for n in ns]
                == [getattr(jprimes, name)(n) for n in ns]), name
    assert [tutils.pow2(k) for k in range(70)] == [
        jprimes.pow2(k) for k in range(70)]


def test_profiler_disabled_is_a_no_op():
    prof = tprofiling.OpProfiler()
    x = torch.arange(10)
    out = (x, [x])
    assert prof.record("op", out, (x,)) is out
    assert not prof.ops
    assert prof.report() == "(no ops recorded)"


def test_profiler_counts_bytes_and_no_cpu_roofline():
    """Bytes are the inputs' plus every output tensor's (tuples and lists
    walked); a CPU op has no roofline, and neither has the CPU device."""
    prof = tprofiling.OpProfiler(True)
    a = torch.zeros(100, dtype=torch.int32)
    b = torch.zeros(7, dtype=torch.int64)
    result = (a, [b, (a[:10],)], 3, None)
    assert prof.record("op", result, (a, b)) is result
    prof.record("op", b)
    s = prof.ops["op"]
    assert s.calls == 2
    assert s.bytes == (400 + 56) + (400 + 56 + 40) + 56
    assert tprofiling.arr_bytes(a, [b, (b,)], 5) == 400 + 112
    assert s.device == torch.device("cpu")
    assert s.roofline_frac is None
    assert tprofiling.hbm_bytes_per_s(torch.device("cpu")) is None
    prof.reset()
    assert not prof.ops


def test_profiler_report_matches_reference():
    """The same stats render the reference's table, line for line (no
    roofline column on the CPU in either)."""
    stats = {"stage": (3, 0.25, 10**9), "filter": (12, 0.0123, 5 * 10**6),
             "probe": (1, 0.0, 0)}
    tp, jp = tprofiling.OpProfiler(True), jprofiling.OpProfiler(True)
    for name, (calls, sec, nbytes) in stats.items():
        tp.ops[name] = tprofiling.OpStats(calls, sec, nbytes,
                                          torch.device("cpu"))
        jp.ops[name] = jprofiling.OpStats(calls, sec, nbytes)
    assert tp.report() == jp.report()
    assert tp.ops["stage"].gb_per_s == jp.ops["stage"].gb_per_s == 4.0
