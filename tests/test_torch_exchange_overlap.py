"""The port's pipelined chunk loops (counterpart of
tests/test_exchange_overlap.py, which holds the same structure in XLA's
HLO): radixhashjoin_tpu_torch.parallel.dist_ops on spawned gloo worlds
of 2 and 4 ranks, every case of one world in ONE group (a module-scoped
fixture, tests/torch_dist_ranks.py overlap_cases).

Each call runs under a RecordingMesh that logs every collective's issue
and wait, beside dist_ops' probes (_searchsorted), the right side's sort
(_stable_argsort) and the gathers' local lookups (gather_clamped):

  * d_case1_probe issues exactly K + 1 all_to_alls (the right exchange
    and K left sub-exchanges) for K in {1, 2, 4}; left chunk 0 is issued
    before the right side's sort and waited for after it; chunk k + 1 is
    issued before chunk k is probed, and chunk k is waited for before;
    never more than two left chunks are in flight;
  * _dist_gather's sub-gathers: chunk k + 1's request is issued before
    chunk k's local lookup, and at most two collectives are in flight;
  * the broadcast chunks of d_eq_mat, d_case2_probe and d_case2_expand:
    chunk k + 1's all_gather before chunk k's probe, at most two in
    flight.

Results are exact (tolerance 0): the case-1 pairs of every rank are the
same multiset for K = 1, 2, 4 and equal JAX's d_case1_probe /
d_case1_expand on a mesh of the world's size; the gathers and
broadcasts equal their one-chunk runs; and DistExecutor lines with every
chunk count at K equal each other, JAX's DistExecutor and the oracle.
"""

import numpy as np
import pytest
import torch

from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.parallel import DistExecutor as JaxDist
from radixhashjoin_tpu.parallel import dist_ops as jops
from radixhashjoin_tpu.parallel import make_mesh as jmake_mesh
from radixhashjoin_tpu.storage import Relation as JaxRelation
from radixhashjoin_tpu.workload import parse_query as jparse_query
from radixhashjoin_tpu_torch import oracle as toracle
from radixhashjoin_tpu_torch import storage as tstorage
from radixhashjoin_tpu_torch.parallel import multihost
from radixhashjoin_tpu_torch.workload import parse_query

import torch_dist_ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
KS = (1, 2, 4)
GROUP_TIMEOUT_S = 300
HEAVY = 0.25


def _case1(n):
    """Row-sharded sides of 1024 rows a rank, ragged live counts, one key
    holding 60% of the right rows (its digit is heavy: broadcast)."""
    rng = np.random.default_rng(100 + n)
    cap = 1024
    colA = rng.integers(0, 300, n * cap).astype(np.int32)
    colB = np.where(rng.random(n * cap) < 0.6, 8,
                    rng.integers(0, 300, n * cap)).astype(np.int32)
    rows = np.arange(n * cap, dtype=np.int32)
    lc = np.array([1024, 700, 1024, 1][:n], np.int32)
    rc = np.array([1024, 1024, 300, 1024][:n], np.int32)
    shards = lambda a: list(a.reshape(n, cap))
    return dict(colA=shards(colA), colB=shards(colB), lrows=shards(rows),
                rrows=shards(rows), lc=lc, rc=rc, heavy=HEAVY)


def _gather(n):
    """16384 requests at global rowids of a 4096-row shard a rank: four
    sub-gathers of 4096 lanes (the chunking floor)."""
    rng = np.random.default_rng(200 + n)
    cap, m = 4096, 1 << 14
    return dict(col=list(rng.integers(0, 2**31 - 1, (n, cap), np.int32)),
                idxs=rng.integers(0, n * cap, m).astype(np.int32),
                live=rng.random(m) < 0.9)


def _bcast(n):
    """A (2, 1024) intermediate a rank of global rowids into A (2048 rows
    a rank) and B (1024 rows a rank), values below 50, ragged counts
    with an empty rank."""
    rng = np.random.default_rng(300 + n)
    capA, capB, w = 2048, 1024, 1024
    mat = np.stack([rng.integers(0, n * capA, (n, w)),
                    rng.integers(0, n * capB, (n, w))], 1).astype(np.int32)
    return dict(mat=list(mat), icnt=np.array([1024, 900, 0, 1000][:n]),
                colA=list(rng.integers(0, 50, (n, capA), np.int32)),
                colB=list(rng.integers(0, 50, (n, capB), np.int32)),
                frows=list(np.arange(n * capB, dtype=np.int32)
                           .reshape(n, capB)),
                fc=np.array([1024, 1000, 512, 0][:n]))


def _engine_rels():
    """A(k, v, w) of 2^16 rows ⋈ B(k unique, v, k2) of 2^13 ⋈ C(k, v) of
    512: every A row joins one B row, so the intermediate is ~2^16 / n
    lanes a rank and the gathers chunk at K = 4."""
    rng = np.random.default_rng(7)
    n_a, n_b, n_c = 1 << 16, 1 << 13, 512
    A = [rng.integers(0, n_b, n_a), rng.integers(0, 100, n_a),
         rng.integers(0, 100, n_a)]
    B = [rng.permutation(n_b), rng.integers(0, 100, n_b),
         rng.integers(0, n_c, n_b)]
    C = [np.arange(n_c), rng.integers(0, 1000, n_c)]
    return [[np.asarray(c, np.uint64) for c in r] for r in (A, B, C)]


ENGINE_LINES = [
    "0 1|0.0=1.0|0.1 1.1",                       # case 1, projections
    "0 1 2|0.0=1.0&1.2=2.0|0.2 2.1",             # then case 2
    "0 1|0.0=1.0&0.1=1.1|0.2 1.1",               # then case 3
    "0 1|0.0=1.0&0.1=0.2|1.1",                   # then a joined same-slot
]


def _engine_cases():
    return [(_engine_rels(), ENGINE_LINES,
             {"factorized": False, "exchange_chunks": k, "gather_chunks": k,
              "broadcast_chunks": k}, {}, "execute") for k in KS]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request):
    """(n, [per-rank {name: (result, log, calls)}], [per-rank engine
    results]) of one world size, from one spawned gloo group."""
    n = request.param
    outs = multihost.run_ranks(
        torch_dist_ranks.overlap_cases, n,
        (_case1(n), _gather(n), _bcast(n), _engine_cases()), device="cpu",
        timeout=GROUP_TIMEOUT_S)
    return n, [o[0] for o in outs], [o[1] for o in outs]


def _pos(log, *event):
    """Positions in `log` of the events starting with `event`."""
    return [i for i, e in enumerate(log) if e[:len(event)] == event]


def _issues(log, kind):
    """Issue ids of the collectives of one kind, in issue order."""
    return [e[1] for e in log if e[0] == "issue" and e[2] == kind]


def _check_loop(log, ids, consumers):
    """One pipelined loop: `ids` its chunks' issue ids, `consumers` the
    log positions of their consumers (probes or lookups), in chunk order.
    Chunk k is waited for before its consumer, chunk k + 1 is issued
    before it, and at most two chunks are in flight. Returns the most in
    flight."""
    assert len(ids) == len(consumers)
    issue = {e[1]: i for i, e in enumerate(log) if e[0] == "issue"}
    wait = {e[1]: i for i, e in enumerate(log) if e[0] == "wait"}
    for k, c in enumerate(consumers):
        assert issue[ids[k]] < wait[ids[k]] < c
        if k + 1 < len(ids):
            assert issue[ids[k + 1]] < c, (k, log)
    flying = most = 0
    for e in log:
        if e[0] in ("issue", "wait") and e[1] in ids:
            flying += 1 if e[0] == "issue" else -1
            most = max(most, flying)
    assert most <= 2
    return most


@pytest.mark.parametrize("k", KS)
def test_case1_issues_k_plus_one_all_to_alls(world, k):
    _n, res, _e = world
    for per_rank in res:
        _r, log, calls = per_rank[f"case1_k{k}"]
        assert calls["all_to_all"] == k + 1
        assert len(_issues(log, "all_to_all")) == k + 1
        assert len(_issues(log, "all_gather")) == 1       # the heavy rows


@pytest.mark.parametrize("k", KS)
def test_case1_next_chunk_issued_before_probe(world, k):
    """Left chunk k + 1 is issued before chunk k is probed; the probes
    after the K chunks' probe the heavy left rows, which stay home."""
    _n, res, _e = world
    for per_rank in res:
        _r, log, _c = per_rank[f"case1_k{k}"]
        left = _issues(log, "all_to_all")[1:]
        probes = _pos(log, "probe")
        assert len(probes) == k + 1
        most = _check_loop(log, left, probes[:k])
        assert most == min(k, 2)


@pytest.mark.parametrize("k", KS)
def test_case1_first_left_chunk_in_flight_during_right_sort(world, k):
    _n, res, _e = world
    for per_rank in res:
        _r, log, _c = per_rank[f"case1_k{k}"]
        right, first = _issues(log, "all_to_all")[:2]
        sort, = _pos(log, "sort")
        assert _pos(log, "issue", first)[0] < sort < _pos(log, "wait",
                                                         first)[0]
        # the right side has landed before it sorts
        assert _pos(log, "wait", right)[0] < sort


def test_gather_sub_gathers_pipelined(world):
    """Four sub-gathers: each a request all_to_all, a local lookup and a
    response all_to_all; chunk k + 1's request is issued before chunk k's
    lookup, at most two collectives in flight (one a single chain)."""
    _n, res, _e = world
    for per_rank in res:
        _r, log, calls = per_rank["gather_k4"]
        assert calls["all_to_all"] == 8
        lookups = _pos(log, "gather")
        assert len(lookups) == 4
        # a response is the issue right after a lookup
        resp = [log[p + 1][1] for p in lookups]
        assert all(log[p + 1][0] == "issue" for p in lookups)
        req = [i for i in _issues(log, "all_to_all") if i not in resp]
        assert _check_loop(log, req, lookups) == 2
        flying = most = 0
        for e in log:
            flying += {"issue": 1, "wait": -1}.get(e[0], 0)
            most = max(most, flying)
        assert most == 2
        _r, log, calls = per_rank["gather_k1"]
        assert calls["all_to_all"] == 2


@pytest.mark.parametrize("name,loops", [("eq_mat", 1), ("case2", 2)])
def test_broadcast_chunks_pipelined(world, name, loops):
    """d_eq_mat's pair-set test, and d_case2_probe then d_case2_expand:
    four all_gather chunks a loop, each probed as it lands, chunk k + 1
    issued first."""
    _n, res, _e = world
    for per_rank in res:
        _r, log, calls = per_rank[f"{name}_k4"]
        gathers = _issues(log, "all_gather")
        probes = _pos(log, "probe")
        assert len(gathers) == len(probes) == 4 * loops
        for j in range(loops):
            sl = slice(4 * j, 4 * (j + 1))
            assert _check_loop(log, gathers[sl], probes[sl]) == 2
        _r, log, calls = per_rank[f"{name}_k1"]
        assert calls["all_gather"] == loops


def _sorted_pairs(pairs):
    return sorted(map(tuple, np.asarray(pairs).T.tolist()))


def test_case1_pairs_equal_across_k_and_jax(world):
    """Every rank's case-1 pairs: the same multiset for K = 1, 2, 4, and
    JAX's on a mesh of the world's size (the same routing, so rank by
    rank)."""
    n, res, _e = world
    c = _case1(n)
    cat = lambda key: np.concatenate(c[key])
    jmesh = jmake_mesh(n)
    j = jops.d_case1_probe(jmesh, "x", HEAVY, 1, cat("colA"), cat("colB"),
                           cat("lrows"), c["lc"], cat("rrows"), c["rc"])
    totals = np.asarray(j[6]).reshape(-1)
    cap = max(int(totals.max()), 1)
    jpairs = np.asarray(jops.d_case1_expand(jmesh, "x", cap, *j[:6]))
    assert np.asarray(j[7])[2] == 0                       # no overflow
    for r, per_rank in enumerate(res):
        want = _sorted_pairs(jpairs[:, r * cap:r * cap + totals[r]])
        for k in KS:
            (pairs, stats), _log, _c = per_rank[f"case1_k{k}"]
            assert _sorted_pairs(pairs) == want, (r, k)
            assert stats[2] == 0
    assert sum(totals) > 0


def test_gather_and_broadcast_results_equal_unchunked(world):
    n, res, _e = world
    g = _gather(n)
    live = g["live"]
    col = np.concatenate(g["col"])
    for per_rank in res:
        (v4, o4), _l, _c = per_rank["gather_k4"]
        (v1, o1), _l, _c = per_rank["gather_k1"]
        np.testing.assert_array_equal(v4[live], col[g["idxs"][live]])
        np.testing.assert_array_equal(v4[live], v1[live])
        assert not o4 and not o1
        (m4, f4, ovf4), _l, _c = per_rank["eq_mat_k4"]
        (m1, f1, ovf1), _l, _c = per_rank["eq_mat_k1"]
        np.testing.assert_array_equal(m4, m1)
        assert (f4, ovf4) == (f1, ovf1)
        (e4, s4), _l, _c = per_rank["case2_k4"]
        (e1, s1), _l, _c = per_rank["case2_k1"]
        assert _sorted_pairs(e4) == _sorted_pairs(e1)
        np.testing.assert_array_equal(s4, s1)


def test_lines_equal_across_k_jax_and_oracle(world):
    """DistExecutor lines with every chunk count at K = 1, 2, 4 (the
    case-1 exchange, a case-2 broadcast, a case-3 pair-set test and a
    joined same-slot filter, then the projections' gathers): equal for
    every K, to JAX's DistExecutor on a mesh of the world's size and to
    the oracle."""
    n, _res, engine = world
    rels = _engine_rels()
    oracle = toracle.OracleExecutor([tstorage.Relation(c) for c in rels])
    want = [toracle.format_result(oracle.execute(q), len(q.projections))
            for q in map(parse_query, ENGINE_LINES)]
    ex = JaxDist([JaxRelation(c) for c in rels],
                 JaxConfig(factorized=False), n_devices=n)
    from radixhashjoin_tpu.oracle import format_result
    assert [format_result(ex.execute(q), len(q.projections))
            for q in map(jparse_query, ENGINE_LINES)] == want
    assert "NULL" not in want
    for per_rank in engine:
        for lines, counters in per_rank:
            assert lines == want
            assert counters["exchange_queries"] == len(ENGINE_LINES)
