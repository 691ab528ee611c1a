"""The port's distributed executor as a whole (radixhashjoin_tpu_torch.
parallel.DistExecutor, Engine(mesh_devices=N), --mesh N) on the CPU.

Every case of one world size runs in ONE spawned gloo group of 2 or 4
ranks (a module-scoped fixture, tests/torch_dist_ranks.py engine_cases).
Each rank must print the lines of the port's oracle (which
test_torch_host.py holds equal to JAX's): the fuzz catalogs of
tests/test_fuzz.py with factorized True and False, the Zipf heavy path,
wide values past 2**31, the factorized corners with relations smaller
than the world (ranks with no live row), composite-key fusion, huge
shards under shrunken huge-node thresholds, forced small gather and
exchange capacities (retries), chunked broadcasts equal to unchunked,
and one wave per batch (one per factorized query under
ftree_wave=False). All ranks must agree: every branch reads a
global value. One test holds a few queries, factorized, exchange and
ftree_wave=False, against JAX's DistExecutor on a 4-device mesh, lines and counters; one
runs the CLI with --mesh 2 --device cpu against the single-device port.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.parallel import DistExecutor as JaxDist
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)
from radixhashjoin_tpu_torch import oracle as toracle
from radixhashjoin_tpu_torch import storage as tstorage
from radixhashjoin_tpu_torch.parallel import multihost
from radixhashjoin_tpu_torch.workload import parse_query

import torch_dist_ranks
from test_fuzz import _random_catalog, _random_query
from test_wide import _wide_catalog, _wide_filter_query

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
GROUP_TIMEOUT_S = 300
JAX_COUNTERS = ("ftree_queries", "exchange_queries", "ftree_waves",
                "gather_retries")


def _line(q):
    """A query in the work-stream syntax."""
    preds = ([f"{j.slot1}.{j.col1}={j.slot2}.{j.col2}" for j in q.joins]
             + [f"{f.slot}.{f.col}{f.op}{f.value}" for f in q.filters])
    return (f"{' '.join(map(str, q.slots))}|{'&'.join(preds)}|"
            f"{' '.join(f'{p.slot}.{p.col}' for p in q.projections)}")


def _u64(*cols):
    return Relation([np.array(c, np.uint64) for c in cols])


def _oracle_lines(cols, lines):
    rels = [tstorage.Relation([np.asarray(c, np.uint64) for c in cs])
            for cs in cols]
    oracle = toracle.OracleExecutor(rels)
    return [toracle.format_result(oracle.execute(q), len(q.projections))
            for q in (parse_query(ln) for ln in lines)]


def _case(rels, queries, cfg=None, patches=None, mode="execute"):
    return ([[np.asarray(c) for c in r.values] for r in rels],
            [_line(q) for q in queries], cfg or {}, patches or {}, mode)


def _star(rng, n):
    fact = _u64(rng.integers(0, 100, n), rng.integers(0, 80, n),
                rng.integers(0, 1000, n))
    d1 = _u64(np.arange(100), rng.integers(0, 1000, 100))
    d2 = _u64(np.arange(80), rng.integers(0, 1000, 80))
    star = [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)]
    return [fact, d1, d2], [
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
              [Projection(0, 2), Projection(1, 1)]),
        Query([0, 1, 2], star, [FilterPred(1, 1, "<", 900)],
              [Projection(0, 2), Projection(1, 1), Projection(2, 1)]),
        Query([0, 1, 2], star, [FilterPred(0, 2, "<", 700)],
              [Projection(0, 2), Projection(2, 1)]),
        Query([0, 1, 2], star, [FilterPred(1, 1, "=", 55555)],
              [Projection(0, 2)]),
    ]


def _cases():
    """{name: case} of every engine case (the same for every world)."""
    cases = {}
    for seed in range(2):
        for fact in (True, False):
            rng = np.random.default_rng(3000 + seed)
            rels = _random_catalog(rng)
            queries = [_random_query(rng, rels) for _ in range(6)]
            cases[f"fuzz{seed}_{'ftree' if fact else 'exchange'}"] = _case(
                rels, queries, {"factorized": fact})
    # one key owns ~60% of both sides: its digit is globally heavy on 2
    # and 4 ranks, so the broadcast path must engage
    rng = np.random.default_rng(42)
    n = 4096
    k1 = np.where(rng.random(n) < 0.6, 24, rng.integers(0, 500, n))
    k2 = np.where(rng.random(n) < 0.6, 24, rng.integers(0, 500, n))
    cases["zipf_heavy"] = _case(
        [_u64(k1, rng.integers(0, 100, n)), _u64(k2, rng.integers(0, 100, n))],
        [Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(0, 1, "<", 90)],
               [Projection(0, 1), Projection(1, 1)])],
        {"skew_heavy_fraction": 0.25, "factorized": False})
    for fact in (True, False):
        rng = np.random.default_rng(11)
        rels = _wide_catalog(rng)
        queries = [_wide_filter_query(rng, rels, _random_query(rng, rels))
                   for _ in range(4)]
        cases[f"wide_{'ftree' if fact else 'exchange'}"] = _case(
            rels, queries, {"factorized": fact})
    # relations smaller than the world, row counts not divisible by it,
    # trailing join-born selections, a case-1-wiped component
    A = _u64([1, 2, 5], [2, 9, 9])
    B = _u64(np.arange(13) % 4, np.arange(13))
    C = _u64([2, 2, 3])
    cases["ftree_corners"] = _case([A, B, C], [
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
              [Projection(0, 1), Projection(1, 1)]),
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 0, 1)],
              [], [Projection(0, 0), Projection(1, 1)]),
        Query([2, 0], [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 0, 0)],
              [], [Projection(0, 0)]),
        Query([0, 1, 2, 1], [JoinPred(0, 0, 1, 0), JoinPred(2, 0, 3, 0)],
              [FilterPred(0, 1, ">", 1)],
              [Projection(2, 0), Projection(0, 0)])])
    cases["corners_exchange"] = cases["ftree_corners"][:2] + (
        {"factorized": False}, {}, "execute")
    # a parallel edge fused into a composite key, then trailing fusions
    rng = np.random.default_rng(77)
    a0, a1 = rng.integers(0, 20, 300), rng.integers(0, 20, 300)
    B = _u64(a0.copy(), a1.copy(), rng.integers(0, 100, 300))
    rng.shuffle(B.values[0])
    cases["composite"] = _case(
        [_u64(a0, a1, rng.integers(0, 100, 300)), B, _u64(np.arange(100))],
        [Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1),
                           JoinPred(1, 2, 2, 0)],
               [], [Projection(0, 2), Projection(2, 0)]),
         Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1)],
               [], [Projection(0, 0), Projection(1, 1)])])
    # huge shards: every node shard past the shrunken huge-node threshold
    rels, queries = _star(np.random.default_rng(77), 4 * 700 + 33)
    cases["huge_shards"] = _case(rels, queries, {},
                                 {"big_wave_rows": 512,
                                  "big_window_rows": 256})
    # forced tiny gather / exchange capacities: the x4 retry ladder
    rng = np.random.default_rng(91)
    n = 3000
    rels = [_u64(rng.integers(0, 40, n), rng.integers(0, 40, n),
                 rng.integers(0, 100, n)),
            _u64(rng.integers(0, 40, 500), rng.integers(0, 100, 500))]
    cases["gather_retry"] = _case(rels, [
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1)],
              [], [Projection(0, 2), Projection(1, 1)]),
        Query([0, 1, 0], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
              [FilterPred(2, 2, "<", 80)], [Projection(2, 2)])],
        {"factorized": False}, {"gather_cap": 8})
    rng = np.random.default_rng(92)
    ka = np.where(rng.random(n) < 0.5, 7, rng.integers(0, 40, n))
    cases["exchange_retry"] = _case(
        [_u64(ka, rng.integers(0, 100, n)),
         _u64(rng.integers(0, 40, 500), rng.integers(0, 100, 500))],
        [Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
               [Projection(0, 1), Projection(1, 1)])],
        {"factorized": False}, {"gather_cap": 8})
    # chunked broadcasts against unchunked
    rng = np.random.default_rng(17)
    n = 2000
    rels = [_u64(rng.integers(0, 30, n), rng.integers(0, 30, n),
                 rng.integers(0, 100, n)),
            _u64(rng.integers(0, 30, 700), rng.integers(0, 100, 700))]
    bq = [Query([0, 1, 0], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
                [FilterPred(2, 2, "<", 60)],
                [Projection(2, 2), Projection(1, 1)]),
          Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1)],
                [], [Projection(0, 2), Projection(1, 1)]),
          Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 2, 1, 1)],
                [], [Projection(0, 2)])]
    for k in (1, 4):
        cases[f"bchunks{k}"] = _case(rels, bq, {"factorized": False,
                                                "broadcast_chunks": k})
    # one batch: the factorizable queries in ONE wave, the rest exchanged
    rng = np.random.default_rng(500)
    rels = _random_catalog(rng)
    batch = [_random_query(rng, rels) for _ in range(5)]
    batch.append(Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
                       [Projection(0, 0), Projection(1, 0)]))
    cases["wave_batch"] = _case(rels, batch, mode="batch")
    # ftree_wave=False: each factorizable query in a wave of its own
    cases["wave_batch_nowave"] = _case(rels, batch, {"ftree_wave": False},
                                       mode="batch")
    return cases


CASES = _cases()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request):
    """{case name: per-rank [(lines, counters)]} of one world size, from
    one spawned gloo group."""
    n = request.param
    names = list(CASES)
    outs = multihost.run_ranks(torch_dist_ranks.engine_cases, n,
                               ([CASES[k] for k in names],), device="cpu",
                               timeout=GROUP_TIMEOUT_S)
    return n, {k: [outs[r][i] for r in range(n)]
               for i, k in enumerate(names)}


@pytest.mark.parametrize("name", list(CASES))
def test_dist_lines_match_oracle(world, name):
    _n, res = world
    cols, lines, cfg, patches, mode = CASES[name]
    want = _oracle_lines(cols, lines)
    per_rank = res[name]
    for got, counters in per_rank:
        assert got == want, name
        assert counters == per_rank[0][1]
    counters = per_rank[0][1]
    if name.endswith("_exchange") or name in ("zipf_heavy", "gather_retry",
                                              "exchange_retry"):
        assert counters["exchange_queries"] == len(lines)
        assert counters["ftree_queries"] == 0
    if name in ("ftree_corners", "composite", "huge_shards"):
        assert counters["ftree_queries"] == len(lines)
    if name in ("gather_retry", "exchange_retry"):
        assert counters["gather_retries"] > 0
    if name == "wave_batch":
        assert counters["ftree_waves"] == 1
        assert counters["ftree_queries"] >= 1
    if name == "wave_batch_nowave":
        assert counters["ftree_waves"] == counters["ftree_queries"] > 1
        assert res["wave_batch"][0][0] == want


def test_dist_broadcast_chunks_match_unchunked(world):
    _n, res = world
    assert res["bchunks1"][0][0] == res["bchunks4"][0][0]


# a few queries on both executors: factorized and exchange
_JAX_CASES = {
    "ftree": ("composite", {}),
    "exchange": ("zipf_heavy", {"skew_heavy_fraction": 0.25,
                                "factorized": False}),
    "ftree_wave_false": ("wave_batch_nowave", {"ftree_wave": False}),
}


@pytest.mark.parametrize("path", list(_JAX_CASES))
def test_dist_matches_jax_dist_executor(world, path):
    """The port on this world against JAX's DistExecutor on a 4-device
    mesh: the same lines and the same counters (a batch case through
    run_batch)."""
    _n, res = world
    name, cfg = _JAX_CASES[path]
    cols, lines, _cfg, _p, mode = CASES[name]
    rels = [Relation([np.asarray(c, np.uint64) for c in cs]) for cs in cols]
    queries = [parse_query(ln) for ln in lines]
    jax_queries = [Query(q.slots, q.joins, q.filters, q.projections)
                   for q in queries]
    ex = JaxDist(rels, JaxConfig(**cfg), n_devices=4)
    from radixhashjoin_tpu.oracle import format_result
    if mode == "batch":
        want = ex.run_batch(jax_queries)
    else:
        want = [format_result(ex.execute(q), len(q.projections))
                for q in jax_queries]
    got, counters = res[name][0]
    assert got == want
    assert {k: counters[k] for k in JAX_COUNTERS} == {
        k: ex.counters[k] for k in JAX_COUNTERS}


def test_cli_mesh2_matches_single_device(tmp_path):
    """`--mesh 2 --device cpu` (this process spawns rank 1) prints the
    single-device port's lines on a catalog with factorized and
    exchange-only queries."""
    rng = np.random.default_rng(2024)
    rels = _random_catalog(rng)
    queries = [_random_query(rng, rels) for _ in range(8)]
    queries.append(Query([0, 1, 2], [JoinPred(0, 0, 1, 0),
                                      JoinPred(1, 1, 2, 0),
                                      JoinPred(2, 1, 0, 1)], [],
                         [Projection(0, 0)]))                 # a cycle
    paths = []
    for i, r in enumerate(rels):
        paths.append(str(tmp_path / f"r{i}"))
        tstorage.write_relation(paths[-1], list(r.values))
    work = [_line(q) for q in queries[:5]] + ["F"] + \
        [_line(q) for q in queries[5:]] + ["F"]
    stream = "\n".join(paths + ["Done"] + work) + "\n"
    outs = {}
    for args in ([], ["--mesh", "2"]):
        p = subprocess.run([sys.executable, "-m", "radixhashjoin_tpu_torch",
                            "--device", "cpu", *args], input=stream,
                           capture_output=True, text=True, cwd=REPO,
                           timeout=240)
        assert p.returncode == 0, p.stderr[-3000:]
        outs[tuple(args)] = p.stdout.splitlines()
    assert outs[("--mesh", "2")] == outs[()]
    assert outs[()] == _oracle_lines([list(r.values) for r in rels],
                                     [_line(q) for q in queries])
