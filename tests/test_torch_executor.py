"""The port's materializing sort join one query a call (Engine.execute
under join_backend="sort": the batch executor's per-op path on a batch
of one; `python -m radixhashjoin_tpu_torch --backend sort`) against the
JAX package's per-query JaxExecutor and the NumPy oracle, on the CPU.

Result lines must be identical in all three. Covers the generators of
tests/test_fuzz.py, every case of tests/test_case3_rewrite.py (those the
wave-batched path plans and those it does not), cyclic, same-slot and
no-join queries, NULL lines, wide u64 values (dictionary codes), a
catalog whose domain exceeds max_dense_domain, and the 2**31 - 1 pair
cap. The default batch path answers the same queries with its own
materialized fallback, and the two backends agree.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.models.executor import JaxExecutor
from radixhashjoin_tpu.ops.join import JoinCapacityError as JaxCapacity
from radixhashjoin_tpu.oracle import OracleExecutor, format_result
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models.engine import Engine
from radixhashjoin_tpu_torch.ops.join import JoinCapacityError

from test_fuzz import _random_catalog, _random_query
from test_torch_engine import (CASE3, _line, _merge, _to_port, _u64,
                               _wide_case, _write_catalog)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_QUERY = EngineConfig(join_backend="sort")


def _oracle_lines(rels, queries):
    oracle = OracleExecutor(rels)
    return [format_result(oracle.execute(q), len(q.projections))
            for q in queries]


def _agree(rels, queries, config=PER_QUERY):
    """Port, one query a call on the sort backend == JaxExecutor ==
    oracle, line for line."""
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, config, device="cpu")
    assert eng.batch_executor.join.kind == "sort"
    got = [format_result(eng.execute(q), len(q.projections))
           for q in pqueries]
    jax_ex = JaxExecutor(rels, JaxConfig())
    jax_lines = [format_result(jax_ex.execute(q), len(q.projections))
                 for q in queries]
    want = _oracle_lines(rels, queries)
    assert got == want
    assert jax_lines == want
    assert eng.batch_executor.counters["ftree_queries"] == 0
    return got


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_queries_match_jax_and_oracle(seed):
    rng = np.random.default_rng(seed)
    rels = _random_catalog(rng)
    _agree(rels, [_random_query(rng, rels) for _ in range(8)])


def test_case3_cases_match():
    """Every case of tests/test_case3_rewrite.py, the factorizing ones
    and the ones the wave-batched path leaves to the fallback."""
    assert any(not expect for _r, _q, expect in CASE3)
    _agree(*_merge([(rels, [q]) for rels, q, _expect in CASE3]))


def _shapes_catalog():
    rng = np.random.default_rng(7)
    return [Relation([rng.integers(0, 6, n).astype(np.uint64)
                      for _ in range(3)]) for n in (40, 55, 33)]


SHAPES = {
    # a cycle the planner cannot rewrite: a triangle over fresh columns
    "triangle": Query([0, 1, 2], [JoinPred(0, 1, 1, 0), JoinPred(1, 1, 2, 0),
                                  JoinPred(2, 1, 0, 0)], [],
                      [Projection(0, 2), Projection(2, 2)]),
    "triangle_filtered": Query(
        [0, 1, 2], [JoinPred(0, 1, 1, 0), JoinPred(1, 1, 2, 0),
                    JoinPred(2, 1, 0, 0)], [FilterPred(1, 2, "<", 3)],
        [Projection(1, 0)]),
    "no_join": Query([0], [], [FilterPred(0, 1, "<", 3)],
                     [Projection(0, 0), Projection(0, 2)]),
    "no_join_no_filter": Query([1, 2], [], [], [Projection(1, 0)]),
    "no_join_null": Query([0], [], [FilterPred(0, 1, "=", 99)],
                          [Projection(0, 0)]),
    "same_slot_fresh": Query([0, 1], [JoinPred(0, 1, 0, 2),
                                      JoinPred(0, 0, 1, 0)], [],
                             [Projection(0, 0), Projection(1, 1)]),
    "same_slot_joined": Query([0, 1], [JoinPred(0, 0, 1, 0),
                                       JoinPred(1, 1, 1, 2)], [],
                              [Projection(1, 0)]),
    "same_slot_only": Query([2], [JoinPred(0, 0, 0, 1)], [],
                            [Projection(0, 2)]),
    "join_null": Query([0, 1], [JoinPred(0, 0, 1, 0)],
                       [FilterPred(1, 0, ">", 4), FilterPred(0, 0, "<", 5)],
                       [Projection(0, 1)]),
    "case1_wipe": Query([0, 1, 2, 1], [JoinPred(0, 0, 1, 0),
                                       JoinPred(2, 0, 3, 1)], [],
                        [Projection(0, 0), Projection(3, 2)]),
    "self_join_cycle": Query([0, 0], [JoinPred(0, 0, 1, 1),
                                      JoinPred(1, 0, 0, 1)], [],
                             [Projection(0, 2)]),
}


def test_query_shapes_match():
    rels = _shapes_catalog()
    got = _agree(rels, list(SHAPES.values()))
    lines = dict(zip(SHAPES, got))
    assert lines["no_join_null"] == "NULL"
    assert lines["join_null"] == "NULL"
    assert lines["no_join_no_filter"] == "0"          # never joined: 0


def test_case3_pair_set_rule():
    """A both-joined step NULLs iff its pair set is empty, and gives
    zeros when the pairs exist but no row keeps equal values."""
    r0 = _u64([1, 2], [2, 1])
    r1 = _u64([1, 2], [1, 2])
    queries = [
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1)], [],
              [Projection(0, 0)]),                         # zeros
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 0)],
              [FilterPred(1, 1, "<", 2)], [Projection(0, 0)]),
    ]
    r2 = _u64([1, 1], [7, 8])
    queries.append(Query([0, 2], [JoinPred(0, 0, 1, 0),
                                  JoinPred(0, 1, 1, 1)], [],
                         [Projection(1, 1)]))              # NULL
    got = _agree([r0, r1, r2], queries)
    assert got[0] == "0" and got[2] == "NULL"


def test_wide_u64_dictionary_catalog():
    rels, queries = _wide_case()
    queries = list(queries) + [
        Query([0, 1, 0], [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 2, 0),
                          JoinPred(2, 1, 0, 1)], [],
              [Projection(1, 1), Projection(2, 0)]),
        Query([2], [], [FilterPred(0, 0, ">", 2**62)], [Projection(0, 0)]),
    ]
    got = _agree(rels, queries)
    assert int(got[0].split()[0]) > 2**40
    assert got[1] == str((8 * (2**63 - 7)) % 2**64)   # wrapped past 2**64


def test_domain_beyond_max_dense_domain():
    """A catalog past max_dense_domain: the forced sort backend one query
    a call and the default backend choice (which picks the sort join
    there) over a whole batch agree."""
    rng = np.random.default_rng(3)
    rels = [Relation([rng.integers(0, 1 << 12, 500).astype(np.uint64)
                      for _ in range(2)]) for _ in range(3)]
    queries = [_random_query(rng, rels) for _ in range(6)]
    cfg = EngineConfig(join_backend="sort", max_dense_domain=512)
    got = _agree(rels, queries, cfg)
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, cfg, device="cpu")
    assert eng.batch_executor.catalog.domain > 512
    batch = Engine(prels, EngineConfig(max_dense_domain=512), device="cpu")
    assert batch.batch_executor.join.kind == "sort"
    assert batch.run_batch(pqueries) == got


def test_sort_backend_only_per_query():
    """join_backend="sort" runs one query a call and a whole batch (the
    name is from when the batch path refused it), with the same lines."""
    rels = _shapes_catalog()
    queries = list(SHAPES.values())
    prels, pqueries = _to_port(rels, queries)
    batch = Engine(prels, PER_QUERY, device="cpu")
    per_query = [format_result(batch.execute(q), len(q.projections))
                 for q in pqueries]
    assert batch.run_batch(pqueries) == per_query == _oracle_lines(rels,
                                                                   queries)
    assert batch.batch_executor.counters["ftree_queries"] == 0


def test_pair_cap_raises_like_jax():
    """2**31 pairs (65,536 x 32,768 equal keys) exceed the int32 offset
    space: JaxExecutor and the port's sort join raise instead of
    overflowing."""
    rels = [_u64(np.full(1 << 16, 5)), _u64(np.full(1 << 15, 5))]
    q = Query([0, 1], [JoinPred(0, 0, 1, 0)], [], [Projection(0, 0)])
    with pytest.raises(JaxCapacity):
        JaxExecutor(rels, JaxConfig()).execute(q)
    prels, (pq,) = _to_port(rels, [q])
    with pytest.raises(JoinCapacityError):
        Engine(prels, PER_QUERY, device="cpu").execute(pq)


def test_executor_shares_the_batch_catalog():
    """Engine.execute runs a batch of one through the engine's one
    executor, over the wave's own catalog (one dispatch and one readback
    a tree query), and agrees with the whole batch on tree queries."""
    rng = np.random.default_rng(21)
    rels = _random_catalog(rng)
    prels, _ = _to_port(rels)
    eng = Engine(prels, EngineConfig(), device="cpu")
    assert not hasattr(eng, "executor")
    from test_factorized import _tree_query
    queries = [_tree_query(rng, rels) for _ in range(6)]
    _, pqueries = _to_port(rels, queries)
    per_query = [format_result(eng.execute(q), len(q.projections))
                 for q in pqueries]
    counters = dict(eng.batch_executor.counters)
    assert counters["dispatches"] == counters["readbacks"] == len(queries)
    assert counters["ftree_queries"] == len(queries)
    assert per_query == eng.run_batch(pqueries) == _oracle_lines(rels,
                                                                 queries)


def test_execute_is_a_batch_of_one_on_every_shape():
    """On the default (dense) backend, Engine.execute answers each query
    shape, those the wave plans and those the materialized fallback
    runs, as a batch of one: the whole batch's line and the oracle's."""
    rels = _shapes_catalog()
    queries = list(SHAPES.values())
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, EngineConfig(), device="cpu")
    assert eng.batch_executor.join.kind == "dense"
    one = [format_result(eng.execute(q), len(q.projections))
           for q in pqueries]
    whole = Engine(prels, EngineConfig(), device="cpu").run_batch(pqueries)
    assert one == whole == _oracle_lines(rels, queries)


# ---- the CLI ----

def _stream(paths, queries, every=3):
    work = []
    for i, q in enumerate(queries):
        work.append(_line(q))
        if i % every == every - 1:
            work.append("F")
    return "\n".join(paths + ["Done"] + work + ["F"]) + "\n"


def _cli(args, stream):
    return subprocess.run([sys.executable, "-m", "radixhashjoin_tpu_torch",
                           *args], input=stream, capture_output=True,
                          text=True, cwd=REPO, timeout=240)


def test_cli_no_batch_matches_oracle(tmp_path):
    """--backend sort, the CLI's materializing sort join (it replaces the
    retired --no-batch), prints the oracle's lines."""
    rels = _shapes_catalog()
    rng = np.random.default_rng(5)
    queries = list(SHAPES.values()) + [_random_query(rng, rels)
                                       for _ in range(6)]
    proc = _cli(["--device", "cpu", "--backend", "sort"],
                _stream(_write_catalog(tmp_path, rels), queries))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == _oracle_lines(rels, queries)


def test_cli_batch_mode_still_raises_for_cycles(tmp_path):
    """The default wave-batched path answers a cycle it cannot factorize
    with its materialized fallback (the name is from when it refused):
    the same lines as --backend sort and the oracle."""
    rels = _shapes_catalog()
    queries = [SHAPES["triangle"], SHAPES["no_join"], SHAPES["case1_wipe"]]
    stream = _stream(_write_catalog(tmp_path, rels), queries)
    proc = _cli(["--device", "cpu"], stream)
    assert proc.returncode == 0, proc.stderr
    want = _oracle_lines(rels, queries)
    assert proc.stdout.splitlines() == want
    proc = _cli(["--device", "cpu", "--backend", "sort"], stream)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == want
