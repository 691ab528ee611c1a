"""The port's two repaired planner faults, held to the oracle; the JAX
package's wrong lines are recorded as declared divergences (ROADMAP.md §3).

A. The factorized planner (models/batch.py `_extract_tree`) dropped a
   repeated case-3 edge whose columns share one equivalence class even
   when a parallel edge had fused into a composite key at the same
   position. The fusion can empty the rows while its own pair set is
   non-empty; the repeated edge's pair set is then empty and the oracle
   prints NULL, where the wave printed sums of 0. Such a query now takes
   the materialized path. DistExecutor plans through the same code.
B. `enable_join_reordering` (models/planner.py) reordered queries with
   same-slot predicates, case-1 wipes and case-3 steps, whose lines
   depend on the written order under the reference's chaining semantics.
   Only queries that attach one fresh slot per join are reordered now.

The fuzz draws tests/test_fuzz.py's catalogs and queries. Under it the
parent planner mismatched the oracle at seeds 243, 3249 and 5583 (A, of
0-7999 under the default config) and at 297 of seeds 0-1499 under
reordering (B); ROADMAP.md names seeds 47, 3031, 4608 and 6466 of another
generator, run here too.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.models.batch import BatchExecutor as JaxBatch
from radixhashjoin_tpu.models.planner import reorder_joins as jax_reorder
from radixhashjoin_tpu.oracle import OracleExecutor as JaxOracle
from radixhashjoin_tpu.oracle import format_result as jax_format
from radixhashjoin_tpu.storage import Relation as JaxRelation
from radixhashjoin_tpu.workload import parse_query as jax_parse
from radixhashjoin_tpu_torch import bench
from radixhashjoin_tpu_torch import storage as tstorage
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models.batch import BatchExecutor
from radixhashjoin_tpu_torch.models.engine import Engine
from radixhashjoin_tpu_torch.models.planner import (fresh_slot_chain,
                                                    reorder_joins)
from radixhashjoin_tpu_torch.oracle import OracleExecutor, format_result
from radixhashjoin_tpu_torch.parallel import multihost
from radixhashjoin_tpu_torch.storage import Relation
from radixhashjoin_tpu_torch.workload import parse_query

import torch_dist_ranks
from test_fuzz import _random_catalog, _random_query
from test_torch_engine import REPO, _line

torch.set_num_threads(1)

# fault A: a parallel edge fuses at position 2, then repeats
A_COLS = [[[1, 2], [5, 6]], [[1, 2], [6, 5]]]
A_QUERY = "0 1|0.0=1.0&0.1=1.1&0.1=1.1|0.0 1.1"
# fault B: a case-1 wipe by a fresh same-slot predicate after a join
B_COLS = [[[1, 2], [3, 4]], [[1, 5], [7, 8]], [[10, 20], [30, 40]]]
B_QUERY = "0 1 2|0.0=1.0&2.0=2.0|2.0"

A_CONFIGS = {"default": {}, "stage_group1": {"stage_group": 1},
             "no_ftree_wave": {"ftree_wave": False},
             "no_defer_middle": {"defer_middle": False}}


def _rels(cols):
    return [Relation([np.asarray(c, np.uint64) for c in cs]) for cs in cols]


def _jax_rels(cols):
    return [JaxRelation([np.asarray(c, np.uint64) for c in cs])
            for cs in cols]


def _oracle(rels, q):
    return format_result(OracleExecutor(rels).execute(q), len(q.projections))


def _cli(tmp_path, cols, query, *flags):
    paths = []
    for i, cs in enumerate(cols):
        paths.append(str(tmp_path / f"r{i}"))
        tstorage.write_relation(paths[-1], [np.asarray(c, np.uint64)
                                            for c in cs])
    stream = "\n".join(paths + ["Done", query, "F"]) + "\n"
    p = subprocess.run([sys.executable, "-m", "radixhashjoin_tpu_torch",
                        "--device", "cpu", *flags], input=stream,
                       capture_output=True, text=True, cwd=REPO, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.splitlines()


# ---- fault A ----

@pytest.mark.parametrize("cfg", list(A_CONFIGS))
def test_fault_a_prints_null(cfg):
    """The repeated edge after a fusion prints the oracle's NULL NULL
    under the default and each setting that plans the wave; the query
    leaves the wave. JAX's engine prints 0 0 (declared divergence)."""
    rels, q = _rels(A_COLS), parse_query(A_QUERY)
    want = _oracle(rels, q)
    assert want == "NULL NULL"
    eng = Engine(rels, EngineConfig(**A_CONFIGS[cfg]), device="cpu")
    assert eng.run_batch([q]) == [want]
    assert eng.batch_executor.counters["ftree_queries"] == 0
    jax = JaxBatch(_jax_rels(A_COLS), JaxConfig(**A_CONFIGS[cfg]))
    assert [jax_format(r, 2) for r in jax.run_batch(
        [jax_parse(A_QUERY)])] == ["0 0"]


def test_fault_a_planner_falls_back_only_there():
    """_extract_tree returns None for the repeated edge after a fusion,
    and still plans the fusion alone and the repeat without a fusion."""
    be = BatchExecutor(_rels(A_COLS), EngineConfig(), device="cpu")
    assert be._extract_tree(parse_query(A_QUERY)) is None
    for line in ("0 1|0.0=1.0&0.1=1.1|0.0 1.1",
                 "0 1|0.0=1.0&0.0=1.0|0.0 1.1"):
        assert be._extract_tree(parse_query(line)) is not None, line


@pytest.mark.parametrize("flags", [[], ["--backend", "sort"],
                                   ["--mesh", "2"]],
                         ids=lambda f: " ".join(f) or "default")
def test_fault_a_cli(tmp_path, flags):
    """Through the CLI: the default path, the sort backend's per-op path
    and two gloo ranks (--mesh 2) print NULL NULL."""
    assert _cli(tmp_path, A_COLS, A_QUERY, *flags) == ["NULL NULL"]


def test_fault_a_dist_executor_on_gloo_ranks():
    """DistExecutor on two gloo ranks plans through the same
    _ftree_plan_for: both ranks print NULL NULL, and the query is not
    in the distributed wave."""
    case = (A_COLS, [A_QUERY], {}, {}, "batch")
    outs = multihost.run_ranks(torch_dist_ranks.engine_cases, 2, ([case],),
                               device="cpu", timeout=240)
    for (got, counters), in outs:
        assert got == ["NULL NULL"]
        assert counters["ftree_queries"] == 0


def _fuzz_case(seed):
    rng = np.random.default_rng(seed)
    rels = _random_catalog(rng)
    queries = [_random_query(rng, rels) for _ in range(8)]
    return ([Relation(list(r.values)) for r in rels],
            [parse_query(_line(q)) for q in queries])


A_SEEDS = [47, 3031, 4608, 6466, 243, 3249, 5583] + list(range(40, 61))


@pytest.mark.parametrize("seed", A_SEEDS)
def test_fault_a_fuzz(seed):
    """The port's wave-batched engine against its oracle under the
    default and the settings fault A reached."""
    rels, queries = _fuzz_case(seed)
    want = [_oracle(rels, q) for q in queries]
    for cfg in A_CONFIGS.values():
        got = Engine(rels, EngineConfig(**cfg),
                     device="cpu").run_batch(queries)
        assert got == want, cfg


def test_contest_workload_plan_unchanged():
    """The contest-shaped workload (bench.py) still plans all 50 tree
    queries in the wave, and the guard picks the same 20 fallback
    queries as the JAX planner, which lacks it."""
    cols, tree = bench.contest_catalog()
    be = BatchExecutor([Relation(c) for c in cols], EngineConfig(),
                       device="cpu")
    queries = [parse_query(ln) for ln in tree if ln != "F"]
    assert len(queries) == 50
    assert all(be._ftree_plan_for(q) is not None for q in queries)
    lines, _kinds = bench.fallback_queries(cols, be)

    class JaxPlanner:
        jax_be = JaxBatch([JaxRelation(c) for c in cols], JaxConfig())

        def _ftree_plan_for(self, q):
            return self.jax_be._ftree_plan_for(jax_parse(_line(q)))
    assert bench.fallback_queries(cols, JaxPlanner())[0] == lines


# ---- fault B ----

def test_fault_b_reorder_keeps_written_lines():
    """--reorder-joins keeps the written order of a query with a case-1
    wipe: the oracle's 30, where JAX's reordering prints 0 (declared
    divergence)."""
    rels, q = _rels(B_COLS), parse_query(B_QUERY)
    assert _oracle(rels, q) == "30"
    assert reorder_joins(q, rels).joins == q.joins
    eng = Engine(rels, EngineConfig(enable_join_reordering=True),
                 device="cpu")
    assert eng.run_batch([q]) == ["30"]
    jrels = _jax_rels(B_COLS)
    jq = jax_reorder(jax_parse(B_QUERY), jrels)
    assert jax_format(JaxOracle(jrels).execute(jq), 1) == "0"


def test_fault_b_cli(tmp_path):
    assert _cli(tmp_path, B_COLS, B_QUERY, "--reorder-joins") == ["30"]


@pytest.mark.parametrize("joins,fresh", [
    ("0.0=1.0&1.1=2.0", True), ("0.0=1.0&0.1=2.0&2.1=3.0", True),
    ("0.0=1.0&2.0=3.0", False),          # case-1 wipe
    ("0.0=1.0&1.0=1.1", False),          # same-slot predicate
    ("0.0=1.0&1.1=0.1", False),          # case-3 step
    ("0.0=0.1&0.1=1.0", False),          # a same-slot predicate first
])
def test_fresh_slot_chain(joins, fresh):
    q = parse_query(f"0 1 2 3|{joins}|0.0")
    assert fresh_slot_chain(q.joins) is fresh


B_BLOCKS = range(0, 1500, 50)


@pytest.mark.parametrize("start", B_BLOCKS)
def test_fault_b_fuzz(start):
    """Seeds start..start+49, every fifth: the reordered query gives the
    written order's oracle lines, and the engine under reordering prints
    them; fresh-slot chains do get reordered somewhere in the slice."""
    for seed in range(start, start + 50, 5):
        rels, queries = _fuzz_case(seed)
        want = [_oracle(rels, q) for q in queries]
        assert [_oracle(rels, reorder_joins(q, rels))
                for q in queries] == want
        eng = Engine(rels, EngineConfig(enable_join_reordering=True),
                     device="cpu")
        assert eng.run_batch(queries) == want


def test_fault_b_fuzz_reorders_chains():
    """The fuzz's slice does reach the reordering: some fresh-slot chains
    change order, and every other query comes back as written."""
    moved = 0
    for seed in range(0, 1500, 5):
        rels, queries = _fuzz_case(seed)
        for q in queries:
            r = reorder_joins(q, rels)
            if not fresh_slot_chain(q.joins):
                assert r is q
            moved += r.joins != q.joins
    assert moved > 0
