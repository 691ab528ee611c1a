"""The whole port (radixhashjoin_tpu_torch: Engine, BatchExecutor, CLI)
against the JAX package and the NumPy oracle, on the CPU.

Result lines must be identical in all three — the JAX engine running the
Pallas one-hot build kernel in interpret mode (ftree_scatter="onehot") —
and both packages must count the same factorized queries. The port gets
its own objects: its Relation over the same columns, and each query
through its own parser from the query's text. Covers random
tree queries, stars, chains, wiped-component NULLs, every factorizing
case of tests/test_case3_rewrite.py, and wide u64 values with sums past
2**40 and 2**64. Also: the queries and settings the materialized
fallback answers inside the batch path (tests/test_torch_batch_fallback.py
holds its operators and configs against JAX), the CLI as a subprocess,
the port's independence from jax, and the settings that raised until
they were ported (tests/test_torch_settings.py covers those in full; the
sort backend one query a call, against JAX's per-query executor, has its
own file, tests/test_torch_executor.py), and the settings the port
retired: JAX's table and window names, each of which JAX runs to the
lines of the port's one table build and window pass.
"""

import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_case3_rewrite as case3
from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.models.batch import BatchExecutor as JaxBatch
from radixhashjoin_tpu.models.engine import Engine as JaxEngine
from radixhashjoin_tpu.oracle import OracleExecutor, format_result
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)
from radixhashjoin_tpu_torch import storage as tstorage
from radixhashjoin_tpu_torch import workload as tworkload
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models.engine import Engine

from test_factorized import _rels, _tree_query

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U64 = np.uint64


def _case3_cases():
    """(rels, query, expect_ftree) of every zero-argument test in
    tests/test_case3_rewrite.py that drives its `_run` helper, recorded
    by a stand-in `_run` that answers with the oracle's line (so each
    test's own assertions still hold)."""
    cases = []

    def record(rels, q, expect_ftree):
        cases.append((rels, q, expect_ftree))
        return format_result(OracleExecutor(rels).execute(q),
                             len(q.projections))

    orig = case3._run
    case3._run = record
    try:
        for name, fn in sorted(vars(case3).items()):
            if (name.startswith("test_") and callable(fn)
                    and not inspect.signature(fn).parameters
                    and "_run(" in inspect.getsource(fn)):
                fn()
    finally:
        case3._run = orig
    return cases


CASE3 = _case3_cases()


def _merge(cases):
    """One catalog for many (rels, queries) cases: relation ids shift by
    the relations before them."""
    rels, queries = [], []
    for crels, cqs in cases:
        off = len(rels)
        rels.extend(crels)
        queries.extend(Query([s + off for s in q.slots], q.joins, q.filters,
                             q.projections) for q in cqs)
    return rels, queries


def _u64(*cols):
    return Relation([np.array(c, U64) for c in cols])


def _line(q):
    """A query in the work-stream syntax."""
    preds = ([f"{j.slot1}.{j.col1}={j.slot2}.{j.col2}" for j in q.joins]
             + [f"{f.slot}.{f.col}{f.op}{f.value}" for f in q.filters])
    return (f"{' '.join(map(str, q.slots))}|{'&'.join(preds)}|"
            f"{' '.join(f'{p.slot}.{p.col}' for p in q.projections)}")


def _to_port(rels, queries=()):
    """The same relations and queries as the port's own objects."""
    return ([tstorage.Relation(list(r.values)) for r in rels],
            [tworkload.parse_query(_line(q)) for q in queries])


def _from_port(q, pq):
    """q with the port query pq's join order, as a JAX Query."""
    return Query(q.slots, [JoinPred(j.slot1, j.col1, j.slot2, j.col2)
                           for j in pq.joins], q.filters, q.projections)


def _port_engine(rels, config=None):
    return Engine(_to_port(rels)[0], config or EngineConfig(), device="cpu")


def _shapes():
    rng = np.random.default_rng(11)
    rels = _rels(rng, n_rel=5, vmax=16)
    star_chain = (rels, [
        Query([0, 1, 2, 3], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0),
                             JoinPred(0, 0, 3, 1)],
              [FilterPred(1, 0, "<", 9)],
              [Projection(s, 1) for s in range(4)]),
        Query([0, 1, 2, 3], [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
                             JoinPred(2, 1, 3, 0)],
              [FilterPred(3, 0, ">", 3)],
              [Projection(0, 1), Projection(3, 1)]),
        Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
              [FilterPred(2, 1, "=", 999)], [Projection(0, 0)]),   # NULL
    ])
    # wiped components gate NULL (test_factorized.py)
    r0 = _u64([1, 2], [5, 6])
    r1 = _u64([3, 4], [7, 8])
    wiped = ([r0, r1], [
        Query([0, 1, 0, 1], [JoinPred(0, 0, 1, 0), JoinPred(2, 0, 3, 0)],
              [], [Projection(2, 0)]),
        Query([0, 0, 0, 1], [JoinPred(0, 0, 1, 0), JoinPred(2, 0, 3, 0)],
              [], [Projection(2, 0)]),
        Query([0, 0, 1, 1], [JoinPred(0, 0, 1, 0), JoinPred(2, 1, 3, 1)],
              [], [Projection(3, 0), Projection(0, 1)]),
    ])
    return [star_chain, wiped]


def _wide_case():
    """u64 values: dictionary codes, 16-bit planes, sums past 2**40 and
    wrapping past 2**64."""
    rng = np.random.default_rng(13)
    big = rng.integers(0, 50, 200).astype(U64) << U64(40)
    r0 = Relation([big, rng.integers(0, 9, 200).astype(U64)])
    r1 = Relation([big[rng.permutation(200)],
                   rng.integers(0, 50, 200).astype(U64) << U64(35)])
    top = 2**63 - 7
    r2 = Relation([np.full(8, top, U64), np.arange(8, dtype=U64)])
    queries = [
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(0, 1, "<", 5)],
              [Projection(0, 0), Projection(1, 1)]),
        Query([2, 2], [JoinPred(0, 1, 1, 1)], [], [Projection(0, 0)]),
        Query([1, 0], [JoinPred(0, 0, 1, 0)],
              [FilterPred(1, 0, ">", 2**44)], [Projection(0, 1)]),
    ]
    return [r0, r1, r2], queries


def _fuzz(seed):
    rng = np.random.default_rng(200 + seed)
    rels = _rels(rng)
    return rels, [_tree_query(rng, rels) for _ in range(8)]


def _agree(rels, queries):
    """Port == JAX (Pallas build kernel) == oracle, equal ftree counts."""
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, EngineConfig(), device="cpu")
    got = eng.run_batch(pqueries)
    ref = JaxBatch(rels, JaxConfig(ftree_scatter="onehot"))
    jax_lines = [format_result(r, len(q.projections))
                 for r, q in zip(ref.run_batch(queries), queries)]
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    assert got == want
    assert jax_lines == want
    assert (eng.batch_executor.counters["ftree_queries"]
            == ref.counters["ftree_queries"] == len(queries))
    assert eng.batch_executor.counters["readbacks"] == 1
    return got


@pytest.mark.parametrize("seed", range(2))
def test_tree_queries_match_jax_and_oracle(seed):
    _agree(*_fuzz(seed))


def test_stars_chains_wiped_nulls_match():
    got = _agree(*_merge(_shapes()))
    assert any("NULL" in line for line in got)


def test_case3_factorizing_cases_match():
    ft = [(rels, [q]) for rels, q, expect in CASE3 if expect]
    assert len(ft) >= 15
    _agree(*_merge(ft))


def test_wide_u64_sums_match():
    rels, queries = _wide_case()
    got = _agree(rels, queries)
    assert int(got[0].split()[0]) > 2**40
    assert got[1] == str((8 * (2**63 - 7)) % 2**64)     # wrapped past 2**64


def test_wave_grouping_agrees():
    """Each query alone (a one-spec wave) gives the line it gets inside
    the batch's one wave."""
    rels, queries = _to_port(*_fuzz(0))
    eng = Engine(rels, EngineConfig(), device="cpu")
    base = eng.run_batch(queries)
    assert eng.batch_executor.counters["dispatches"] == 1
    assert [eng.run_batch([q])[0] for q in queries] == base
    assert eng.batch_executor.counters["dispatches"] == 1 + len(queries)
    assert eng.batch_executor.counters["readbacks"] == 1 + len(queries)


# ---- every query shape through the batch path ----

@pytest.mark.parametrize("ci", [i for i, c in enumerate(CASE3) if not c[2]])
def test_non_factorizable_query_raises(ci):
    """A CASE3 query the tree planner leaves to the materialized fallback
    runs in the batch path itself (nothing raises any more): port == JAX
    == oracle, no factorized query."""
    rels, q, _ = CASE3[ci]
    prels, (pq,) = _to_port(rels, [q])
    eng = Engine(prels, EngineConfig(), device="cpu")
    ref = JaxBatch(rels, JaxConfig())
    want = format_result(OracleExecutor(rels).execute(q), len(q.projections))
    assert eng.run_batch([pq]) == [want]
    assert [format_result(r, len(q.projections))
            for r in ref.run_batch([q])] == [want]
    assert eng.batch_executor.counters == ref.counters
    assert eng.batch_executor.counters["ftree_queries"] == 0


def test_no_join_query_raises():
    """Queries without joins run as filter + projection stage ops in the
    batch path (the name is from when they raised)."""
    rels = [_u64([1, 2, 3], [10, 20, 30])]
    queries = [Query([0], [], [FilterPred(0, 0, "<", 3)],
                     [Projection(0, 1)]),
               Query([0], [], [FilterPred(0, 0, ">", 3)],
                     [Projection(0, 0)]),
               Query([0, 0], [], [], [Projection(1, 1)])]
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, EngineConfig(), device="cpu")
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    assert want == ["0", "NULL", "0"]       # a never-joined slot sums 0
    assert eng.run_batch(pqueries) == want
    assert eng.batch_executor.counters["readbacks"] == 1


def _huge_agree(monkeypatch, config, **jax_names):
    """A 1500-row relation past a shrunken _BIG_WAVE_ROWS (1024, both
    packages: the reference's window folds need 1024 rows) through the
    windowed huge-node pass: the port's Engine under `config` equals the
    oracle and the JAX engine under `jax_names` (its window and table
    settings, which the port does not have)."""
    from radixhashjoin_tpu.ops import factorized as jax_factorized
    from radixhashjoin_tpu_torch.ops import factorized
    for mod in (factorized, jax_factorized):
        monkeypatch.setattr(mod, "_BIG_WAVE_ROWS", 1024)
    rng = np.random.default_rng(5)
    rels = [Relation([rng.integers(0, 40, 1500).astype(U64),
                      rng.integers(0, 1000, 1500).astype(U64)]),
            Relation([rng.integers(0, 40, 30).astype(U64)])]
    queries = [Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
                     [Projection(0, 1), Projection(1, 0)]),
               Query([0, 1], [JoinPred(0, 0, 1, 0)],
                     [FilterPred(0, 1, ">", 5000)], [Projection(0, 0)])]
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, config, device="cpu")
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    assert want[1] == "NULL"
    assert eng.run_batch(pqueries) == want
    ref = JaxBatch(rels, JaxConfig(**jax_names))
    assert [format_result(r, len(q.projections))
            for r, q in zip(ref.run_batch(queries), queries)] == want
    assert eng.batch_executor.counters["ftree_queries"] == 2


def test_huge_node_raises(monkeypatch):
    """Nodes past _BIG_WAVE_ROWS run the windowed huge-node pass (the
    name is from when they raised)."""
    _huge_agree(monkeypatch, EngineConfig())


@pytest.mark.parametrize("field,value", [
    ("mesh_devices", 2), ("force_oracle", True), ("profile", True),
    ("ftree_window_sort", "on"), ("ftree_scatter", "mxu"),
    ("ftree_gather", "xla"), ("ftree_wave", False), ("stage_group", 3),
])
def test_unported_config_raises(field, value, monkeypatch):
    """Settings that raised until they were ported now run, and give the
    JAX package's lines under the same setting and the oracle's (the name
    is from when they raised). The port has no table or window names: it
    runs its default, which gives the lines of JAX under each name, also
    through the huge-node windows."""
    if field == "ftree_window_sort":
        # the port's one unsorted window pass gives the lines of the
        # reference's sorted windows on a huge node
        _huge_agree(monkeypatch, EngineConfig(), **{field: value})
        return
    if field == "mesh_devices":
        # ported: a distributed engine needs the world it names, and with
        # no process group it raises rather than run on one device
        # (tests/test_torch_dist_engine.py runs it on gloo ranks)
        with pytest.raises(RuntimeError, match="process group"):
            _port_engine([_u64([1, 2])], EngineConfig(**{field: value}))
        return
    if field in ("ftree_scatter", "ftree_gather"):
        _huge_agree(monkeypatch, EngineConfig(), **{field: value})
        _table_impls_agree(**{field: value})
        return
    # ported (tests/test_torch_settings.py covers each setting in full):
    # the JAX engine under the same setting, the Pallas one-hot build
    rels, queries = _merge(_shapes() + [_fuzz(0)])
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, EngineConfig(**{field: value}), device="cpu")
    got = eng.run_batch(pqueries)
    ref = JaxEngine(rels, JaxConfig(ftree_scatter="onehot",
                                    **{field: value}))
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    assert got == want
    assert ref.run_batch(queries) == want
    if field == "force_oracle":
        assert eng.batch_executor.counters["dispatches"] == 0
    else:
        assert (eng.batch_executor.counters
                == ref.batch_executor.counters)


def _table_impls_agree(ftree_scatter="auto", ftree_gather="auto"):
    """_shapes() and _fuzz(0): the port's default lines equal the oracle's
    and the JAX engine's under one ftree_scatter / ftree_gather pair of
    JAX's table names, with equal counters."""
    rels, queries = _merge(_shapes() + [_fuzz(0)])
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, EngineConfig(), device="cpu")
    got = eng.run_batch(pqueries)
    ref = JaxBatch(rels, JaxConfig(ftree_scatter=ftree_scatter,
                                   ftree_gather=ftree_gather))
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    assert got == want
    assert [format_result(r, len(q.projections))
            for r, q in zip(ref.run_batch(queries), queries)] == want
    assert eng.batch_executor.counters == ref.counters
    assert eng.batch_executor.counters["ftree_queries"] > 0


# with test_unported_config_raises' ("mxu", "auto") and ("auto", "xla"),
# every name JAX's table dispatch distinguishes, on the build and on the
# lookup side ("hier_presorted" is a window name: a one-shot build falls
# through to the engine, as in JAX)
TABLE_IMPL_PAIRS = [("onehot", "onehot"), ("hier", "xla"),
                    ("sorted", "onehot"), ("xla", "xla"),
                    ("hier_presorted", "auto"), ("auto", "hier")]


@pytest.mark.parametrize("scatter,gather", TABLE_IMPL_PAIRS)
def test_table_impls_match_jax_and_oracle(scatter, gather):
    _table_impls_agree(scatter, gather)


@pytest.mark.parametrize("scatter", ["hier", "hier_presorted", "sorted",
                                     "xla"])
def test_table_impls_huge_windows(scatter, monkeypatch):
    """The port's window builds of the huge-node pass against JAX's
    engine under each of its build names (its scatter_add_window; "mxu"
    in test_unported_config_raises)."""
    _huge_agree(monkeypatch, EngineConfig(), ftree_scatter=scatter)


@pytest.mark.parametrize("field,value", [
    ("enable_join_reordering", True), ("factorized", False),
    ("fuse_stages", False), ("join_backend", "sort"),
    ("max_dense_domain", 512),
])
def test_lifted_config_runs(field, value):
    """Settings that raised before the materialized fallback was ported
    now run the batch path and match the JAX engine and the oracle."""
    rels, queries = _fuzz(0)
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, EngineConfig(**{field: value}), device="cpu")
    got = eng.run_batch(pqueries)
    ref = JaxBatch(rels, JaxConfig(**{field: value}))
    planned = queries
    if field == "enable_join_reordering":
        # the port's order (JAX's on fresh-slot chains, else the written
        # one: tests/test_torch_faults.py), run by both engines
        from radixhashjoin_tpu_torch.models.planner import reorder_joins
        planned = [_from_port(q, reorder_joins(pq, prels))
                   for q, pq in zip(queries, pqueries)]
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in planned]
    assert got == want
    assert [format_result(r, len(q.projections))
            for r, q in zip(ref.run_batch(planned), queries)] == want
    assert eng.batch_executor.counters == ref.counters
    if field == "max_dense_domain":
        assert eng.batch_executor.join.kind == "sort"


@pytest.mark.parametrize("field,value", [
    ("batch_execution", False), ("ftree_scatter", "auto"),
    ("ftree_gather", "auto"), ("ftree_window_sort", "auto"),
])
def test_retired_config_fields_raise(field, value):
    """The settings that chose a second path (the per-query executor, the
    table variants, the sorted windows) are not fields: passing one, even
    at JAX's default, raises TypeError, and the engine has no per-query
    executor."""
    assert field in {f.name for f in dataclasses.fields(JaxConfig)}
    with pytest.raises(TypeError, match=field):
        EngineConfig(**{field: value})
    eng = _port_engine([_u64([1, 2, 2])], EngineConfig())
    assert not hasattr(eng, "executor")
    assert eng.execute(tworkload.parse_query("0 0|0.0=1.0|0.0")) == [9]


# ---- CLI and process-level checks ----

def _write_catalog(tmp_path, rels):
    paths = []
    for i, rel in enumerate(rels):
        p = tmp_path / f"r{i}"
        tstorage.write_relation(str(p), list(rel.values))
        paths.append(str(p))
    return paths


def _run_cli(args, stream):
    return subprocess.run([sys.executable, "-m", "radixhashjoin_tpu_torch",
                           *args], input=stream, capture_output=True,
                          text=True, cwd=REPO, timeout=240)


def test_cli_subprocess_cpu(tmp_path):
    rels, queries = _fuzz(1)
    paths = _write_catalog(tmp_path, rels)
    work = []
    for i, q in enumerate(queries):
        work.append(_line(q))
        if i % 3 == 2:
            work.append("F")
    stream = "\n".join(paths + ["Done"] + work + ["F"]) + "\n"
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    proc = _run_cli(["--device", "cpu"], stream)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == want


def test_port_never_imports_jax():
    """Neither jax nor the JAX package: the port runs without both."""
    code = (
        "import sys, numpy as np\n"
        "from radixhashjoin_tpu_torch import Engine, EngineConfig\n"
        "from radixhashjoin_tpu_torch.storage import Relation\n"
        "from radixhashjoin_tpu_torch.workload import parse_query\n"
        "r = Relation([np.array([1, 2, 2], np.uint64)])\n"
        "eng = Engine([r, r], EngineConfig(), device='cpu')\n"
        "q = parse_query('0 1|0.0=1.0|0.0')\n"
        "assert eng.run_batch([q]) == ['9'], eng.run_batch([q])\n"
        "eng = Engine([r, r], EngineConfig(join_backend='sort'), "
        "device='cpu')\n"
        "assert eng.run_batch([q]) == ['9'], eng.run_batch([q])\n"
        "import radixhashjoin_tpu_torch.__main__, radixhashjoin_tpu_torch."
        "kernels, radixhashjoin_tpu_torch.oracle\n"
        "import radixhashjoin_tpu_torch.bench_kernels\n"
        "import radixhashjoin_tpu_torch.ops.partition\n"
        "import radixhashjoin_tpu_torch.ops.radix_hist\n"
        "import radixhashjoin_tpu_torch.runtime, radixhashjoin_tpu_torch."
        "utils\n"
        "assert 'jax' not in sys.modules\n"
        "assert 'radixhashjoin_tpu' not in sys.modules\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cli_refuses_no_batch(tmp_path):
    """The CLI has no --no-batch (the per-query executor is retired;
    --backend sort gives the materializing sort join): argparse exits 2
    and nothing is printed."""
    paths = _write_catalog(tmp_path, [_u64([1, 2])])
    proc = _run_cli(["--device", "cpu", "--no-batch"],
                    "\n".join(paths + ["Done", "0 0|0.0=1.0|0.0", "F"]))
    assert proc.returncode == 2
    assert "unrecognized arguments: --no-batch" in proc.stderr
    assert proc.stdout == ""


def test_cli_without_cuda_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    paths = _write_catalog(tmp_path, [_u64([1, 2])])
    proc = _run_cli([], "\n".join(paths + ["Done", "0 0|0.0=1.0|0.0", "F"]))
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert proc.stdout == ""
