"""The engine settings the port runs since the reference's whole engine
surface was ported: stage_group, ftree_wave=False, defer_middle=False,
force_oracle=True and profile=True, against the JAX package (its
BatchExecutor and Engine under the same config, the Pallas one-hot build
in interpret mode) and the NumPy oracle, on the CPU; and the CLI's flags
as `--device cpu` subprocesses.

Lines must be identical in all three, counters equal to JAX's. Rounds
are compared op by op: with stage_group the same queries open each
round (ceil(n / k) opening rounds), with ftree_wave=False every
factorized query keeps its own ("ftree", ...) op, as in JAX, and no
"ftree_wave" op runs. The profiler must record the JAX package's
operators with the same call counts, at the same sites.
"""

import math
import subprocess
import sys

import pytest
import torch

import radixhashjoin_tpu.models.batch as jbatch
from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.models.engine import Engine as JaxEngine
from radixhashjoin_tpu.oracle import OracleExecutor, format_result
from radixhashjoin_tpu.workload import JoinPred, Projection, Query
from radixhashjoin_tpu_torch import storage as tstorage
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models import planner as pplanner
from radixhashjoin_tpu_torch.models.device_catalog import DeviceCatalog
from radixhashjoin_tpu_torch.models.engine import Engine
from radixhashjoin_tpu_torch.utils.profiling import OpProfiler

from test_torch_batch_fallback import _catalog, _record
from test_torch_engine import (REPO, _fuzz, _line, _merge, _shapes,
                               _to_port, _u64, _wide_case)

torch.set_num_threads(1)

SETTINGS = {
    "one_round": {"stage_group": None},
    "stage_group1": {"stage_group": 1},
    "stage_group2": {"stage_group": 2},
    "stage_group3": {"stage_group": 3},
    "stage_group64": {"stage_group": 64},
    "no_ftree_wave": {"ftree_wave": False},
    "no_defer_middle": {"defer_middle": False},
    "no_defer_middle_materialized": {"defer_middle": False,
                                     "factorized": False},
    "profile": {"profile": True},
}


def _data(name):
    """(rels, queries): the fuzz catalogs of tests/test_fuzz.py (with
    cycles and NULLs), every shape of tests/test_case3_rewrite.py (tree
    queries between materialized ones), or stars, chains, wiped
    components and wide u64 values."""
    if name in ("case3", "fuzz"):
        return _catalog(name)
    return _merge(_shapes() + [_wide_case()])


def _jax_kw(kw, n_queries):
    """The JAX config of a port setting: one round (stage_group=None,
    which the reference does not take) is its 64 for up to 64 queries."""
    if "stage_group" in kw and kw["stage_group"] is None:
        assert n_queries <= 64
        return dict(kw, stage_group=64)
    return kw


def _run(monkeypatch, rels, queries, kw):
    """Port == JAX (BatchExecutor, the one-hot build) == oracle lines
    under `kw`, equal counters, with both packages' rounds recorded.
    Returns (port counters, record, port batch executor)."""
    rec = _record(monkeypatch)
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, EngineConfig(**kw), device="cpu")
    got = eng.run_batch(pqueries)
    jkw = _jax_kw(kw, len(queries))
    ref = jbatch.BatchExecutor(rels, JaxConfig(ftree_scatter="onehot", **jkw))
    jax_lines = [format_result(r, len(q.projections))
                 for r, q in zip(ref.run_batch(queries), queries)]
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    assert got == want
    assert jax_lines == want
    assert eng.batch_executor.counters == ref.counters
    return eng.batch_executor.counters, rec, eng.batch_executor


@pytest.mark.parametrize("data", ["fuzz", "case3", "shapes"])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_setting_matches_jax_and_oracle(monkeypatch, setting, data):
    """Port == JAX == oracle lines and counters; round by round the same
    stage plans (a lone ftree op of JAX's is the port's one-spec wave)."""
    rels, queries = _data(data)
    kw = SETTINGS[setting]
    counters, rec, bex = _run(monkeypatch, rels, queries, kw)
    assert len(rec["jax_rounds"]) == len(rec["port_rounds"])
    plans = [p for p, _ in rec["port_rounds"]]
    for (jplan, _), pplan in zip(rec["jax_rounds"], plans):
        if kw.get("ftree_wave", True):
            jplan = tuple(("ftree_wave", ((op[1], op[2], op[3]),), op[2],
                           op[3]) if op[0] == "ftree" else op
                          for op in jplan)
        assert jplan == pplan
    kinds = [op[0] for p in plans for op in p]
    if kw.get("ftree_wave", True):
        assert "ftree" not in kinds
    else:
        assert "ftree_wave" not in kinds
        assert kinds.count("ftree") >= counters["ftree_queries"] > 0
        if data == "case3":
            # each query's ops in batch order: tree queries keep their
            # places between the materialized ones
            mat = [i for i, k in enumerate(kinds) if k != "ftree"]
            assert mat and "ftree" in kinds[mat[0]:]
    if kw.get("defer_middle") is False:
        assert "defer_attach" not in kinds
    group = EngineConfig(**kw).stage_group
    if group is not None:
        # the opening rounds: queries in order, k at a time
        opening = math.ceil(len(queries) / group)
        assert counters["dispatches"] >= opening
        if counters["readbacks"] == 1:        # no continuation round
            assert counters["dispatches"] == opening
    if kw.get("profile"):
        assert bex.profiler.ops["stage"].calls == counters["dispatches"]
    else:
        assert not bex.profiler.ops


@pytest.mark.parametrize("setting", ["default"] + sorted(SETTINGS))
def test_queries_without_operators_sum_zero(setting):
    """A round whose queries have no joins and no filters runs nothing and
    answers 0 for each projection, the oracle's line: alone in a round
    under stage_group, or a batch of only such queries. JAX's
    BatchExecutor leaves such a round's sums unset and prints empty lines
    (ROADMAP.md §3, a declared divergence)."""
    rels = [_u64([1, 2, 3], [4, 5, 6]), _u64([2, 3], [7, 8])]
    trivial = [Query([0], [], [], [Projection(0, 0), Projection(0, 1)]),
               Query([1, 0], [], [], [Projection(1, 1)])]
    joined = [Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
                    [Projection(0, 1), Projection(1, 1)])]
    oracle = OracleExecutor(rels)
    kw = SETTINGS.get(setting, {})
    for queries in (trivial, trivial[:1] + joined + trivial[1:]):
        prels, pqueries = _to_port(rels, queries)
        eng = Engine(prels, EngineConfig(**kw), device="cpu")
        want = [format_result(oracle.execute(q), len(q.projections))
                for q in queries]
        assert eng.run_batch(pqueries) == want
    assert want == ["0 0", "11 15", "0"]
    ref = jbatch.BatchExecutor(rels, JaxConfig(**_jax_kw(kw, 2)))
    assert [format_result(r, len(q.projections))
            for r, q in zip(ref.run_batch(trivial), trivial)] == ["", ""]


@pytest.mark.parametrize("data", ["fuzz", "case3", "shapes"])
def test_force_oracle_matches_jax_engine(data):
    """force_oracle=True: the port's Engine answers with its oracle, as
    JAX's Engine does with its own; the device executors run nothing."""
    rels, queries = _data(data)
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, EngineConfig(force_oracle=True), device="cpu")
    got = eng.run_batch(pqueries)
    ref = JaxEngine(rels, JaxConfig(force_oracle=True))
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    assert got == ref.run_batch(queries) == want
    assert [format_result(eng.execute(q), len(q.projections))
            for q in pqueries] == want
    assert eng.batch_executor.counters["dispatches"] == 0


@pytest.mark.parametrize("cfg", [{}, {"fuse_stages": False},
                                 {"join_backend": "sort"},
                                 {"factorized": False}])
def test_profiler_records_jax_sites(cfg):
    """profile=True: the port records the JAX package's operators, with
    the same call counts, on the fused and the per-op paths; the report
    has JAX's layout, its rows those operators, no roofline on the CPU."""
    rels, queries = _data("case3")
    prels, pqueries = _to_port(rels, queries)
    kw = dict(cfg, profile=True)
    eng = Engine(prels, EngineConfig(**kw), device="cpu")
    got = eng.run_batch(pqueries)
    ref = jbatch.BatchExecutor(rels, JaxConfig(**kw))
    jlines = [format_result(r, len(q.projections))
              for r, q in zip(ref.run_batch(queries), queries)]
    assert got == jlines
    ops = eng.batch_executor.profiler.ops
    assert ({k: s.calls for k, s in ops.items()}
            == {k: s.calls for k, s in ref.profiler.ops.items()})
    assert ops and all(s.bytes > 0 for s in ops.values())
    report = eng.batch_executor.profiler.report().splitlines()
    assert report[0] == ref.profiler.report().splitlines()[0]
    assert {ln.split()[0] for ln in report[1:-1]} == set(ops)
    assert all(ln.split()[-1] == "-" for ln in report[1:-1])
    assert report[-1].startswith("TOTAL")


def test_profile_off_records_nothing():
    prels, pqueries = _to_port(*_fuzz(0))
    eng = Engine(prels, EngineConfig(fuse_stages=False), device="cpu")
    eng.run_batch(pqueries)
    assert eng.batch_executor.profiler.report() == "(no ops recorded)"
    assert OpProfiler().record("x", 5) == 5


@pytest.mark.parametrize("field,value,err", [
    ("stage_group", 0, ValueError), ("stage_group", -3, ValueError),
    ("stage_group", 2.5, ValueError), ("stage_group", True, ValueError),
])
def test_bad_stage_group_raises(field, value, err):
    with pytest.raises(err, match="stage_group"):
        EngineConfig(**{field: value})


# ---- the default device ----

def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["engine", "from_paths", "catalog"])
def test_no_device_takes_the_card(monkeypatch, tmp_path, entry):
    """Without a device the entry points resolve the card; on a machine
    without one they raise RuntimeError naming --device cpu (never a
    TypeError, never a silent CPU)."""
    _no_card(monkeypatch)
    rels, _ = _to_port([_u64([1, 2], [3, 4])])
    path = str(tmp_path / "r0")
    tstorage.write_relation(path, list(rels[0].values))
    build = {"engine": lambda: Engine(rels),
             "from_paths": lambda: Engine.from_paths([path]),
             "catalog": lambda: DeviceCatalog(rels)}[entry]
    with pytest.raises(RuntimeError, match="--device cpu"):
        build()


# ---- the CLI's flags, as --device cpu subprocesses ----

def _cli_case(tmp_path):
    rels, queries = _merge([_fuzz(1), (_shapes()[0][0], _shapes()[0][1])])
    paths = []
    for i, rel in enumerate(rels):
        p = tmp_path / f"r{i}"
        tstorage.write_relation(str(p), list(rel.values))
        paths.append(str(p))
    work = [_line(q) for q in queries[:6]] + ["F"] + \
        [_line(q) for q in queries[6:]] + ["F"]
    return rels, queries, "\n".join(paths + ["Done"] + work) + "\n"


@pytest.mark.parametrize("flags", [
    ["--backend", "dense"], ["--backend", "sort"], ["--oracle"],
    ["--reorder-joins"], ["--no-native"], ["--profile"],
    ["--backend", "sort", "--no-native", "--profile"]],
    ids=lambda f: " ".join(f))
def test_cli_flags(tmp_path, flags):
    """Each flag of the JAX CLI prints the oracle's lines (of the
    reordered queries under --reorder-joins); --profile prints the
    per-operator table to stderr (its stage rows on the dense backend's
    fused stages, its per-op rows on the sort backend)."""
    rels, queries, stream = _cli_case(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "radixhashjoin_tpu_torch",
                           "--device", "cpu", *flags], input=stream,
                          capture_output=True, text=True, cwd=REPO,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    if "--reorder-joins" in flags:
        prels, pqueries = _to_port(rels, queries)
        planned = [pplanner.reorder_joins(q, prels) for q in pqueries]
        from radixhashjoin_tpu_torch import oracle as toracle
        ex = toracle.OracleExecutor(prels)
        want = [toracle.format_result(ex.execute(q), len(q.projections))
                for q in planned]
    else:
        ex = OracleExecutor(rels)
        want = [format_result(ex.execute(q), len(q.projections))
                for q in queries]
    assert proc.stdout.splitlines() == want
    has_table = "operator" in proc.stderr and "TOTAL" in proc.stderr
    assert has_table == ("--profile" in flags)
    if has_table:
        assert ("probe" if "sort" in flags else "stage") in proc.stderr
