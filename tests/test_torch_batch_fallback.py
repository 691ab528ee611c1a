"""The wave-batched materialized fallback of the PyTorch port
(radixhashjoin_tpu_torch: ops/stage.py op kinds, ops/terminal.py,
ops/chain.py, ops/backend.py, models/stats.py, models/planner.py and the
BatchExecutor's fused and per-op paths) against the JAX package and
the NumPy oracle, on the CPU.

Operators are held element-exact against their JAX functions on the
same numpy inputs made from a seed (tolerance 0): matrices, counts and
flags as arrays, sums through JAX's host combiner on one side and
`int & (2**64 - 1)` on the other. The stage op kinds are compared round
by round inside real batches: both packages' stage runners are
recorded, and every kept matrix, count and probe, every flag and every
partial must agree. The engine's lines must equal the JAX engine's and
the oracle's, with equal counters, under the default config,
factorized=False, fuse_stages=False, join_backend="sort" and
enable_join_reordering=True.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radixhashjoin_tpu.models.batch as jbatch
import radixhashjoin_tpu_torch.models.batch as pbatch
from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.models import planner as jplanner
from radixhashjoin_tpu.models import stats as jstats
from radixhashjoin_tpu.ops import aggregate as jaggregate
from radixhashjoin_tpu.ops import backend as jbackend
from radixhashjoin_tpu.ops import chain as jchain
from radixhashjoin_tpu.ops import stage as jstage
from radixhashjoin_tpu.ops import terminal as jterminal
from radixhashjoin_tpu.oracle import OracleExecutor, format_result
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu.utils import limbs as jlimbs
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models import planner as pplanner
from radixhashjoin_tpu_torch.models import stats as pstats
from radixhashjoin_tpu_torch.models.engine import Engine
from radixhashjoin_tpu_torch.ops import aggregate as paggregate
from radixhashjoin_tpu_torch.ops import backend as pbackend
from radixhashjoin_tpu_torch.ops import chain as pchain
from radixhashjoin_tpu_torch.ops import stage as pstage
from radixhashjoin_tpu_torch.ops import terminal as pterminal
from radixhashjoin_tpu_torch.ops.join import JoinCapacityError
from radixhashjoin_tpu_torch.utils import limbs as plimbs

from test_fuzz import _random_catalog, _random_query
from test_torch_engine import (CASE3, _from_port, _merge, _to_port, _u64,
                               _wide_case)
from test_torch_executor import SHAPES, _shapes_catalog

torch.set_num_threads(1)

MASK = (1 << 64) - 1
DOMAIN = 1024

MATERIALIZED_KINDS = {
    "ffull", "flive", "eqrows", "eqmat", "probe1", "probe2", "expand_pair",
    "expand_attach", "spec_pair", "spec_attach", "terminal", "defer_attach",
    "project", "project_w", "project_defer", "project_defer_nt"}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(jax_arr, port_t):
    j = np.asarray(jax_arr)
    p = port_t.numpy()
    return j.shape == p.shape and np.array_equal(j, p)


def _jcombine(kind, seg):
    """JAX's host combine of one packed partial."""
    if isinstance(kind, tuple):
        return jbatch._COMBINERS[kind[0]](seg, kind[1]) & MASK
    return jbatch._COMBINERS[kind](seg) & MASK


# ---- operators, on numpy inputs from a seed ----

def _rowids(rng, n_rows, width, count):
    """A padded rowid vector: `count` live rowids, then garbage lanes
    (out-of-range ones included: both packages clamp them)."""
    r = rng.integers(0, n_rows + 5, width).astype(np.int32)
    r[:count] = rng.integers(0, n_rows, count)
    return r


@pytest.mark.parametrize("seed", range(3))
def test_eq_filters_match_jax(seed):
    rng = np.random.default_rng(seed)
    n_rows, width = 70, 1024
    colA = rng.integers(0, 4, n_rows).astype(np.int32)
    colB = rng.integers(0, 4, n_rows).astype(np.int32)
    count = int(rng.integers(1, width))
    mat = np.stack([_rowids(rng, n_rows, width, count) for _ in range(3)])
    jm, jc = jchain.eq_filter_matrix(jnp.asarray(colA), jnp.asarray(colB),
                                     jnp.asarray(mat), 0, 2,
                                     jnp.int32(count))
    pm, pc = pchain.eq_filter_matrix(_t(colA), _t(colB), _t(mat), 0, 2,
                                     torch.tensor(count, dtype=torch.int32))
    assert _eq(jm, pm) and int(jc) == int(pc)
    rows = mat[1]
    jr, jc = jchain.eq_filter_rows(jnp.asarray(colA), jnp.asarray(colB),
                                   jnp.asarray(rows), jnp.int32(count))
    pr, pc = pchain.eq_filter_rows(_t(colA), _t(colB), _t(rows), count)
    assert _eq(jr, pr) and int(jc) == int(pc)


@pytest.mark.parametrize("kind", ["dense", "sort"])
def test_backend_matches_jax(kind):
    """Probes, expansions and the case-3 pair-set test of both
    backends, garbage lanes past the live counts included."""
    rng = np.random.default_rng(1 if kind == "dense" else 2)
    jb = jbackend.JoinBackend(kind, DOMAIN)
    pb = pbackend.JoinBackend(kind, DOMAIN)
    n_l, n_r = 90, 60
    col_l = rng.integers(0, 3, n_l).astype(np.int32)
    col_r = rng.integers(0, 3, n_r).astype(np.int32)
    lrows = _rowids(rng, n_l, 1024, 80)
    rrows = _rowids(rng, n_r, 1024, 50)
    jp = jb.probe_rows(jnp.asarray(col_l), jnp.asarray(lrows), np.int32(80),
                       jnp.asarray(col_r), jnp.asarray(rrows), np.int32(50))
    pp = pb.probe_rows(_t(col_l), _t(lrows), 80, _t(col_r), _t(rrows), 50)
    assert all(_eq(a, b) for a, b in zip(jp, pp))
    total = int(pp[4])
    assert total > 1024      # the expansion's padded size is 2048
    jm = jb.expand_fresh_pair(*jp[:4], jnp.asarray(lrows),
                              jnp.asarray(rrows), 2048)
    pm = pb.expand_fresh_pair(*pp[:4], _t(lrows), _t(rrows), 2048)
    assert _eq(jm, pm)
    # case 2: the pair matrix's slot-1 row against a third live set
    col_f = rng.integers(0, 12, 40).astype(np.int32)
    frows = _rowids(rng, 40, 1024, 30)
    jp2 = jb.probe_matrix(jnp.asarray(col_r), jm, np.int32(1),
                          np.int32(total), jnp.asarray(col_f),
                          jnp.asarray(frows), np.int32(30))
    pp2 = pb.probe_matrix(_t(col_r), pm, 1, total, _t(col_f), _t(frows), 30)
    assert all(_eq(a, b) for a, b in zip(jp2, pp2))
    out = 1 << int(int(pp2[4]) - 1).bit_length()
    jm2 = jb.expand_attach_fresh(*jp2[:4], jm, jnp.asarray(frows), out)
    pm2 = pb.expand_attach_fresh(*pp2[:4], pm, _t(frows), out)
    assert _eq(jm2, pm2)
    for a, b, cnt in ((0, 2, total), (1, 2, 7), (0, 1, 0)):
        got = pb.any_common_matrix(_t(col_l), _t(col_f), pm2, a, b, cnt)
        want = jb.any_common_matrix(jnp.asarray(col_l), jnp.asarray(col_f),
                                    jm2, a, b, np.int32(cnt))
        assert bool(got) == bool(want)


@pytest.mark.parametrize("m,v", [(1, 0), (1, 2**31 - 1), (3, 2**30),
                                 (1000, 0xFFFF), (2**16, 2**20),
                                 (2**20, 2**31 - 1), (2**30, 7)])
def test_channel_spec_matches_jax(m, v):
    assert pterminal.channel_spec(m, v) == jterminal.channel_spec(m, v)


def _terminal_case(rng, wide=False):
    n_f, n_e = 50, 80
    vmax = 2**31 - 1 if wide else 1000
    cols = {
        "full": rng.integers(0, 10, n_e).astype(np.int32),
        "fresh_join": rng.integers(0, 10, n_f).astype(np.int32),
        "fresh_proj": rng.integers(0, vmax, n_f).astype(np.int32),
        "ex_proj": rng.integers(0, vmax, n_e).astype(np.int32),
    }
    mat = np.stack([_rowids(rng, n_e, 1024, 70) for _ in range(2)])
    frows = _rowids(rng, n_f, 1024, 45)
    mult = rng.integers(0, 5, 1024).astype(np.int32)
    return cols, mat, frows, mult


@pytest.mark.parametrize("ex_kind,with_mult,wide", [
    ("mat", False, False), ("mat", True, False), ("rows", False, False),
    ("rows", True, True), ("mat", False, True)])
def test_terminal_matches_jax(ex_kind, with_mult, wide):
    """terminal_join_and_project: the NULL flag and every projection's
    sum (fresh T channels, existing-side weighted sums)."""
    rng = np.random.default_rng(hash((ex_kind, with_mult, wide)) % 2**32)
    cols, mat, frows, mult = _terminal_case(rng, wide)
    ch = jterminal.channel_spec(50, 2**31 - 1 if wide else 1000)
    if ex_kind == "mat":
        specs = (("fresh", ch), ("mat", 0), ("mat", 1))
        src, cnt, full_row = mat, 70, 1
    else:
        specs = (("fresh", ch), ("rows",))
        src, cnt, full_row = mat[0], 70, 0
    pcols = [cols["fresh_proj"]] + [cols["ex_proj"]] * (len(specs) - 1)
    plan = (ex_kind, full_row, specs)
    je, jouts = jterminal.terminal_join_and_project(
        jnp.asarray(src), np.int32(cnt), jnp.asarray(frows), np.int32(45),
        jnp.asarray(cols["full"]), jnp.asarray(cols["fresh_join"]),
        tuple(jnp.asarray(c) for c in pcols), plan, DOMAIN,
        mult=jnp.asarray(mult) if with_mult else None)
    pe, pouts = pterminal.terminal_join_and_project(
        _t(src), cnt, _t(frows), 45, _t(cols["full"]),
        _t(cols["fresh_join"]), tuple(_t(c) for c in pcols), plan, DOMAIN,
        mult=_t(mult).to(torch.int64) if with_mult else None)
    assert bool(je) == bool(pe)
    for spec, jo, po in zip(specs, jouts, pouts):
        if spec[0] == "fresh":
            kind = ("fresh_w" if with_mult else "fresh", spec[1])
        else:
            kind = "weighted"
        assert po.shape == (pstage.part_shape(kind),)
        assert (_jcombine(kind, np.asarray(jo))
                == pbatch._combine(kind, po.tolist()))


def test_dense_counts_match_jax():
    rng = np.random.default_rng(4)
    lv = rng.integers(0, 30, 1024).astype(np.int32)
    rv = rng.integers(0, 30, 2048).astype(np.int32)
    jc, jl = jterminal._dense_counts(jnp.asarray(lv), 1000, jnp.asarray(rv),
                                     1500, DOMAIN)
    pc, pl = pterminal._dense_counts(_t(lv), 1000, _t(rv), 1500, DOMAIN)
    assert _eq(jc, pc) and _eq(jl, pl)


def test_aggregate_and_weighted_fold_match_jax():
    """Plain and weighted sums, past 2**63 and wrapping past 2**64."""
    rng = np.random.default_rng(6)
    col = rng.integers(2**31 - 100, 2**31 - 1, 300).astype(np.int32)
    mat = np.stack([_rowids(rng, 300, 1024, 900) for _ in range(2)])
    jp = jaggregate.gather_partials_matrix(jnp.asarray(col),
                                           jnp.asarray(mat), 1,
                                           np.int32(900))
    pp = paggregate.gather_partials_matrix(_t(col), _t(mat), 1, 900)
    assert jlimbs.combine_limb_partials(np.asarray(jp)) == int(pp) & MASK
    w = rng.integers(2**30, 2**31 - 1, 1024).astype(np.int32)
    vals = col[np.minimum(mat[0], 299)]
    jw = jlimbs.weighted_partials(jnp.asarray(vals), jnp.asarray(w),
                                  np.int32(1000))
    pw = plimbs.weighted_partials(_t(vals), _t(w), 1000)
    want = int(sum(int(a) * int(b) for a, b in zip(vals[:1000], w[:1000])))
    assert want > 2**64
    assert (jlimbs.combine_weighted_partials(np.asarray(jw))
            == int(pw) & MASK == want & MASK)


def test_stats_and_reorder_match_jax():
    """The host estimator and the join-order planner: equal stats after
    filters and joins; equal join orders on queries that attach one fresh
    slot per join, and the written order on every other query, which
    JAX's planner reorders (the declared divergence of fault B,
    tests/test_torch_faults.py)."""
    rng = np.random.default_rng(8)
    rels = _random_catalog(rng)
    prels, _ = _to_port(rels)
    for _ in range(12):
        q = _random_query(rng, rels)
        _, (pq,) = _to_port(rels, [q])
        js = jstats.seed_stats(rels, q.slots)
        ps = pstats.seed_stats(prels, pq.slots)
        for f, pf in zip(q.filters, pq.filters):
            n = jplanner._rough_filter_estimate(js[f.slot], f.col, f.op,
                                                f.value)
            assert n == pplanner._rough_filter_estimate(
                ps[pf.slot], pf.col, pf.op, pf.value)
            js[f.slot].apply_filter(f.col, f.op, f.value, n)
            ps[pf.slot].apply_filter(pf.col, pf.op, pf.value, n)
        for j, pj in zip(q.joins, pq.joins):
            assert (jstats.estimate_join_output(js[j.slot1], j.col1,
                                                js[j.slot2], j.col2)
                    == pstats.estimate_join_output(ps[pj.slot1], pj.col1,
                                                   ps[pj.slot2], pj.col2))
            jplanner._propagate_join(js, j)
            pplanner._propagate_join(ps, pj)
        assert [vars(s) for s in js] == [vars(s) for s in ps]
        jo = (jplanner.reorder_joins(q, rels).joins
              if pplanner.fresh_slot_chain(pq.joins) else q.joins)
        po = pplanner.reorder_joins(pq, prels).joins
        assert ([(j.slot1, j.col1, j.slot2, j.col2) for j in jo]
                == [(j.slot1, j.col1, j.slot2, j.col2) for j in po])


# ---- stage op kinds, round by round inside real batches ----

def _op_kind_case():
    """A batch whose plans reach every materialized op kind (with
    speculation on for spec_*, off for probe*/expand_*)."""
    rels = _shapes_catalog()
    queries = list(SHAPES.values()) + [
        # deferred attach, then a joined same-slot predicate: the
        # pipeline ends on a row filter -> project_w, project_defer_nt
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 0, 2)], [],
              [Projection(0, 1), Projection(1, 2)]),
        # star with two filters on one slot: ffull, flive, defer_attach,
        # terminal, project_defer
        Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
              [FilterPred(1, 1, "<", 4), FilterPred(1, 2, ">", 0)],
              [Projection(0, 2), Projection(1, 1), Projection(2, 1)]),
        # a middle join that a later join references: spec or probe
        Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
                          JoinPred(2, 1, 1, 2)], [],
              [Projection(0, 1), Projection(2, 2)]),
    ]
    return rels, queries


_OP_CONFIGS = {
    "default": {},
    "materialized": {"factorized": False},
    "materialized_exact": {"factorized": False,
                           "speculate_expansions": False},
}


def _record(monkeypatch):
    """Record both packages' stage runs and final sweeps."""
    rec = {"jax_rounds": [], "port_rounds": [], "jax_sweeps": [],
           "port_sweeps": []}

    def wrap_stage(module, key):
        orig = module.run_stage

        def run(*a, **k):
            out = orig(*a, **k)
            rec[key].append((a[7], out))
            return out
        monkeypatch.setattr(module, "run_stage", run)

    wrap_stage(jbatch, "jax_rounds")
    wrap_stage(pbatch, "port_rounds")
    j_sweep = jbatch.BatchExecutor._final_sweep_fused
    p_sweep = pbatch.BatchExecutor._final_sweep_fused

    def jsw(self, states, vecs):
        out = j_sweep(self, states, vecs)
        rec["jax_sweeps"].append((states, dict(self._vec_np)))
        return out

    def psw(self, states, vecs, host):
        out = p_sweep(self, states, vecs, host)
        rec["port_sweeps"].append((states, host))
        return out
    monkeypatch.setattr(jbatch.BatchExecutor, "_final_sweep_fused", jsw)
    monkeypatch.setattr(pbatch.BatchExecutor, "_final_sweep_fused", psw)
    return rec


def _wave_form(plan):
    """JAX keeps a lone ftree op as ("ftree", ...); the port always runs
    a wave (ROADMAP.md item 11)."""
    return tuple(("ftree_wave", ((op[1], op[2], op[3]),), op[2], op[3])
                 if op[0] == "ftree" else op for op in plan)


@pytest.mark.parametrize("cfg", sorted(_OP_CONFIGS))
def test_stage_op_kinds_match_jax(monkeypatch, cfg):
    rels, queries = _op_kind_case()
    prels, pqueries = _to_port(rels, queries)
    rec = _record(monkeypatch)
    got = Engine(prels, EngineConfig(**_OP_CONFIGS[cfg]),
                 device="cpu").run_batch(pqueries)
    jax_out = jbatch.BatchExecutor(rels, JaxConfig(**_OP_CONFIGS[cfg]))
    jax_lines = [format_result(r, len(q.projections))
                 for r, q in zip(jax_out.run_batch(queries), queries)]
    oracle = OracleExecutor(rels)
    assert got == jax_lines == [format_result(oracle.execute(q),
                                              len(q.projections))
                                for q in queries]
    # round by round: the same plans, the same kept device state
    assert len(rec["jax_rounds"]) == len(rec["port_rounds"]) >= 1
    for (jplan, jout), (pplan, pout) in zip(rec["jax_rounds"],
                                            rec["port_rounds"]):
        assert _wave_form(jplan) == pplan
        assert jstage.touched_state(jplan) == pstage.touched_state(pplan)
        for i in (1, 2, 3, 4):          # live rows/counts, mats, icounts
            assert len(jout[i]) == len(pout[i])
            for a, b in zip(jout[i], pout[i]):
                assert _eq(a, b)
        for jp, pp in zip(jout[5], pout[5]):
            assert all(_eq(a, b) for a, b in zip(jp, pp[:4]))
    # every flag, spec flag and partial of every query
    assert len(rec["jax_sweeps"]) == len(rec["port_sweeps"])
    for (jstates, jvec), (pstates, pvec) in zip(rec["jax_sweeps"],
                                                rec["port_sweeps"]):
        for js, ps in zip(jstates, pstates):
            assert js.null == ps.null
            assert js.flag_refs == ps.flag_refs
            assert js.spec_refs == ps.spec_refs
            assert ([int(jvec[v][o]) for v, o in js.flag_refs]
                    == [pvec[v][o] for v, o in ps.flag_refs])
            assert ([int(jvec[v][o]) for v, o in js.spec_refs]
                    == [pvec[v][o] for v, o in ps.spec_refs])
            assert len(js.sums) == len(ps.sums)
            for jsum, psum in zip(js.sums, ps.sums):
                assert len(jsum) == len(psum)
                for (jk, (jv, jo, shape), jsh), (pk, (pv, po, size), psh) \
                        in zip(jsum, psum):
                    assert jk == pk and jsh == psh
                    n = int(np.prod(shape))
                    seg = np.asarray(jvec[jv][jo:jo + n]).reshape(shape)
                    assert (_jcombine(jk, seg)
                            == pbatch._combine(pk, pvec[pv][po:po + size]))


def test_op_kinds_covered(monkeypatch):
    """The op-kind batch reaches every materialized op kind."""
    rels, queries = _op_kind_case()
    prels, pqueries = _to_port(rels, queries)
    rec = _record(monkeypatch)
    for cfg in ("materialized", "materialized_exact"):
        Engine(prels, EngineConfig(**_OP_CONFIGS[cfg]),
               device="cpu").run_batch(pqueries)
    kinds = {op[0] for plan, _ in rec["port_rounds"] for op in plan}
    assert kinds == MATERIALIZED_KINDS


# ---- the engine: lines and counters under five configs ----

_ENGINE_CONFIGS = {
    "default": {},
    "factorized_off": {"factorized": False},
    "fuse_stages_off": {"fuse_stages": False},
    "sort_backend": {"join_backend": "sort"},
    "join_reordering": {"enable_join_reordering": True},
    "exact_probes": {"factorized": False, "speculate_expansions": False},
}


def _catalog(name):
    if name == "case3":
        return _merge([(rels, [q]) for rels, q, _e in CASE3])
    cases = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        rels = _random_catalog(rng)
        cases.append((rels, [_random_query(rng, rels) for _ in range(8)]))
    return _merge(cases)


def _agree(rels, queries, kw, configs=None):
    """Port == JAX == oracle lines, equal counters; the oracle and JAX's
    batch executor run the query the port's engine runs (in the port's
    order when reordering is on). `configs`: the (port, JAX) config
    objects, else both built from `kw`."""
    pcfg, jcfg = configs or (EngineConfig(**kw), JaxConfig(**kw))
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, pcfg, device="cpu")
    got = eng.run_batch(pqueries)
    ref = jbatch.BatchExecutor(rels, jcfg)
    planned = ([_from_port(q, pplanner.reorder_joins(pq, prels))
                for q, pq in zip(queries, pqueries)]
               if kw.get("enable_join_reordering") else queries)
    jax_lines = [format_result(r, len(q.projections))
                 for r, q in zip(ref.run_batch(planned), queries)]
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in planned]
    assert got == want
    assert jax_lines == want
    assert eng.batch_executor.counters == ref.counters
    return got, eng.batch_executor.counters


@pytest.mark.parametrize("catalog", ["case3", "fuzz"])
@pytest.mark.parametrize("cfg", sorted(_ENGINE_CONFIGS))
def test_engine_matches_jax_and_oracle(catalog, cfg):
    rels, queries = _catalog(catalog)
    assert len(queries) <= 64        # one JAX stage group
    _, counters = _agree(rels, queries, _ENGINE_CONFIGS[cfg])
    if cfg == "exact_probes":
        assert counters["readbacks"] > 1


@pytest.mark.parametrize("cfg", ["default", "factorized_off",
                                 "sort_backend"])
def test_wide_u64_on_the_fallback(cfg):
    """Dictionary codes and two-plane columns through cycles, no-join
    queries and materialized joins: sums past 2**63 and 2**64."""
    rels, queries = _wide_case()
    queries = list(queries) + [
        Query([0, 1, 0], [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 2, 0),
                          JoinPred(2, 1, 0, 1)], [],
              [Projection(1, 1), Projection(2, 0)]),
        Query([2], [], [FilterPred(0, 0, ">", 2**62)], [Projection(0, 0)]),
        Query([2, 2, 2], [JoinPred(0, 1, 1, 1), JoinPred(1, 0, 2, 0),
                          JoinPred(2, 1, 0, 1)], [], [Projection(2, 0)]),
    ]
    got, _ = _agree(rels, queries, _ENGINE_CONFIGS[cfg])
    assert int(got[0].split()[0]) > 2**40
    assert got[1] == str((8 * (2**63 - 7)) % 2**64)    # wrapped past 2**64
    assert got[5] == got[1]                            # through the cycle


def test_mis_speculation_retries_like_jax(monkeypatch):
    """A speculative expansion sized far below its pair total fails its
    device check and the query reruns on the exact path, in both
    packages alike."""
    rng = np.random.default_rng(0)
    rels = [Relation([rng.integers(0, 8, 200).astype(np.uint64)
                      for _ in range(3)]) for _ in range(3)]
    q = Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
                          JoinPred(2, 1, 0, 1)], [],
              [Projection(0, 2), Projection(2, 2)])
    configs = (EngineConfig(), JaxConfig())
    for cfg in configs:
        monkeypatch.setattr(cfg, "speculate_slack", 1e-6)
    _, counters = _agree(rels, [q], {}, configs)
    assert counters["spec_retries"] == 1
    assert counters["readbacks"] > 1


def test_negative_probe_total_raises():
    """2**31 pairs of a middle join (65,536 x 32,768 equal keys): the
    exact probe's total reads back as -1 and the batch raises."""
    rels = [_u64(np.full(1 << 16, 5), np.full(1 << 16, 1)),
            _u64(np.full(1 << 15, 5), np.full(1 << 15, 1)), _u64([1], [1])]
    q = Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
                          JoinPred(2, 1, 0, 1)], [], [Projection(0, 0)])
    prels, (pq,) = _to_port(rels, [q])
    eng = Engine(prels, EngineConfig(), device="cpu")
    with pytest.raises(JoinCapacityError):
        eng.run_batch([pq])
    assert eng.batch_executor.counters["readbacks"] == 1


def test_int64_weights_past_int32_divergence():
    """A per-row weight of 2**32 (one row x 2**16 x 2**16 matches, past
    the factorized caps): the reference's int32 count x multiplicity
    product wraps to 0, the port's int64 product does not (ROADMAP.md
    §3). The port equals the closed form, wide two-plane values and the
    2**64 wrap included."""
    p0 = 2**40 + 3
    n = 1 << 16
    rels = [_u64([5], [p0]), _u64(np.full(n, 5), np.full(n, 7)),
            _u64(np.full(n, 5), np.full(n, 9))]
    q = Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(0, 0, 2, 0)], [],
              [Projection(0, 1), Projection(1, 1), Projection(2, 1)])
    want = [(p0 << 32) & MASK, (7 << 32) & MASK, (9 << 32) & MASK]
    prels, (pq,) = _to_port(rels, [q])
    eng = Engine(prels, EngineConfig(), device="cpu")
    assert eng.batch_executor.run_batch([pq]) == [want]
    assert eng.batch_executor.counters["ftree_queries"] == 0
    jax_sums = jbatch.BatchExecutor(rels, JaxConfig()).run_batch([q])[0]
    assert jax_sums[0] != want[0] and jax_sums[1:] == want[1:]
