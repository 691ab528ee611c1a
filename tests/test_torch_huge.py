"""The port's huge-node windowed pass (radixhashjoin_tpu_torch/ops/
factorized.py _Lazy, _scatter_add_big, _fused_node_pass; utils/limbs.py
weighted_partials_big; the uint16 projection planes of models/
device_catalog.py; ops/tables.py scatter_add_window) against the JAX
package on the same inputs.

Every test shrinks both packages' thresholds alike (_BIG_WAVE_ROWS =
2048, _BIG_WINDOW_ROWS = 4 * WCHUNK, _NARROW_PLANE_MIN_ROWS = 1024), so
that relations of a few thousand rows take the windowed paths, ragged
tails included. The engine tests mirror the JAX huge-path tests of
tests/test_factorized.py (lazy gathers, the lazy star, uint16 planes,
window builds, sorted windows, two huge nodes of different lengths,
unpackable payloads): the port's Engine and the JAX Engine run the same
seeded relations, JAX under ftree_window_sort "off" and "on", and their
lines must equal each other and the oracle's. The port has no window
setting: it runs one unsorted window pass, so its lines are held
against the reference's sorted windows too. The unit tests hold the
window machinery itself against its JAX counterpart: _fused_node_pass
under each of the reference's window policies and at several window
sizes (tables element-exact, each int64 fold equal to the JAX (5, 3)
fold decoded by combine_weighted_segments, the NULL flag equal),
weighted_partials_big and the port's one window build
(scatter_add_window) onto a nonzero accumulator against JAX's under each
of its build names. Tolerance: exact equality everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.models import device_catalog as jax_catalog
from radixhashjoin_tpu.models.engine import Engine as JaxEngine
from radixhashjoin_tpu.ops import factorized as jfac
from radixhashjoin_tpu.ops import tables as jax_tables
from radixhashjoin_tpu.oracle import OracleExecutor, format_result
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu.utils import limbs as jax_limbs
from radixhashjoin_tpu.utils.limbs import combine_weighted_segments
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models import device_catalog
from radixhashjoin_tpu_torch.models.engine import Engine
from radixhashjoin_tpu_torch.ops import factorized as tfac
from radixhashjoin_tpu_torch.ops import tables
from radixhashjoin_tpu_torch.utils import limbs
from radixhashjoin_tpu_torch.utils.limbs import U64_MASK

from test_torch_engine import _to_port

torch.set_num_threads(1)

U64 = np.uint64
WINDOW_ROWS = 4 * jax_limbs.WCHUNK


@pytest.fixture(autouse=True)
def shrunk(monkeypatch):
    """Both packages' huge-path thresholds, shrunk alike."""
    for mod in (jfac, tfac):
        monkeypatch.setattr(mod, "_BIG_WAVE_ROWS", 2048)
    for mod in (jax_limbs, limbs):
        monkeypatch.setattr(mod, "_BIG_WINDOW_ROWS", WINDOW_ROWS)
    for mod in (jax_catalog, device_catalog):
        monkeypatch.setattr(mod, "_NARROW_PLANE_MIN_ROWS", 1024)


def _col(rng, hi, n):
    return rng.integers(0, hi, n).astype(U64)


def _lines_agree(rels, queries, wsorts=("off", "on"), jax_cfg=None):
    """Port lines == oracle lines == JAX lines under each of its window
    sorts `wsorts` (and `jax_cfg`), with the same count of factorized
    queries; returns the port engine."""
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    prels, pqueries = _to_port(rels, queries)
    eng = Engine(prels, EngineConfig(), device="cpu")
    assert eng.run_workload([pqueries]) == want
    assert eng.batch_executor.counters["ftree_queries"] == len(queries)
    for ws in wsorts:
        jeng = JaxEngine(rels, JaxConfig(ftree_window_sort=ws,
                                         **(jax_cfg or {})))
        assert jeng.run_workload([queries]) == want, ws
        assert jeng.batch_executor.counters["ftree_queries"] == len(queries)
    return eng


# ---- the engine: mirrors of tests/test_factorized.py's huge-path tests ----

def test_lazy_gather_path_matches_jax():
    """One huge fact joined to a dimension: the fact's lookups stay lazy,
    the dimension's projection rides the fact's window builds; sums,
    NULL through the lazy root flag, and a fact filter whose mask is a
    lazy factor."""
    rng = np.random.default_rng(21)
    n = 6 * 4096 + 123
    fact = Relation([_col(rng, 500, n), _col(rng, 1000, n)])
    dim = Relation([np.arange(500, dtype=U64), _col(rng, 1000, 500)])
    queries = [
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(1, 1, "<", 900)],
              [Projection(0, 1), Projection(1, 1)]),
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(1, 1, "=", 12345)],
              [Projection(0, 1)]),
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(0, 1, "<", 700)],
              [Projection(0, 1), Projection(1, 1)]),
        # no dimension projection: the fact's fold runs outside any
        # window build (weighted_partials_big under "off")
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(1, 1, ">", 50)],
              [Projection(0, 1)]),
    ]
    _lines_agree([fact, dim], queries)


STAR_SHAPE = dict(n=5 * 4096 + 77, k1=300, k2=200)


def _star_rels(seed, n, k1, k2):
    rng = np.random.default_rng(seed)
    fact = Relation([_col(rng, k1, n), _col(rng, k2, n), _col(rng, 1000, n)])
    d1 = Relation([np.arange(k1, dtype=U64), _col(rng, 1000, k1)])
    d2 = Relation([np.arange(k2, dtype=U64), _col(rng, 1000, k2)])
    return [fact, d1, d2]


STAR = [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)]
STAR_QUERIES = [
    # sums on the fact and both dimensions: the down pass builds over the
    # huge fact with lazy sibling-product weights
    Query([0, 1, 2], STAR, [FilterPred(1, 1, "<", 900)],
          [Projection(0, 2), Projection(1, 1), Projection(2, 1)]),
    # a fact filter: a mask factor in every lazy consumer
    Query([0, 1, 2], STAR, [FilterPred(0, 2, "<", 700)],
          [Projection(0, 2), Projection(2, 1)]),
    # both dimensions filtered to nothing: NULL through the lazy flag
    Query([0, 1, 2], STAR, [FilterPred(1, 1, "=", 55555)],
          [Projection(0, 2)]),
    # a huge wiped component (boolean tree, clamped lazy lookups)
    Query([0, 1, 2, 2], [JoinPred(0, 0, 1, 0), JoinPred(2, 0, 3, 0)],
          [], [Projection(2, 1)]),
]


def test_lazy_star_multi_edge_matches_jax():
    _lines_agree(_star_rels(33, **STAR_SHAPE), STAR_QUERIES)


def test_sorted_windows_mono_matches_jax():
    """The reference's "mono" sorts its 2-operand passes only (the single
    join's, not the star's); the port's unsorted pass gives its lines."""
    rels = _star_rels(97, **STAR_SHAPE)
    queries = [Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
                     [Projection(0, 2), Projection(1, 1)])] + STAR_QUERIES
    _lines_agree(rels, queries, wsorts=("mono",))


def test_narrow_uint16_planes_fold_exact():
    """Relations past _NARROW_PLANE_MIN_ROWS keep projection planes that
    fit 16 bits as uint16, and every fold zero-extends them: the identity
    catalog, the dictionary catalog's single- and multi-plane branches,
    and an identity column of values >= 2**16 that stays int32."""
    rng = np.random.default_rng(7)
    n = 3 * 4096 + 55
    q = Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(1, 1, "<", 900)],
              [Projection(0, 1), Projection(1, 1)])

    def run(rels, queries):
        eng = _lines_agree(rels, queries)
        return eng.batch_executor.catalog

    def dim(second):
        return Relation([np.arange(400, dtype=U64), second])

    # identity catalog, values < 2**16: one uint16 plane, and a 16-bit
    # plane with its top bit set widens without sign extension
    vals = _col(rng, 1000, n)
    vals[::97] = 0xFFFF
    cat = run([Relation([_col(rng, 400, n), vals]),
               dim(_col(rng, 1000, 400))], [q])
    assert [(p.dtype, s) for p, s in cat.proj_planes(0, 1)] == [
        (torch.uint16, 0)]
    # identity catalog, values >= 2**16: stays int32 (the join column)
    cat = run([Relation([_col(rng, 400, n), _col(rng, 1 << 20, n)]),
               dim(_col(rng, 1000, 400))], [q])
    assert [(p.dtype, s) for p, s in cat.proj_planes(0, 1)] == [
        (torch.int32, 0)]
    # dictionary catalog (a u64 column forces it): a narrow fact column
    # is one uint16 plane, the 400-row u64 column int32 planes
    wide = _col(rng, 1000, n) + U64(1 << 40)
    qf = Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(0, 1, "<", 900)],
               [Projection(0, 1), Projection(1, 1)])
    cat = run([Relation([_col(rng, 400, n), _col(rng, 1000, n)]),
               dim(wide[:400])], [qf])
    assert [p.dtype for p, _s in cat.proj_planes(0, 1)] == [torch.uint16]
    assert all(p.dtype == torch.int32 for p, _s in cat.proj_planes(1, 1))
    # dictionary catalog, a huge u64 projected column: uint16 planes
    cat = run([Relation([_col(rng, 400, n), wide]),
               dim(_col(rng, 1000, 400))], [q])
    pl = cat.proj_planes(0, 1)
    assert len(pl) > 1 and all(p.dtype == torch.uint16 for p, _s in pl)


@pytest.mark.parametrize("cfg", [{"factorized": False},
                                 {"join_backend": "sort"}])
def test_uint16_planes_on_materialized_paths(cfg):
    """The materialized fallback's dense stages and the sort backend's
    per-op path look planes up by row id and read int32 copies of the
    uint16 planes (int32_planes): the identity and the dictionary
    catalog."""
    rng = np.random.default_rng(12)
    n = 2048 + 99
    q = Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(1, 1, "<", 900)],
              [Projection(0, 1), Projection(1, 1)])
    for wide in (False, True):
        fact = Relation([_col(rng, 400, n), _col(rng, 1 << 16, n)])
        second = _col(rng, 1000, 400) + U64((1 << 40) if wide else 0)
        dim = Relation([np.arange(400, dtype=U64), second])
        want = [format_result(OracleExecutor([fact, dim]).execute(q), 2)]
        prels, pq = _to_port([fact, dim], [q])
        eng = Engine(prels, EngineConfig(**cfg), device="cpu")
        assert eng.run_workload([pq]) == want
        cat = eng.batch_executor.catalog
        assert [p.dtype for p, _s in cat.int32_planes(0, 1)] == [torch.int32]
        assert JaxEngine([fact, dim], JaxConfig(**cfg)).run_workload(
            [[q]]) == want


def test_uint16_plane_realiases_to_the_join_column():
    """A projection that uploaded a uint16 plane before a join needed the
    same column: col() re-aliases the plane to the int32 column, as the
    reference's col() does, so the column is not resident twice; and the
    materialized paths read int32 copies (int32_planes)."""
    rng = np.random.default_rng(8)
    n = 2048 + 5
    cat = device_catalog.DeviceCatalog(
        _to_port([Relation([_col(rng, 300, n), _col(rng, 300, n)])])[0],
        device="cpu")
    (plane, _s), = cat.proj_planes(0, 1)
    assert plane.dtype == torch.uint16
    wide = cat.int32_planes(0, 1)
    col = cat.col(0, 1)
    assert [p.dtype for p, _s in wide] == [torch.int32]
    assert cat.proj_planes(0, 1)[0][0] is col
    assert torch.equal(plane.to(torch.int32), col)


def test_window_builds_under_jax_hier_scatter():
    """The JAX engine's hierarchical window builds (ftree_scatter="hier")
    against the port's one window build."""
    rels = _star_rels(5, n=4 * 4096 + 33, k1=300, k2=200)
    _lines_agree(rels, STAR_QUERIES[:2], jax_cfg={"ftree_scatter": "hier"})


def test_huge_chain_two_deep_matches_jax():
    """Two huge nodes of different lengths in a chain (fact1 - fact2 -
    dim): the up-pass build over huge fact2 with a lazy weight, the
    down-pass builds over both, folds on both."""
    rng = np.random.default_rng(123)
    n1, n2 = 3 * 4096 + 11, 4 * 4096 + 55
    f1 = Relation([_col(rng, 200, n1), _col(rng, 1000, n1)])
    f2 = Relation([_col(rng, 200, n2), _col(rng, 150, n2),
                   _col(rng, 1000, n2)])
    dim = Relation([np.arange(150, dtype=U64), _col(rng, 1000, 150)])
    chain = [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0)]
    queries = [
        Query([0, 1, 2], chain, [FilterPred(2, 1, "<", 800)],
              [Projection(0, 1), Projection(1, 2), Projection(2, 1)]),
        Query([0, 1, 2], chain, [FilterPred(1, 2, "<", 600)],
              [Projection(0, 1), Projection(2, 1)]),
        Query([0, 1, 2], chain, [FilterPred(2, 1, "=", 99999)],
              [Projection(0, 1)]),
    ]
    _lines_agree([f1, f2, dim], queries)


def test_unpackable_payloads_match_jax(monkeypatch):
    """A 16-bit key width and a 16-bit plane cannot share one int32 sort
    word: the reference's packer declines and its plain carrying sort
    runs, while the dimension's 10-bit plane still packs. The port's
    unsorted pass gives the same lines."""
    rng = np.random.default_rng(41)
    n = 3 * 4096 + 7
    nk = 60000
    fact = Relation([_col(rng, nk, n), _col(rng, nk, n)])
    dim = Relation([np.arange(nk, dtype=U64), _col(rng, 1000, nk)])
    queries = [Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
                     [Projection(0, 1), Projection(1, 1)])]
    seen = []
    orig = jfac._plan_packing

    def spy(*a):
        seen.append(orig(*a))
        return seen[-1]
    monkeypatch.setattr(jfac, "_plan_packing", spy)
    _lines_agree([fact, dim], queries)
    assert any(r is None for r in seen), seen
    assert any(r is not None for r in seen), seen


# ---- the window machinery, unit by unit ----

def _pass_inputs(kind, seed=3, n=3 * 2048 + 77):
    """One fused pass's operands as numpy arrays: (scatters, folds,
    flag_idx) with each array given once, in the layout both packages'
    _fused_node_pass take (a lazy weight: a list of factors)."""
    rng = np.random.default_rng(seed)
    k1 = np.minimum(rng.zipf(1.3, n), 300).astype(np.int32) - 1
    k2 = rng.integers(0, 200, n).astype(np.int32)
    t1 = rng.integers(0, 40, 512).astype(np.int32)
    mega = rng.integers(0, 40, 768).astype(np.int32)
    mask = rng.random(n) < 0.8
    plane = rng.integers(0, 1000, n).astype(np.int32)
    if kind == "zipf":
        g = [("gather", t1, k1, 0, False, 9)]
        return ([(512, k1, 0, None, None, 512)], [(plane, g, 10)], 0)
    if kind == "star":
        g1 = ("gather", mega, k1, 0, False, 9)
        g2 = ("gather", mega, k2, 512, False, 8)
        wide = rng.integers(0, 1 << 16, n).astype(np.uint16)
        return ([(512, k1, 0, [g2, ("mask", mask)], mask, 512),
                 (256, k2, 0, [g1, ("mask", mask)], mask, 256)],
                [(plane, [g1, g2, ("mask", mask)], 10),
                 (wide, [g1, g2, ("mask", mask)], 16)], 0)
    if kind == "boolean":
        g1 = ("gather", mega, k1, 0, True, 9)
        g2 = ("gather", mega, k2, 512, True, 8)
        return ([(512, k1, 0, [g2], None, 512)],
                [(plane, [g1, g2], 10)], None)
    # "mat": a materialized weight vector times a lookup, and an
    # unbounded plane (31 bits: never packed)
    w = rng.integers(0, 50, n).astype(np.int32)
    big = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    g2 = ("gather", mega, k2, 512, False, 8)
    return ([(256, k2, 0, [("mat", w), g2], mask, 256)],
            [(big, [("mat", w), g2], 31)], 0)


def _build(mod, conv, inputs, bits):
    """One package's operands from _pass_inputs: each numpy array
    converted once (shared arrays stay shared, by identity). bits: keep
    the reference's static bit bounds (its sorted windows read them; the
    port's operands have none)."""
    seen = {}

    def c(a):
        if a is None:
            return None
        if id(a) not in seen:
            seen[id(a)] = conv(a)
        return seen[id(a)]

    def lazy(factors):
        if factors is None:
            return None
        out = []
        for f in factors:
            if f[0] == "gather":
                kw = {"kbits": f[5]} if bits else {}
                out.append(mod._Lazy.gather(c(f[1]), c(f[2]), f[3], f[4],
                                            **kw).factors[0])
            else:
                out.append((f[0], c(f[1])))
        return mod._Lazy(len(c(factors[0][2] if factors[0][0] == "gather"
                                 else factors[0][1])), out)

    scatters, folds, flag_idx = inputs
    sc = [(w, c(k), o, lazy(wt), c(m), s) for (w, k, o, wt, m, s) in scatters]
    fo = [(c(p), lazy(lz), b) if bits else (c(p), lazy(lz))
          for (p, lz, b) in folds]
    return sc, fo, flag_idx


def _jax_side(inputs):
    sc, fo, fi = _build(jfac, jnp.asarray, inputs, True)
    return ([(w, k, np.int32(o), wt, m, np.int32(s))
             for (w, k, o, wt, m, s) in sc], fo, fi)


def _port_side(inputs):
    return _build(tfac, torch.from_numpy, inputs, False)


def _fused_pass_agrees(inputs, wsort="off"):
    """The port's fused pass == the reference's under window policy
    `wsort`: tables element-exact, folds and the NULL flag equal."""
    n = len(inputs[1][0][0])
    a, f, anyp = tfac._fused_node_pass(n, *_port_side(inputs))
    ja, jf, janyp = jfac._fused_node_pass(n, *_jax_side(inputs), None,
                                          wsort=wsort)
    assert len(a) == len(ja) and len(f) == len(jf)
    for x, jx in zip(a, ja):
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert [int(s) & U64_MASK for s in f] == [
        combine_weighted_segments(np.asarray(x)) for x in jf]
    assert (anyp is None) == (janyp is None)
    if anyp is not None:
        assert bool(anyp) == bool(janyp)


@pytest.mark.parametrize("wsort", ["off", "on", "mono"])
@pytest.mark.parametrize("kind", ["zipf", "star", "boolean", "mat"])
def test_fused_node_pass_matches_jax(kind, wsort):
    """The port's one unsorted pass against each of the reference's
    window policies: sorting a window reorders rows only."""
    _fused_pass_agrees(_pass_inputs(kind), wsort)


@pytest.mark.parametrize("window", [1000, 2048, 1 << 20])
def test_fused_node_pass_window_sizes(monkeypatch, window):
    """limbs._BIG_WINDOW_ROWS is the one window size of the port's
    huge-node loops: a window that divides nothing (a short last window),
    the shrunken default and one window for the whole node give the
    reference's result."""
    monkeypatch.setattr(tfac, "_BIG_WAVE_ROWS", 1 << 20)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", window)
    assert tfac._win_rows() == window
    _fused_pass_agrees(_pass_inputs("star"))


def test_scatter_add_big_matches_jax():
    """The standalone windowed build: masked keys to the sentinel, a lazy
    weight evaluated per window, a ragged tail."""
    scatters, folds, _fi = _pass_inputs("star")
    (w, k, _o, wt, m, s) = _port_side((scatters[:1], folds, None))[0][0]
    (_w, jk, _jo, jwt, jm, js) = _jax_side((scatters[:1], folds, None))[0][0]
    got = tfac._scatter_add_big(w, k, 7, wt, m, s)
    want = jfac._scatter_add_big(w, jk, 7, jwt, jm, js)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lazy_any_positive_matches_jax():
    scatters, folds, _fi = _pass_inputs("boolean")
    lz = _port_side(([], folds, None))[1][0][1]
    jlz = _jax_side(([], folds, None))[1][0][1]
    rng = np.random.default_rng(4)
    for p in (0.0, 1e-4, 0.5):
        mask = rng.random(lz.n) < p
        assert bool(tfac._lazy_any_positive(lz, torch.from_numpy(mask))) \
            == bool(jfac._lazy_any_positive(jlz, jnp.asarray(mask)))


@pytest.mark.parametrize("source", ["counts", "weight_fn", "masked_anyp",
                                    "uint16", "empty_anyp"])
def test_weighted_partials_big_matches_jax(source):
    rng = np.random.default_rng(len(source))
    n = 5 * WINDOW_ROWS + 333
    keys = rng.integers(0, 700, n).astype(np.int32)
    table = rng.integers(0, 2**20, 700).astype(np.int32)
    if source == "uint16":
        vals = rng.integers(0, 1 << 16, n).astype(np.uint16)
    else:
        vals = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    counts = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    mask = rng.random(n) < (0.0 if source == "empty_anyp" else 0.7)
    tv, jv = torch.from_numpy(vals), jnp.asarray(vals)
    tk, jk = torch.from_numpy(keys), jnp.asarray(keys)
    tt, jt = torch.from_numpy(table), jnp.asarray(table)

    def tfn(s, z):
        return tables.table_gather(tt, tk[s:s + z])

    def jfn(s, z):
        return jt[jax.lax.dynamic_slice(jk, (s,), (z,))]

    if source == "counts":
        got = limbs.weighted_partials_big(tv, torch.from_numpy(counts))
        want = jax_limbs.weighted_partials_big(jv, jnp.asarray(counts))
    elif source in ("weight_fn", "uint16"):
        got = limbs.weighted_partials_big(tv, weight_fn=tfn)
        want = jax_limbs.weighted_partials_big(jv, weight_fn=jfn)
    else:
        got, anyp = limbs.weighted_partials_big(
            tv, weight_fn=tfn, weight_mask=torch.from_numpy(mask),
            also_any_positive=True)
        want, janyp = jax_limbs.weighted_partials_big(
            jv, weight_fn=jfn, weight_mask=jnp.asarray(mask),
            also_any_positive=True)
        assert bool(anyp) == bool(janyp)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) & U64_MASK == combine_weighted_segments(
        np.asarray(want))


def test_window_loops_cap_below_2_31_rows():
    """The reference's int32-addressing caps and errors, kept."""
    n = (1 << 31) - WINDOW_ROWS
    vals = torch.zeros(1, dtype=torch.int32).expand(n)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        limbs.weighted_partials_big(vals, vals)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tfac._Lazy(n, [])


@pytest.mark.parametrize("impl", ["auto", "onehot", "hier",
                                  "hier_presorted"])
def test_scatter_add_window_onto_nonzero_accumulator(impl):
    """acc[idxs] += weights in place, indices past the end (the masked-row
    sentinel and beyond) dropped: equal to the reference's window build
    under `impl` ("auto" and "onehot" off a TPU, and "hier", fall
    through to or equal acc.at[idxs].add(weights, mode="drop")).
    Negative indices drop too, where the reference's XLA build wraps them
    (a declared divergence, ROADMAP.md; the wave never emits them)."""
    rng = np.random.default_rng(9)
    n_bins, n = 777, 5000
    acc = rng.integers(0, 2**20, n_bins).astype(np.int32)
    idxs = rng.integers(0, n_bins + 3, n).astype(np.int32)
    if impl == "hier_presorted":
        idxs.sort()
    w = rng.integers(0, 1000, n).astype(np.int32)
    tacc = torch.from_numpy(acc.copy())
    got = tables.scatter_add_window(tacc, torch.from_numpy(idxs),
                                    torch.from_numpy(w))
    assert got is tacc
    want = jax_tables.scatter_add_window(jnp.asarray(acc), jnp.asarray(idxs),
                                         jnp.asarray(w), impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    before = got.clone()
    neg = torch.tensor([-1, -2, -777], dtype=torch.int32)
    tables.scatter_add_window(got, neg, torch.ones(3, dtype=torch.int32))
    assert torch.equal(got, before)


@pytest.mark.parametrize("value", ["auto", "on", "off", "mono"])
def test_window_sort_values_run_one_pass(value):
    """The port has one window pass and no window setting: the JAX engine
    under each of its ftree_window_sort values prints the port's lines,
    and the port refuses the field."""
    rels = _star_rels(3, n=2048 + 5, k1=30, k2=20)
    _lines_agree(rels, STAR_QUERIES[:1], wsorts=(value,))
    with pytest.raises(TypeError, match="ftree_window_sort"):
        EngineConfig(ftree_window_sort=value)


@pytest.mark.parametrize("impl", ["mxu", "xla", "sorted", "hier",
                                  "hier_presorted"])
def test_scatter_add_window_unported_impls_raise(impl):
    """The reference's window builds (the name is from when the port
    raised for them): under each name JAX's scatter_add_window adds what
    the port's one window build adds in place ("sorted" falls through to
    the engine in JAX), on a sorted window with masked rows on the
    sentinel."""
    rng = np.random.default_rng(len(impl))
    n_bins, n = 3000, 9000
    acc = rng.integers(0, 2**20, n_bins).astype(np.int32)
    idxs = np.sort(rng.integers(0, n_bins + 2, n)).astype(np.int32)
    w = rng.integers(0, 1000, n).astype(np.int32)
    tacc = torch.from_numpy(acc.copy())
    got = tables.scatter_add_window(tacc, torch.from_numpy(idxs),
                                    torch.from_numpy(w))
    assert got is tacc
    want = jax_tables.scatter_add_window(jnp.asarray(acc), jnp.asarray(idxs),
                                         jnp.asarray(w), impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
