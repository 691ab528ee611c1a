"""The port's conjunctive select on the CPU (ops/filter.py filter_conj,
its plain version): the same rows and count as a NumPy reference and as
the chain of one-predicate filters it replaced, in passes of
SELECT_MAX_PREDS predicates; the batch driver's one select a filtered
slot (`BatchExecutor._init_and_filter`) against the per-filter chain it
replaced; its counters; the kernel wrapper's refusals, which need no
card; and chip_smoke.py's select from library calls, the plain design
it times beside the kernel. The kernel itself is held to the plain
version on the card (tests/test_torch_cuda.py test_select_kernel_exact).
"""

import numpy as np
import pytest
import torch

from radixhashjoin_tpu_torch import kernels
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models.batch import BatchExecutor
from radixhashjoin_tpu_torch.ops.compact import compact, compact_mask_positions
from radixhashjoin_tpu_torch.ops.filter import (OP_CODE, OP_EQ, OP_GT, OP_LT,
                                                filter_conj,
                                                filter_conj_torch,
                                                filter_full, filter_live,
                                                gather_clamped)
from radixhashjoin_tpu_torch.storage import Relation
from radixhashjoin_tpu_torch.utils import profiling
from radixhashjoin_tpu_torch.workload import FilterPred, Projection, Query

INT32_MAX = 2**31 - 1
K = kernels.SELECT_MAX_PREDS


def _numpy_select(rows, count, cols, preds, pad):
    """Survivors of the live lanes in order, then zeros, cut to pad;
    and their number: straight from the definition."""
    n = cols[0].shape[0] if rows is None else rows.shape[0]
    live = min(max(int(count), 0), n)
    rid = np.arange(live) if rows is None else rows[:live].astype(np.int64)
    keep = np.ones(live, bool)
    for c, op, value in preds:
        col = cols[c]
        vals = (col[np.clip(rid, 0, len(col) - 1)] if len(col)
                else np.zeros(live, np.int32))
        keep &= (vals == value if op == OP_EQ else
                 vals < value if op == OP_LT else vals > value)
    got = rid[keep].astype(np.int32)
    out = np.zeros(pad, np.int32)
    out[:min(pad, len(got))] = got[:pad]
    return out, len(got)


def _chain(rows, count, preds, pad):
    """The per-filter chain the batch driver ran before the fold: the
    first filter of a pristine slot scans the column, each later one
    narrows the live rowids, each a mask and a stable compaction."""
    for i, (col, op, value) in enumerate(preds):
        if rows is None:
            n = col.shape[0]
            idx = torch.arange(n, dtype=torch.int32)
            pos, count = compact_mask_positions(
                _cmp(col, op, value) & (idx < count))
            rows = compact(idx, pos)
        else:
            idx = torch.arange(rows.shape[0], dtype=torch.int32)
            m = _cmp(gather_clamped(col, rows), op, value) & (idx < count)
            pos, count = compact_mask_positions(m)
            rows = compact(rows, pos)
    n = rows.shape[0]
    rows = (torch.nn.functional.pad(rows, (0, pad - n)) if pad > n
            else rows[:pad])
    return rows, count


def _cmp(v, op, value):
    return v == value if op == OP_EQ else (v < value if op == OP_LT
                                           else v > value)


def _case(seed, n, k, mode):
    rng = np.random.default_rng(seed)
    n_cols = max(1, min(k, 3))
    cols = [rng.integers(-2, 12, n).astype(np.int32) for _ in range(n_cols)]
    for c in cols:                       # the encode_filter sentinels as data
        c[rng.integers(0, n, 3)] = INT32_MAX
        c[rng.integers(0, n, 3)] = -1
    # each opcode with the encode_filter sentinels -1 and INT32_MAX and 0
    # among its constants, loose enough that rows survive nine of them
    consts = {OP_EQ: [-1, 0, INT32_MAX, 5], OP_LT: [INT32_MAX, 11, 10, 0, -1],
              OP_GT: [-1, -2, 0, 1, INT32_MAX]}
    preds = []
    for i in range(k):
        op = OP_EQ if i == 0 and rng.random() < 0.3 else int(
            rng.choice([OP_LT, OP_GT]))
        tight = rng.random() < 0.15
        value = (int(rng.choice(consts[op])) if tight or op == OP_EQ
                 else consts[op][int(rng.integers(0, 3))])
        preds.append((int(rng.integers(0, n_cols)), op, value))
    rows = None
    if mode == "rows":
        m = int(rng.integers(n // 2, n + 1))
        rows = np.sort(rng.choice(n + 5, m, replace=False) - 2
                       ).astype(np.int32)
        rows = np.concatenate([rows, rng.integers(-9, n + 9, n - m + 7)
                               .astype(np.int32)])
    return cols, preds, rows


@pytest.mark.parametrize("mode", ["identity", "rows"])
@pytest.mark.parametrize("k", [1, 2, K, K + 1, 2 * K + 1])
@pytest.mark.parametrize("n,count,pad", [(1, 1, 1024), (4097, 4097, 8192),
                                         (4097, 3000, 4096),
                                         (4097, 4097, 100), (5000, 0, 8192),
                                         (300, 299, 300)])
def test_filter_conj_matches_numpy_and_the_chain(mode, k, n, count, pad):
    cols, preds, rows = _case(n * 31 + k, n, k, mode)
    tcols = [torch.from_numpy(c) for c in cols]
    tpreds = [(tcols[c], op, v) for c, op, v in preds]
    trows = None if rows is None else torch.from_numpy(rows)
    want, want_n = _numpy_select(rows, count, cols, preds, pad)
    for cnt in (count, torch.tensor(count, dtype=torch.int32)):
        got, got_n = filter_conj(trows, cnt, tpreds, pad)
        assert got.dtype == torch.int32 and got_n.dtype == torch.int32
        assert got_n.shape == ()
        assert np.array_equal(got.numpy(), want)
        assert int(got_n) == want_n
        # the chain the batch driver ran before; a cut at pad < n cuts its
        # first pass too, so it is the reference only where pad >= n
        if pad >= (n if rows is None else rows.shape[0]):
            ch, ch_n = _chain(trows, cnt, tpreds, pad)
            assert torch.equal(got, ch) and int(ch_n) == want_n


@pytest.mark.parametrize("mode", ["identity", "rows"])
@pytest.mark.parametrize("at", [1, 2, K, K + 1])
def test_filter_conj_a_middle_predicate_empties_the_slot(mode, at):
    n = 3000
    cols, preds, rows = _case(7 + at, n, 2 * K, mode)
    preds[at] = (preds[at][0], OP_EQ, -7)     # no value is -7
    tcols = [torch.from_numpy(c) for c in cols]
    trows = None if rows is None else torch.from_numpy(rows)
    got, got_n = filter_conj(trows, n, [(tcols[c], op, v)
                                        for c, op, v in preds], 4096)
    assert int(got_n) == 0 and not got.any() and got.shape == (4096,)


@pytest.mark.parametrize("op", [OP_EQ, OP_LT, OP_GT])
@pytest.mark.parametrize("value", [-1, 0, INT32_MAX])
def test_filter_full_and_live_are_one_predicate_selects(op, value):
    rng = np.random.default_rng(op * 3 + value % 7)
    col = torch.from_numpy(rng.integers(-3, 4, 2000).astype(np.int32))
    col[::97] = INT32_MAX
    got, cnt = filter_full(col, 1500, value, op, 2048)
    want, want_n = filter_conj_torch(None, 1500, [(col, op, value)], 2048)
    assert torch.equal(got, want) and int(cnt) == int(want_n)
    rows, cnt2 = filter_live(got, cnt, col, value, op)
    assert rows.shape == (2048,)
    assert torch.equal(rows, got) and int(cnt2) == int(cnt)
    ref, ref_n = _numpy_select(None, 1500, [col.numpy()], [(0, op, value)],
                               2048)
    assert np.array_equal(got.numpy(), ref) and int(cnt) == ref_n


def test_filter_conj_needs_a_predicate():
    with pytest.raises(ValueError, match="no predicate"):
        filter_conj(None, 3, [], 8)


# ---- the batch driver: one select a filtered slot

def _relations(rng, sizes):
    return [Relation([rng.integers(0, 40, n).astype(np.uint64)
                      for _ in range(3)]) for n in sizes]


def _per_filter(ex, q):
    """What `_init_and_filter` did before the fold: one filter a
    predicate, in the query's order, filter_full first on each slot."""
    cat = ex.catalog
    rows, cnts, flags = {}, {}, []
    for f in q.filters:
        col = cat.col(q.slots[f.slot], f.col)
        opc, const = cat.encode_filter(f.op, f.value)
        if f.slot not in rows:
            n = cat.relations[q.slots[f.slot]].num_tuples
            r, c = _chain(None, n, [(col, opc, const)], cat.bucket(n))
        else:
            r, c = _chain(rows[f.slot], cnts[f.slot], [(col, opc, const)],
                          rows[f.slot].shape[0])
        rows[f.slot], cnts[f.slot] = r, c
        flags.append(bool(c == 0))
    return rows, cnts, any(flags)


QUERIES = {
    "one_slot": [FilterPred(0, 0, ">", 5), FilterPred(0, 1, "<", 30),
                 FilterPred(0, 0, "<", 35)],
    "two_slots": [FilterPred(0, 0, ">", 3), FilterPred(0, 2, "<", 25),
                  FilterPred(1, 1, "=", 7)],
    "interleaved": [FilterPred(1, 0, "<", 30), FilterPred(0, 1, ">", 2),
                    FilterPred(1, 2, ">", 4), FilterPred(0, 0, "<", 38),
                    FilterPred(1, 0, ">", 1), FilterPred(0, 2, "<", 33)],
    "past_k": [FilterPred(0, c % 3, op, v) for c, (op, v) in enumerate(
        [(">", 1), ("<", 39), (">", 2), ("<", 38), (">", 3), ("<", 37)])],
    "empties_one_slot": [FilterPred(0, 0, ">", 3), FilterPred(1, 1, "=", 99),
                         FilterPred(1, 0, "<", 30)],
    "huge_constant": [FilterPred(0, 0, "<", 2**40), FilterPred(1, 1, "=",
                                                               2**40)],
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_init_and_filter_matches_the_per_filter_chain(name):
    rng = np.random.default_rng(len(name))
    rels = _relations(rng, [3000, 1500, 700])
    ex = BatchExecutor(rels, EngineConfig(join_backend="sort"),
                       device=torch.device("cpu"))
    q = Query([0, 1, 2], [], QUERIES[name], [Projection(0, 0)])
    st = ex._init_and_filter(q)
    rows, cnts, null = _per_filter(ex, q)
    for s in range(3):
        n = rels[s].num_tuples
        if s in rows:
            assert torch.equal(st.live_rows[s], rows[s])
            assert int(st.live_cnt[s]) == int(cnts[s])
        else:
            assert torch.equal(st.live_rows[s],
                               torch.arange(ex.catalog.bucket(n),
                                            dtype=torch.int32))
            assert st.live_cnt[s] == n
    assert len(st.flags) == len(rows)              # one flag a filtered slot
    assert any(bool(f) for f in st.flags) == null


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_filter_counters_read_passes_and_predicates(name):
    rng = np.random.default_rng(3)
    ex = BatchExecutor(_relations(rng, [2000, 900, 500]),
                       EngineConfig(join_backend="sort"),
                       device=torch.device("cpu"))
    q = Query([0, 1, 2], [], QUERIES[name], [Projection(0, 0)])
    per_slot = {}
    for f in q.filters:
        per_slot[f.slot] = per_slot.get(f.slot, 0) + 1
    profiling.reset_spans()
    ex._init_and_filter(q)                     # unarmed: counts nothing
    assert "filter.passes" not in profiling.span_totals()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        ex._init_and_filter(q)
    spans = profiling.span_totals()
    profiling.reset_spans()
    assert spans["filter"]["calls"] == len(per_slot)
    assert spans["filter.passes"]["count"] == sum(
        -(-k // K) for k in per_slot.values())
    assert spans["filter.predicates"]["count"] == len(q.filters)


# ---- the kernel wrapper's refusals (no card needed: it refuses first)

def test_select_wrapper_refuses_cpu_operands_and_bad_preds():
    col = torch.zeros(8, dtype=torch.int32)
    before = kernels.SELECT_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        kernels.select_cuda(None, 8, [(col, OP_LT, 3)], 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.select_cuda(None, 8, [(col.long(), OP_LT, 3)], 8)
    with pytest.raises(ValueError, match="predicates"):
        kernels.select_cuda(None, 8, [], 8)
    with pytest.raises(ValueError, match="predicates"):
        kernels.select_cuda(None, 8, [(col, OP_LT, 3)] * (K + 1), 8)
    assert kernels.SELECT_LAUNCHES == before
    assert set(OP_CODE.values()) == {OP_EQ, OP_LT, OP_GT} == {0, 1, 2}


def test_select_bounds_mirror_the_source():
    """kernels.py's SELECT_MAX_PREDS and SELECT_TILE are csrc/select.cu's
    kMaxPreds and kTile; the select library is built on its own."""
    src = open(kernels.SOURCES["select"]).read()
    assert f"kMaxPreds = {kernels.SELECT_MAX_PREDS};" in src
    assert "kTile = kChunk * kVecs;" in src
    assert "kChunk = kThreads * 4;" in src and "kVecs = 4;" in src
    assert "kThreads = 256;" in src and kernels.SELECT_TILE == 256 * 4 * 4
    assert "__global__ void __launch_bounds__(kThreads)\nselect_kernel(" in src
    assert 'extern "C" int rhj_select(' in src


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("mode", ["identity", "rows"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_chip_smoke_select_library_is_the_select(chip_smoke, mode, k):
    """chip_smoke's select from library calls, timed beside the kernel,
    gives filter_conj's rows and count on its own cases (SSB flight 1's
    columns; rowids of the 1-predicate survivors with a device count)."""
    n = 1 << 12
    g = torch.Generator().manual_seed(k)
    disc = torch.randint(0, 11, (n,), generator=g, dtype=torch.int32)
    qty = torch.randint(1, 51, (n,), generator=g, dtype=torch.int32)
    cases = chip_smoke.select_cases(disc, qty)
    rows, cnt = (None, n) if mode == "identity" else filter_conj(
        None, n, cases[1], n)
    got = chip_smoke.select_library(rows, cnt, cases[k], n)
    want = filter_conj_torch(rows, cnt, cases[k], n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0 < int(got[1]) < n


@pytest.mark.parametrize("mode", ["identity", "rows"])
@pytest.mark.parametrize("n,count,pad", [(1000, 700, 1500), (1000, 1000, 300)])
def test_chip_smoke_select_library_pads_and_cuts(chip_smoke, mode, n, count,
                                                 pad):
    cols, preds, rows = _case(n + pad, n, 3, mode)
    tcols = [torch.from_numpy(c) for c in cols]
    tp = [(tcols[c], op, v) for c, op, v in preds]
    trows = None if rows is None else torch.from_numpy(rows)
    got = chip_smoke.select_library(trows, count, tp, pad)
    want = _numpy_select(rows, count, cols, preds, pad)
    assert np.array_equal(got[0].numpy(), want[0])
    assert int(got[1]) == want[1] and got[1].dtype == torch.int32
