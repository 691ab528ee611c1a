"""The materializing path's device ops of the PyTorch port
(radixhashjoin_tpu_torch/ops: compact, filter, join, join_dense,
aggregate) against their JAX counterparts (the ops of JAX's per-query
executor), exactly (integers, tolerance 0: every output array
element-equal).

Inputs come from numpy with a seed and go to both packages. Covered:
ties, empty sides (live count 0), live counts below the padded length,
a left side far longer than the right and the reverse, live values
below 0, a right side whose live values all tie, right values next to
the sentinel, and a join past 2**31 - 1 pairs (65,536 x 32,768 equal
keys), whose total both packages report as -1. The sort backend's probe
of gathered sides (probe_gather_count, whose plain version the CPU runs)
is held to JAX's probe_count over the same gathers, for case 1's and
case 2's left rowids.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixhashjoin_tpu.ops import aggregate as jagg
from radixhashjoin_tpu.ops import filter as jfilter
from radixhashjoin_tpu.ops import join as jjoin
from radixhashjoin_tpu.ops import join_dense as jdense
from radixhashjoin_tpu_torch.ops import aggregate as tagg
from radixhashjoin_tpu_torch.ops import compact as tcompact
from radixhashjoin_tpu_torch.ops import filter as tfilter
from radixhashjoin_tpu_torch.ops import join as tjoin
from radixhashjoin_tpu_torch.ops import join_dense as tdense
from radixhashjoin_tpu_torch.utils.padding import bucket_size

# the JAX ops package re-exports a function named `compact` over the module
jcompact = importlib.import_module("radixhashjoin_tpu.ops.compact")

torch.set_num_threads(1)

INT32_MAX = 2**31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    """A port result (tensor or tuple of them) equals the JAX one."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w)


# ---- compaction and filters ----

@pytest.mark.parametrize("n,p", [(1024, 0.5), (1024, 0.0), (1024, 1.0),
                                 (3000, 0.1), (1, 1.0)])
def test_compact_matches_jax(n, p):
    rng = np.random.default_rng(n + int(p * 10))
    mask = rng.random(n) < p
    arr = rng.integers(-5, 1 << 20, n).astype(np.int32)
    pos, cnt = tcompact.compact_mask_positions(_t(mask))
    jpos, jcnt = jcompact.compact_mask_positions(jnp.asarray(mask))
    _same(pos, jpos)
    assert int(cnt) == int(jcnt) == int(mask.sum())
    _same(tcompact.compact(_t(arr), pos), jcompact.compact(jnp.asarray(arr),
                                                           jpos))


def test_compact_drops_out_of_range_positions():
    arr = np.arange(8, dtype=np.int32) + 10
    pos = np.array([3, 8, -1, 0, 100, 1, 8, 2], np.int32)
    got = tcompact.compact(_t(arr), _t(pos))
    assert got.tolist() == [13, 15, 17, 10, 0, 0, 0, 0]


def _filter_case(seed, n=2048, vmax=64):
    rng = np.random.default_rng(seed)
    col = rng.integers(0, vmax, n).astype(np.int32)
    rows = rng.permutation(n).astype(np.int32)
    return rng, col, rows


@pytest.mark.parametrize("op", [0, 1, 2])
@pytest.mark.parametrize("count", [0, 1, 1500, 2048])
def test_filter_live_matches_jax(op, count):
    rng, col, rows = _filter_case(op * 7 + count)
    value = int(rng.integers(0, 64))
    got = tfilter.filter_live(_t(rows), count, _t(col), value, op)
    want = jfilter.filter_live(jnp.asarray(rows), jnp.int32(count),
                               jnp.asarray(col), value, op)
    _same(got[0], want[0])
    assert int(got[1]) == int(want[1])


@pytest.mark.parametrize("op", [0, 1, 2])
@pytest.mark.parametrize("count,pad", [(2048, 4096), (1000, 1024),
                                       (2048, 2048), (0, 1024)])
def test_filter_full_matches_jax(op, count, pad):
    rng, col, _ = _filter_case(op + count + pad)
    value = int(rng.integers(0, 64))
    got = tfilter.filter_full(_t(col), count, value, op, pad)
    want = jfilter.filter_full(jnp.asarray(col), jnp.int32(count), value,
                               op, pad)
    _same(got[0], want[0])
    assert int(got[1]) == int(want[1])


def test_gather_clamped_pads_like_jit():
    col = _t(np.array([7, 8, 9], np.int32))
    idx = _t(np.array([0, 2, 3, 1000, -4], np.int32))
    assert tfilter.gather_clamped(col, idx).tolist() == [7, 9, 9, 9, 7]
    assert tfilter.gather_clamped(col[:0], idx).tolist() == [0] * 5


# ---- sort join ----

def _join_case(seed, L, R, lcount, rcount, vmax, vmin=0, rvmax=None):
    """Padded sides; lanes past the live counts hold garbage that the
    probes must ignore. Live values lie in [vmin, vmax), the right's in
    [vmin, rvmax) when given; a live right value is never -1, the left
    padding, so that dead left lanes match nothing."""
    rng = np.random.default_rng(seed)
    lv = rng.integers(vmin, vmax, L).astype(np.int32)
    rv = rng.integers(vmin, vmax if rvmax is None else rvmax,
                      R).astype(np.int32)
    rv[rv == -1] = -2
    lv[lcount:] = rng.integers(-3, INT32_MAX, L - lcount)
    rv[rcount:] = rng.integers(-3, INT32_MAX, R - rcount)
    return lv, rv


JOIN_CASES = [
    # (L, R, lcount, rcount, vmax[, vmin, right's vmax])
    (1024, 1024, 1024, 1024, 16),       # heavy ties
    (1024, 2048, 700, 1500, 64),        # counts below the padded length
    (2048, 1024, 2048, 1, 4),           # one live right
    (1024, 1024, 0, 1024, 8),           # empty left side
    (1024, 1024, 1024, 0, 8),           # empty right side
    (4096, 4096, 4000, 3000, 1 << 20),  # mostly unique
    (65536, 64, 40000, 64, 16),         # L >> R, heavy ties in the right
    (1024, 65536, 1000, 60000, 1 << 12),  # R >> L
    (2048, 1024, 1800, 900, 8, -8),     # live values below 0 on both sides
    (2048, 1024, 2000, 1000, 4, 0, 1),  # every live right value ties
]


@pytest.mark.parametrize("case", JOIN_CASES)
def test_probe_and_expand_match_jax(case):
    L, R, lc, rc = case[:4]
    lv, rv = _join_case(sum(case), *case)
    got = tjoin.probe_count(_t(lv), lc, _t(rv), rc)
    want = jjoin.probe_count(jnp.asarray(lv), jnp.int32(lc),
                             jnp.asarray(rv), jnp.int32(rc))
    _same(got, want)
    total = int(got[4])
    live_r = rv[:rc]
    assert total == int(sum((live_r == v).sum() for v in lv[:lc]))
    if total == 0:
        return
    out = bucket_size(total)
    li, ri = tjoin.expand_pairs(*got[:4], out)
    _same((li, ri), jjoin.expand_pairs(*want[:4], out))
    # the live pairs are exactly the equal-value pairs, grouped by left
    pairs = sorted(zip(li[:total].tolist(), ri[:total].tolist()))
    expect = sorted((i, j) for i in range(lc) for j in np.flatnonzero(
        live_r == lv[i]))
    assert pairs == expect


def test_probe_sentinel_neighbours():
    """Right values at INT32_MAX - 1 (the largest the catalog stores)
    match; padding on both sides never does."""
    lv = np.full(1024, INT32_MAX - 1, np.int32)
    rv = np.full(1024, INT32_MAX - 1, np.int32)
    lv[5:] = -1
    rv[3:] = INT32_MAX
    got = tjoin.probe_count(_t(lv), 5, _t(rv), 3)
    _same(got, jjoin.probe_count(jnp.asarray(lv), jnp.int32(5),
                                 jnp.asarray(rv), jnp.int32(3)))
    assert int(got[4]) == 15


# (kind, column lengths, padded L and R, live counts, value bound): the
# left rowids of case 1 (a filtered slot's ascending live rows) and of
# case 2 (a matrix row in an expansion's order: runs of repeated rowids,
# ascending, or a dimension's rowids in the order its matches came)
GATHER_CASES = [
    ("rows", 3000, 500, 2048, 1024, 1500, 700, 64),
    ("rows", 3000, 500, 2048, 1024, 0, 700, 64),
    ("rows", 3000, 500, 2048, 1024, 2048, 0, 64),
    ("rows", 5000, 5000, 4096, 4096, 4001, 4096, 1 << 20),
    ("expanded", 700, 300, 4096, 512, 3000, 300, 16),
    ("expanded", 700, 300, 4096, 512, 4096, 1, 4),
    ("permuted", 700, 900, 2048, 1024, 2000, 900, 32),
]


def _gather_case(seed, kind, n_l, n_r, L, R, lc, rc, vmax):
    """Columns and padded rowids whose lanes past the live counts hold
    garbage (negative and past the columns' ends)."""
    rng = np.random.default_rng(seed)
    col_l = rng.integers(0, vmax, n_l).astype(np.int32)
    col_r = rng.integers(0, vmax, n_r).astype(np.int32)
    if kind == "rows":
        live = np.sort(rng.choice(n_l, lc, replace=lc > n_l))
    elif kind == "expanded":
        base = np.sort(rng.choice(n_l, max(lc // 4, 1)))
        live = np.repeat(base, rng.integers(1, 8, base.size))[:lc]
        live = np.concatenate([live, np.full(lc - live.size, n_l - 1)])
    else:
        live = rng.integers(0, n_l, lc)
    lrows = np.concatenate([live, rng.integers(-9, n_l + 9, L - lc)])
    rrows = np.concatenate([rng.permutation(n_r)[:rc] if rc <= n_r
                            else rng.integers(0, n_r, rc),
                            rng.integers(-9, n_r + 9, R - rc)])
    return col_l, lrows.astype(np.int32), col_r, rrows.astype(np.int32)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("case", GATHER_CASES)
def test_probe_gather_count_matches_jax(case, as_tensor):
    """The sort backend's probe of gathered sides (probe_gather_count's
    plain version, what the CPU runs) equals the JAX package's
    probe_count over the same gathers, for a live count given as an int
    and as a 0-d tensor."""
    kind, n_l, n_r, L, R, lc, rc, vmax = case
    col_l, lrows, col_r, rrows = _gather_case(sum(case[1:]), *case)
    cnt_l = torch.tensor(lc, dtype=torch.int32) if as_tensor else lc
    got = tjoin.probe_gather_count(_t(col_l), _t(lrows), cnt_l, _t(col_r),
                                   _t(rrows), rc)
    jl, jr = jnp.asarray(col_l), jnp.asarray(col_r)
    want = jjoin.probe_count(jl[jnp.asarray(lrows)], jnp.int32(lc),
                             jr[jnp.asarray(rrows)], jnp.int32(rc))
    _same(got, want)
    live_r = col_r[rrows[:rc]]
    assert int(got[4]) == int(sum((live_r == v).sum()
                                  for v in col_l[lrows[:lc]]))


def test_probe_gather_count_sentinel_neighbours():
    """Column values at INT32_MAX - 1 (the largest the catalog stores)
    match through the gathers; padding on both sides never does."""
    col_l = np.full(16, INT32_MAX - 1, np.int32)
    col_r = np.full(8, INT32_MAX - 1, np.int32)
    col_r[5:] = 3
    lrows = np.array([0, 3, 15, 2, 7] + [-1, 16, 99] * 341, np.int32)[:1024]
    rrows = np.array([4, 0, 1] + [5, 6, 7, -2, 8] * 205, np.int32)[:1024]
    got = tjoin.probe_gather_count(_t(col_l), _t(lrows), 5, _t(col_r),
                                   _t(rrows), 3)
    jl, jr = jnp.asarray(col_l), jnp.asarray(col_r)
    _same(got, jjoin.probe_count(jl[jnp.asarray(lrows)], jnp.int32(5),
                                 jr[jnp.asarray(rrows)], jnp.int32(3)))
    assert int(got[4]) == 15


@pytest.mark.parametrize("count,vmax", [(1024, 8), (300, 1 << 16), (0, 8),
                                        (2048, 1 << 16)])
def test_any_common_matches_jax(count, vmax):
    rng = np.random.default_rng(count + vmax)
    a = rng.integers(0, vmax, 2048).astype(np.int32)
    b = rng.integers(0, vmax, 2048).astype(np.int32)
    if vmax > 8:
        b[:count] += vmax              # disjoint live prefixes ...
        b[count:] = a[:2048 - count]   # ... and equal garbage past them
    got = bool(tjoin.any_common(_t(a), _t(b), count))
    assert got == bool(jjoin.any_common(jnp.asarray(a), jnp.asarray(b),
                                        jnp.int32(count)))
    assert got == bool(len(np.intersect1d(a[:count], b[:count])))


# ---- dense join ----

@pytest.mark.parametrize("case", JOIN_CASES[:5])
def test_dense_probe_and_expand_match_jax(case):
    L, R, lc, rc, vmax = case
    domain = 1024
    lv, rv = _join_case(sum(case) + 1, *case)
    rv[rc:] = np.random.default_rng(0).integers(0, domain, R - rc)
    got = tdense.dense_probe(_t(lv), lc, _t(rv), rc, domain)
    want = jdense.dense_probe(jnp.asarray(lv), jnp.int32(lc),
                              jnp.asarray(rv), jnp.int32(rc), domain)
    _same(got, want)
    # the dense probe and the sort probe agree on every output
    _same(got, tjoin.probe_count(_t(lv), lc, _t(rv), rc))
    total = int(got[4])
    if total:
        out = bucket_size(total)
        _same(tdense.dense_expand(*got[:4], out),
              jdense.dense_expand(*want[:4], out))


@pytest.mark.parametrize("count", [0, 1, 1500, 2048])
def test_dense_any_common_matches_jax(count):
    rng = np.random.default_rng(count)
    a = rng.integers(0, 512, 2048).astype(np.int32)
    b = rng.integers(0, 512, 2048).astype(np.int32)
    b[:count] = np.where(np.isin(b[:count], a[:count][:3]), 511, b[:count])
    got = bool(tdense.dense_any_common(_t(a), _t(b), count, 1024))
    assert got == bool(jdense.dense_any_common(
        jnp.asarray(a), jnp.asarray(b), jnp.int32(count), 1024))
    assert got == bool(len(np.intersect1d(a[:count], b[:count])))


# ---- the 2**31 - 1 pair cap ----

N_BIG, N_HALF = 1 << 16, 1 << 15     # 65,536 x 32,768 = 2**31 pairs


@pytest.mark.parametrize("probe", ["sort", "dense"])
def test_pair_overflow_reports_minus_one(probe):
    lv = np.full(N_BIG, 5, np.int32)
    rv = np.full(N_HALF, 5, np.int32)
    if probe == "sort":
        got = tjoin.probe_count(_t(lv), N_BIG, _t(rv), N_HALF)
        want = jjoin.probe_count(jnp.asarray(lv), jnp.int32(N_BIG),
                                 jnp.asarray(rv), jnp.int32(N_HALF))
    else:
        got = tdense.dense_probe(_t(lv), N_BIG, _t(rv), N_HALF, 1024)
        want = jdense.dense_probe(jnp.asarray(lv), jnp.int32(N_BIG),
                                  jnp.asarray(rv), jnp.int32(N_HALF), 1024)
    assert int(got[4]) == int(want[4]) == -1
    # the int32 prefix sums wrap alike in both packages
    _same(got, want)
    # one pair fewer fits: 2**31 - 1 is the largest total
    got = tjoin.probe_count(_t(lv), N_BIG, _t(rv), N_HALF - 1)
    assert int(got[4]) == N_BIG * (N_HALF - 1)


# ---- SUM projection ----

@pytest.mark.parametrize("count,vmax", [(0, 10), (1000, 1 << 16),
                                        (2048, 2**31 - 2)])
def test_sum_column_over_rows_matches_jax(count, vmax):
    rng = np.random.default_rng(count)
    col = rng.integers(0, vmax, 5000).astype(np.int32)
    rows = rng.integers(0, 5000, 2048).astype(np.int32)
    # the port's projection partial: the rows as one intermediate-matrix
    # row, an int64 sum on the device (exact: count x vmax < 2**63)
    got = int(tagg.gather_partials_matrix(_t(col), _t(rows)[None], 0,
                                          count)[0])
    want = jagg.sum_column_over_rows(jnp.asarray(col), jnp.asarray(rows),
                                     jnp.int32(count))
    assert got == want == int(col[rows[:count]].astype(np.uint64).sum())
