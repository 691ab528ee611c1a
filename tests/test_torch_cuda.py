"""Card-only tests of the port: the hand-written CUDA kernels against
their plain PyTorch versions, the partition and radix sort against
torch.sort(stable=True), the sort join's probe kernel (csrc/probe.cu)
against its plain version on the card and the CPU and through Engine on
SSB queries, the engine on a CUDA device against the port's
oracle, the sort backend one query a call and the wave-batched
materialized fallback (terminal joins, the dense pair-set test,
deferred attaches, every query shape through the batch path) on CUDA
against their CPU runs, the engine settings (stage_group, ftree_wave=False,
defer_middle=False) against one round, the profiler's shares,
bench_scale's two-deep huge chain at shrunken thresholds against its
closed form, and bench_scale's CLI with every config's exactness run on
the kernels. Marked `cuda`; they skip without a card. They import
nothing of jax or of the JAX package, so they also run where jax is
absent:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from radixhashjoin_tpu_torch import kernels
from radixhashjoin_tpu_torch.bench_tables import (CACHE_SLOTS, SMEM_BINS,
                                                  zipf_keys)
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models.engine import Engine
from radixhashjoin_tpu_torch.oracle import OracleExecutor, format_result
from radixhashjoin_tpu_torch.ops.partition import (partition_order,
                                                   radix_sort_order,
                                                   rank_and_hist_torch)
from radixhashjoin_tpu_torch.ops.radix_hist import (radix_histogram,
                                                    radix_histogram_torch)
from radixhashjoin_tpu_torch.ops.tables import (table_gather_torch,
                                                weighted_bincount_torch)
from radixhashjoin_tpu_torch.storage import Relation
from radixhashjoin_tpu_torch.workload import (FilterPred, JoinPred,
                                              Projection, Query)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,n_bins", [
    (1, 8), (5000, 700), (1 << 20, 1024), (1 << 20, 48 * 1024),
    (1 << 20, 48 * 1024 + 1), (1 << 22, 1 << 20)])
def test_bincount_kernel_exact(dev, n, n_bins):
    g = torch.Generator(device=dev).manual_seed(n + n_bins)
    idx = torch.randint(-2, n_bins + 2, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.randint(0, 1000, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    before = kernels.LAUNCHES["bincount"]
    got = kernels.weighted_bincount_cuda(idx, w, n_bins)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bincount"] == before + 1
    assert torch.equal(got, weighted_bincount_torch(idx, w, n_bins))


@pytest.mark.parametrize("n,n_bins", [(1, 8), (4097, 1000),
                                      (1 << 22, 1 << 20)])
def test_gather_kernel_exact(dev, n, n_bins):
    g = torch.Generator(device=dev).manual_seed(n)
    table = torch.randint(-2**31, 2**31 - 1, (n_bins,), generator=g,
                          device=dev, dtype=torch.int32)
    keys = torch.randint(-5, n_bins + 5, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    got = kernels.table_gather_cuda(table, keys)
    torch.cuda.synchronize()
    assert torch.equal(got, table_gather_torch(table, keys))


def _gather2_exact(ta, tb, keys):
    before = kernels.LAUNCHES["gather2"]
    ga, gb = kernels.table_gather2_cuda(torch.stack((ta, tb), 1), keys)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gather2"] == before + 1
    assert torch.equal(ga, table_gather_torch(ta, keys))
    assert torch.equal(gb, table_gather_torch(tb, keys))
    assert ga.data_ptr() % 16 == gb.data_ptr() % 16 == keys.data_ptr() % 16
    return ga, gb


@pytest.mark.parametrize("n_bins", [1, 77, SMEM_BINS + 1, 1 << 20])
def test_gather2_kernel_exact(dev, n_bins):
    """The fused double lookup against two plain lookups: tiny and
    ragged key counts, keys out of range, views at offsets 1-3."""
    g = torch.Generator(device=dev).manual_seed(n_bins)
    ta, tb = (torch.randint(-2**31, 2**31 - 1, (n_bins,), generator=g,
                            device=dev, dtype=torch.int32) for _ in "ab")
    for n in (1, 3, 5, 4097, (1 << 22) + 3):
        base = torch.randint(-5, n_bins + 5, (n + 4,), generator=g,
                             device=dev, dtype=torch.int32)
        for offset in (0, 1, 2, 3):
            _gather2_exact(ta, tb, base[offset:offset + n])
    # the pairs table is one contiguous int32[n, 2]
    for bad in (ta, torch.stack((ta, tb), 0), torch.stack((ta, tb), 1).t()):
        with pytest.raises(ValueError, match=r"int32\[n, 2\]"):
            kernels.table_gather2_cuda(bad, base)


@pytest.mark.parametrize("entry", [
    "scatter_table", "scatter_add_window", "scatter_add_window_sorted",
    "table_gather", "table_gather_sorted", "table_gather2"])
def test_table_variants_on_cuda_match_plain(dev, entry):
    """ops/tables.py's one dispatch on CUDA tensors (the hand kernels:
    the device decides, no table name) against the plain versions on the
    same inputs, unsorted and sorted, out-of-range keys included (the
    test's name is from when JAX's table variants ran here)."""
    from radixhashjoin_tpu_torch.ops import tables
    g = torch.Generator(device=dev).manual_seed(len(entry))
    n, bins = (1 << 16) + 5, 3000
    idx = torch.randint(-3, bins + 3, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.randint(0, 1000, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    if entry.endswith("_sorted"):
        idx = torch.sort(idx).values
    table = torch.randint(-2**31, 2**31 - 1, (bins,), generator=g,
                          device=dev, dtype=torch.int32)
    if entry == "scatter_table":
        assert torch.equal(tables.scatter_table(idx, w, bins),
                           weighted_bincount_torch(idx, w, bins))
    elif entry.startswith("scatter_add_window"):
        acc = torch.randint(0, 1 << 20, (bins,), generator=g, device=dev,
                            dtype=torch.int32)
        want = acc + weighted_bincount_torch(idx, w, bins)
        got = tables.scatter_add_window(acc, idx, w)
        assert got is acc and torch.equal(got, want)
    elif entry.startswith("table_gather") and entry != "table_gather2":
        assert torch.equal(tables.table_gather(table, idx),
                           table_gather_torch(table, idx))
    else:
        tb = torch.randint(-2**31, 2**31 - 1, (bins,), generator=g,
                           device=dev, dtype=torch.int32)
        got = tables.table_gather2(table, tb, idx)
        want = (table_gather_torch(table, idx), table_gather_torch(tb, idx))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---- adversarial shapes of the build and lookup (csrc/tables.cu) ----

def _bincount_exact(idx, w, n_bins):
    got = kernels.weighted_bincount_cuda(idx, w, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(got, weighted_bincount_torch(idx, w, n_bins))
    return got


def _gather_exact(table, keys):
    got = kernels.table_gather_cuda(table, keys)
    torch.cuda.synchronize()
    assert torch.equal(got, table_gather_torch(table, keys))
    return got


@pytest.mark.parametrize("n_bins", [1024, SMEM_BINS, 1 << 20])
def test_bincount_one_bin_total_just_below_2_31(dev, n_bins):
    """Every row on one bin (one hot address, every warp one group), the
    total 2^31 - 1: any lost or doubled partial shows."""
    n = 1 << 20
    w = torch.full((n,), (2**31 - 1) // n, dtype=torch.int32, device=dev)
    w[-1] += (2**31 - 1) - ((2**31 - 1) // n) * n
    idx = torch.full((n,), n_bins - 1, dtype=torch.int32, device=dev)
    got = _bincount_exact(idx, w, n_bins)
    assert int(got[n_bins - 1]) == 2**31 - 1


@pytest.mark.parametrize("n_bins", [SMEM_BINS, 1 << 20])
def test_bincount_clipped_zipf(dev, n_bins):
    """2^22 clipped-Zipf(1.1) rows (a quarter on the last bin), ~10% on the
    mask sentinel, a few -1s."""
    g = torch.Generator(device=dev).manual_seed(n_bins)
    n = 1 << 22
    idx = zipf_keys(g, n, n_bins, dev)
    idx = torch.where(torch.rand(n, generator=g, device=dev) < 0.1, n_bins,
                      idx)
    idx[:: 1 << 18] = -1
    w = torch.randint(0, 100, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    _bincount_exact(idx, w, n_bins)


@pytest.mark.parametrize("distinct,log_n,repeat", [
    (3 * CACHE_SLOTS, 24, 2), (1 << 20, 22, 1)])
def test_bincount_more_bins_than_cache_slots(dev, distinct, log_n, repeat):
    """More distinct bins than a block's aggregation cache holds
    (CACHE_SLOTS): 3 * CACHE_SLOTS bins in runs of two equal keys over 2^24
    rows, so that each block (at most two per SM, ~2^16 rows each) meets
    about twice as many bins as it has slots while its keys still repeat:
    cached partials and device atomics land on the same bins. And 2^20
    bins over 2^22 rows, which seldom repeat within a block."""
    g = torch.Generator(device=dev).manual_seed(3)
    n = 1 << log_n
    idx = torch.randint(0, distinct, (n // repeat,), generator=g, device=dev,
                        dtype=torch.int32).repeat_interleave(repeat)
    w = torch.randint(1, 1000, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    _bincount_exact(idx, w, 1 << 20)


def _warp_patterns(n_bins, reps):
    """Chunks of 32 lanes: all equal; all distinct; equal bins mixed with
    zero weights, the sentinel n_bins and -1; then a ragged 17-lane tail."""
    lanes = np.arange(32)
    equal = np.full(32, 3)
    distinct = (lanes * 37) % n_bins
    mixed = np.where(lanes % 4 == 0, n_bins, np.where(lanes % 4 == 1, -1,
                                                      lanes % 3))
    idx = np.concatenate([np.tile(np.concatenate([equal, distinct, mixed]),
                                  reps), (lanes[:17] * 5) % n_bins])
    w = np.arange(1, idx.size + 1, dtype=np.int64) % 1000
    w[np.arange(idx.size) % 32 == 7] = 0        # zero-weight lanes
    return idx.astype(np.int32), w.astype(np.int32)


@pytest.mark.parametrize("n_bins", [64, SMEM_BINS + 1, 1 << 20])
@pytest.mark.parametrize("reps", [1, 50000])
def test_bincount_warp_patterns(dev, n_bins, reps):
    idx, w = _warp_patterns(n_bins, reps)
    _bincount_exact(torch.from_numpy(idx).to(dev),
                    torch.from_numpy(w).to(dev), n_bins)


@pytest.mark.parametrize("n", range(1, 10))
def test_kernels_tiny_n(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    for n_bins in (700, 1 << 20):
        idx = torch.randint(-2, n_bins + 2, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        idx[0] = n_bins - 1
        w = torch.randint(0, 1 << 20, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        _bincount_exact(idx, w, n_bins)
        table = torch.randint(-2**31, 2**31 - 1, (n_bins,), generator=g,
                              device=dev, dtype=torch.int32)
        _gather_exact(table, idx)


@pytest.mark.parametrize("n_bins", [SMEM_BINS - 1, SMEM_BINS,
                                    SMEM_BINS + 1])
def test_kernels_at_shared_memory_threshold(dev, n_bins):
    """Both kernels just inside and just past the shared-memory tables;
    the lookup with enough keys to stage the table and with too few."""
    g = torch.Generator(device=dev).manual_seed(n_bins)
    n = 1 << 22
    idx = torch.randint(-3, n_bins + 3, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.randint(0, 500, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    _bincount_exact(idx, w, n_bins)
    table = torch.randint(-2**31, 2**31 - 1, (n_bins,), generator=g,
                          device=dev, dtype=torch.int32)
    _gather_exact(table, idx)
    _gather_exact(table, idx[:1001])


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("rem", [1, 2, 3])
@pytest.mark.parametrize("n_bins", [1024, 1 << 20])
def test_kernels_on_unaligned_views(dev, offset, rem, n_bins):
    """Contiguous views at element offsets 1-3 of a larger tensor, n % 4
    = rem: the lookup's scalar head and tail around its 16-byte body."""
    g = torch.Generator(device=dev).manual_seed(offset * 10 + rem)
    for n in (rem, 4 * 1000 + rem, (1 << 20) + rem):
        base = torch.randint(-3, n_bins + 3, (n + 8,), generator=g,
                             device=dev, dtype=torch.int32)
        keys = base[offset:offset + n]
        assert keys.is_contiguous() and keys.data_ptr() % 16 != 0
        table = torch.randint(-2**31, 2**31 - 1, (n_bins,), generator=g,
                              device=dev, dtype=torch.int32)
        got = _gather_exact(table, keys)
        assert got.data_ptr() % 16 == keys.data_ptr() % 16
        w = torch.randint(0, 100, (n + 8,), generator=g, device=dev,
                          dtype=torch.int32)[8 - offset:8 - offset + n]
        _bincount_exact(keys, w, n_bins)


def test_wrappers_reject_bad_operands(dev):
    x = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.weighted_bincount_cuda(x.long(), x, 8)
    with pytest.raises(ValueError):
        kernels.table_gather_cuda(x, x[::2])
    assert kernels.weighted_bincount_cuda(x[:0], x[:0], 8).shape == (8,)


def _tree_workload(rng, n_rel=4, n_queries=8):
    """Random relations and tree-shaped queries (each join attaches a
    fresh slot), the shape of tests/test_factorized.py's generators."""
    rels = []
    for _ in range(n_rel):
        n = int(rng.integers(2, 300))
        rels.append(Relation([rng.integers(0, 64, n).astype(np.uint64)
                              for _ in range(3)]))
    queries = []
    for _ in range(n_queries):
        nslots = int(rng.integers(2, 5))
        slots = [int(rng.integers(0, n_rel)) for _ in range(nslots)]
        joins = [JoinPred(int(rng.integers(0, s)), int(rng.integers(0, 3)),
                          s, int(rng.integers(0, 3)))
                 for s in range(1, nslots)]
        filters = [FilterPred(int(rng.integers(0, nslots)),
                              int(rng.integers(0, 3)),
                              str(rng.choice(["=", "<", ">"])),
                              int(rng.integers(0, 70)))
                   for _ in range(int(rng.integers(0, 3)))]
        projs = [Projection(int(rng.integers(0, nslots)), 0)
                 for _ in range(int(rng.integers(1, 4)))]
        queries.append(Query(slots, joins, filters, projs))
    return rels, queries


@pytest.mark.parametrize("seed", range(3))
def test_engine_on_cuda_matches_oracle(dev, seed):
    rels, queries = _tree_workload(np.random.default_rng(200 + seed))
    before = dict(kernels.LAUNCHES)
    got = Engine(rels, EngineConfig(), device=dev).run_batch(queries)
    oracle = OracleExecutor(rels)
    assert got == [format_result(oracle.execute(q), len(q.projections))
                   for q in queries]
    # the wave's build and lookup (the radix kernels are not on it)
    assert all(kernels.LAUNCHES[k] > before[k] for k in ("bincount",
                                                         "gather"))


SIZES = [0, 1, 2047, 2048, 2049, 3_000_017]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("n_bins", [128, 256])
def test_radix_histogram_kernel_exact(dev, n, n_bins):
    g = torch.Generator(device=dev).manual_seed(n + n_bins)
    vals = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    for count in (n, n // 3, n + 5, -1):
        before = kernels.LAUNCHES["radix_hist"]
        got = radix_histogram(vals, count, n_bins)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["radix_hist"] == before + (n > 0)
        assert torch.equal(got, radix_histogram_torch(vals, count, n_bins))
        # a device count: read on the card
        dcount = torch.tensor(count, dtype=torch.int32, device=dev)
        assert torch.equal(radix_histogram(vals, dcount, n_bins), got)
    assert int(radix_histogram(vals, n, n_bins).sum()) == n


def test_radix_histogram_kernel_wide_and_refused(dev):
    vals = torch.arange(1 << 20, dtype=torch.int32, device=dev)
    bins = kernels.RADIX_HIST_MAX_BINS           # dynamic shared memory
    got = kernels.radix_histogram_cuda(vals, 1 << 20, bins)
    assert torch.equal(got, radix_histogram_torch(vals, 1 << 20, bins))
    with pytest.raises(ValueError):
        kernels.radix_histogram_cuda(vals, 5, 2 * bins)
    with pytest.raises(ValueError):
        radix_histogram(vals, 5, 257)


def _rank_digits(dist, n, n_bins, g, dev):
    """int32[n] digits of one distribution: `misfits` (uniform over
    [0, n_bins], n_bins being the dead-lane bin that is ranked but not
    counted, plus out-of-range digits, which get rank 0 and count
    nowhere), `uniform`, `hot` (one digit), `runs` (sorted, so runs
    longer than a warp's chunk) or `dead` (every digit n_bins)."""
    if dist == "hot":
        return torch.full((n,), n_bins // 2, dtype=torch.int32, device=dev)
    if dist == "dead":
        return torch.full((n,), n_bins, dtype=torch.int32, device=dev)
    digits = torch.randint(0, n_bins + 1, (n,), generator=g, device=dev,
                           dtype=torch.int32)
    if dist == "runs":
        return torch.sort(digits).values
    if dist == "misfits" and n > 10:
        digits[:: 997] = -3
        digits[5:: 1999] = n_bins + 4
    return digits


def _rank_exact(digits, n_bins):
    n = digits.shape[0]
    before = kernels.LAUNCHES["rank_hist"]
    ranks, hists = kernels.rank_hist_cuda(digits, n_bins)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rank_hist"] == before + (n > 0)
    want_r, want_h = rank_and_hist_torch(digits, n_bins)
    assert hists.shape == (-(-n // 2048), n_bins)
    assert torch.equal(ranks, want_r)
    assert torch.equal(hists, want_h)


@pytest.mark.parametrize("dist", ["misfits", "uniform", "hot", "runs",
                                  "dead"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("n_bins", [128, 256, 257, 513])
def test_rank_hist_kernel_exact(dev, n, n_bins, dist):
    g = torch.Generator(device=dev).manual_seed(n * 7 + n_bins)
    _rank_exact(_rank_digits(dist, n, n_bins, g, dev), n_bins)


# every n_bins at which the launch configuration changes: each warp
# ranks a 2048-element block in n_bins + 1 cells of 8 bytes, a CUDA block
# holds min(8, 6144 // (n_bins + 1)) warps (48 KB), and one warp past
# 6143 bins (shared memory above 48 KB)
RANK_CONFIG_BINS = [1, 2, 31, 767, 768, 876, 877, 1023, 1024, 1227, 1228,
                    1535, 1536, 2047, 2048, 3071, 3072, 6143, 6144, 10239,
                    kernels.RANK_HIST_MAX_BINS]


@pytest.mark.parametrize("n_bins", RANK_CONFIG_BINS)
@pytest.mark.parametrize("dist", ["misfits", "runs"])
def test_rank_hist_launch_configurations(dev, n_bins, dist):
    g = torch.Generator(device=dev).manual_seed(n_bins)
    # 25 blocks of 2048, the last ragged: the last CUDA block has fewer
    # 2048-element blocks than warps
    _rank_exact(_rank_digits(dist, 50_000, n_bins, g, dev), n_bins)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n_bins", [257, 4095])
def test_rank_hist_on_unaligned_views(dev, offset, n_bins):
    g = torch.Generator(device=dev).manual_seed(offset)
    buf = torch.randint(0, n_bins + 1, (9000,), generator=g, device=dev,
                        dtype=torch.int32)
    _rank_exact(buf[offset:offset + 6147], n_bins)


def test_rank_hist_refuses_wide_bins(dev):
    d = torch.zeros(5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.rank_hist_cuda(d, kernels.RANK_HIST_MAX_BINS + 1)
    ranks, _ = kernels.rank_hist_cuda(d, kernels.RANK_HIST_MAX_BINS)
    assert ranks.tolist() == [0, 1, 2, 3, 4]
    assert kernels.RANK_HIST_MAX_BINS >= 10239    # the limit never falls


@pytest.mark.parametrize("n", [1, 2049, 3_000_017, 0])
def test_partition_and_radix_sort_match_torch_sort(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    keys = torch.randint(0, 1 << 18, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    want = torch.sort(keys, stable=True).indices.to(torch.int32)
    assert torch.equal(radix_sort_order(keys, 18, 9), want)
    digits = keys & 255
    digits[:: 13] = 256                            # dead lanes sort last
    order, hist = partition_order(digits, 256)
    assert torch.equal(order,
                       torch.sort(digits, stable=True).indices.int())
    assert torch.equal(hist, torch.bincount(digits, minlength=257).int())


@pytest.mark.parametrize("dist", ["hot", "runs", "dead"])
def test_partition_skewed_matches_torch_sort(dev, dist):
    g = torch.Generator(device=dev).manual_seed(5)
    digits = _rank_digits(dist, 3_000_017, 256, g, dev)
    order, hist = partition_order(digits, 256)
    assert torch.equal(order,
                       torch.sort(digits, stable=True).indices.int())
    assert torch.equal(hist, torch.bincount(digits, minlength=257).int())


def test_partition_out_of_range_digits_stay_in_bounds(dev):
    """Digits outside [0, n_bins] have no place in the order: with k
    digits in range, order[:k] is the stable argsort of those k (dead
    lanes last) and order[k:] is 0; the scatter stays inside its buffer
    (no device assert) and the histogram counts only digits in range."""
    g = torch.Generator(device=dev).manual_seed(9)
    digits = torch.randint(0, 257, (100_003,), generator=g, device=dev,
                           dtype=torch.int32)
    digits[:: 101] = -7
    digits[3:: 103] = 257
    digits[5:: 107] = 2**31 - 1
    digits[6:: 109] = -2**31
    digits[8:: 113] = 258
    order, hist = partition_order(digits, 256)
    torch.cuda.synchronize()
    ok = (digits >= 0) & (digits <= 256)
    k = int(ok.sum())
    assert order.shape == digits.shape
    assert bool(((order >= 0) & (order < digits.shape[0])).all())
    inside = torch.nonzero(ok).flatten()
    want = inside[torch.sort(digits[inside], stable=True).indices]
    assert torch.equal(order[:k], want.int())
    assert not bool(order[k:].any())
    assert torch.equal(hist, torch.bincount(digits[ok], minlength=257).int())


def _general_queries(rng, rels, n_queries=10):
    """Any join graph: cycles, same-slot predicates, repeated slots."""
    queries = []
    for _ in range(n_queries):
        nslots = int(rng.integers(1, 4))
        slots = [int(rng.integers(0, len(rels))) for _ in range(nslots)]
        joins = []
        for _ in range(int(rng.integers(0, 4))):
            s1, s2 = (int(x) for x in rng.integers(0, nslots, 2))
            joins.append(JoinPred(s1, int(rng.integers(0, 3)), s2,
                                  int(rng.integers(0, 3))))
        filters = [FilterPred(int(rng.integers(0, nslots)),
                              int(rng.integers(0, 3)),
                              str(rng.choice(["=", "<", ">"])),
                              int(rng.integers(0, 70)))
                   for _ in range(int(rng.integers(0, 3)))]
        projs = [Projection(int(rng.integers(0, nslots)),
                            int(rng.integers(0, 3)))
                 for _ in range(int(rng.integers(1, 4)))]
        queries.append(Query(slots, joins, filters, projs))
    return rels, queries


@pytest.mark.parametrize("seed", range(3))
def test_per_query_executor_cuda_matches_cpu(dev, seed):
    """The sort backend one query a call (Engine.execute, which replaced
    the per-query executor) on the card: the CPU's lines and the
    oracle's."""
    rng = np.random.default_rng(300 + seed)
    rels, _ = _tree_workload(rng)
    rels, queries = _general_queries(rng, rels)
    cfg = EngineConfig(join_backend="sort")

    def lines(device):
        eng = Engine(rels, cfg, device=device)
        return [format_result(eng.execute(q), len(q.projections))
                for q in queries]
    got = lines(dev)
    assert got == lines("cpu")
    oracle = OracleExecutor(rels)
    assert got == [format_result(oracle.execute(q), len(q.projections))
                   for q in queries]


# ---- the wave-batched materialized fallback on the card ----

def _fallback_operands(seed, dev):
    """Operands of the fallback's dense ops, made on the host from a seed:
    (cpu tensors, the same on `dev`)."""
    rng = np.random.default_rng(seed)
    host = {
        "col_full": rng.integers(0, 40, 300).astype(np.int32),
        "col_fresh": rng.integers(0, 40, 200).astype(np.int32),
        "proj": rng.integers(0, 2**31 - 1, 200).astype(np.int32),
        "mat": rng.integers(0, 300, (2, 4096)).astype(np.int32),
        "fresh_rows": rng.integers(0, 200, 2048).astype(np.int32),
        "rows": rng.integers(0, 300, 4096).astype(np.int32),
        "mult": rng.integers(0, 1 << 20, 4096).astype(np.int64),
    }
    cpu = {k: torch.from_numpy(v) for k, v in host.items()}
    return cpu, {k: v.to(dev) for k, v in cpu.items()}


@pytest.mark.parametrize("ex_kind,with_mult", [("mat", False),
                                               ("mat", True),
                                               ("rows", False)])
def test_terminal_join_cuda_matches_cpu(dev, ex_kind, with_mult):
    from radixhashjoin_tpu_torch.ops.terminal import (
        channel_spec, terminal_join_and_project)
    ch = channel_spec(64, 2**31 - 1)          # several T channels
    specs = ((("fresh", ch), ("mat", 0)) if ex_kind == "mat"
             else (("fresh", ch), ("rows",)))
    outs = []
    before = dict(kernels.LAUNCHES)
    for ops in _fallback_operands(7, dev):
        src = ops["mat"] if ex_kind == "mat" else ops["rows"]
        empty, sums = terminal_join_and_project(
            src, 3000, ops["fresh_rows"], 1900, ops["col_full"],
            ops["col_fresh"], (ops["proj"], ops["col_full"]),
            (ex_kind, 1, specs), 1024,
            mult=ops["mult"] if with_mult else None)
        outs.append((bool(empty), [s.cpu() for s in sums]))
    assert outs[0][0] == outs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert all(kernels.LAUNCHES[k] > before[k] for k in ("bincount",
                                                         "gather"))


# ---- the sort join's probe kernel (csrc/probe.cu)

def _probe_sides(dev, L, R, kind, seed):
    """A left column and L candidate rowids (ascending, or in an
    expansion's order: ascending runs of repeated rowids), a right column
    with ties, runs longer than a sector and than 256 values, and values
    below 0 (-1 among them, which the left padding matches), and its
    rowids with garbage past the ragged live count."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_l = L // 2 + 77
    v = max(R // 3, 2)
    col_l = torch.randint(-2, v + v // 8 + 1, (n_l,), generator=g,
                          device=dev, dtype=torch.int32)
    if kind == "ascending":
        rows = torch.sort(torch.randint(0, n_l, (L,), generator=g,
                                        device=dev, dtype=torch.int32)).values
    else:
        base = torch.sort(torch.randint(0, n_l, (L // 4 + 1,), generator=g,
                                        device=dev, dtype=torch.int32)).values
        reps = torch.randint(1, 8, base.shape, generator=g, device=dev)
        rows = torch.repeat_interleave(base, reps)[:L]
        rows = torch.cat([rows, torch.full((L - rows.numel(),), n_l - 1,
                                           dtype=torch.int32, device=dev)])
    col_r = torch.randint(-3, v, (R,), generator=g, device=dev,
                          dtype=torch.int32)
    if R >= 1000:
        col_r[R // 4:R // 4 + 300] = v // 2       # a run of 300
        col_r[R // 2:R // 2 + 9] = v // 3         # past one sector
    rc = R - R // 5
    rrows = torch.cat([torch.randperm(R, generator=g, device=dev)[:rc]
                       .to(torch.int32),
                       torch.randint(-9, R + 9, (R - rc,), generator=g,
                                     device=dev, dtype=torch.int32)])
    return g, col_l, rows, col_r, rrows, rc


def _probe_plain(col_l, rows, lc, col_r, rrows, rc):
    """The plain version (ops/join.py probe_count on the clamped gathers),
    on the tensors' device."""
    from radixhashjoin_tpu_torch.ops.filter import gather_clamped
    from radixhashjoin_tpu_torch.ops.join import probe_count
    return probe_count(gather_clamped(col_l, rows), lc,
                       gather_clamped(col_r, rrows), rc)


def _probe_equal(got, want, what):
    assert len(got) == len(want) == 5
    for name, a, b in zip(("order", "lo", "offsets", "cum", "total"), got,
                          want):
        assert a.dtype == b.dtype == torch.int32, (what, name)
        assert a.shape == b.shape, (what, name)
        assert torch.equal(a.cpu(), b.cpu()), (what, name)


@pytest.mark.parametrize("kind", ["ascending", "expanded"])
@pytest.mark.parametrize("R", [1, 4096, 40_000, 1 << 20, 3_000_017])
@pytest.mark.parametrize("L", [1 << 24, 1 << 27])
def test_sort_probe_cuda_matches_cpu(dev, L, R, kind):
    """The sort backend's probe on the card (ops/join.py
    probe_gather_count: the right side's sort, then one launch of the
    probe kernel) gives the plain version's five outputs bit for bit: R
    whole in shared memory (1, 4,096) and through the sampled index
    (40,000, 2^20, 3,000,017), live counts 0, 1, ragged and L, each as a 0-d
    device tensor and as a host int, garbage rowids past the count on
    both sides (3,000,017: a ragged R, halving through the sector heads
    before their sector). The plain version runs on the card; at 2^24
    lanes it is also held to its CPU run at the ragged count."""
    from radixhashjoin_tpu_torch.ops.join import probe_gather_count
    g, col_l, rows, col_r, rrows, rc = _probe_sides(dev, L, R, kind,
                                                    L + R + len(kind))
    n_l = col_l.shape[0]
    ragged = L - 12_345
    for lc in (0, 1, ragged, L):
        lrows = rows.clone()
        lrows[lc:] = torch.randint(-9, n_l + 9, (L - lc,), generator=g,
                                   device=dev, dtype=torch.int32)
        want = _probe_plain(col_l, lrows, lc, col_r, rrows, rc)
        if L == 1 << 24 and lc == ragged:
            cpu = _probe_plain(col_l.cpu(), lrows.cpu(), lc, col_r.cpu(),
                               rrows.cpu(), rc)
            _probe_equal(want, cpu, "plain card vs cpu")
            assert 0 < int(cpu[4])
        for cnt in (lc, torch.tensor(lc, dtype=torch.int32, device=dev)):
            before = kernels.PROBE_LAUNCHES
            got = probe_gather_count(col_l, lrows, cnt, col_r, rrows, rc)
            torch.cuda.synchronize()
            assert kernels.PROBE_LAUNCHES == before + 1
            _probe_equal(got, want, (lc, type(cnt)))
        del lrows, want, got


@pytest.mark.parametrize("R", [4096, 1 << 20])
def test_sort_probe_cuda_overflow(dev, R):
    """2^24 left lanes each matching a run of 256 equal right values:
    2^32 pairs, total -1, and the plain version's wrapped offsets and
    cum, on the card and on the CPU."""
    from radixhashjoin_tpu_torch.ops.join import probe_gather_count
    L = 1 << 24
    g = torch.Generator(device=dev).manual_seed(R)
    col_r = torch.arange(R, dtype=torch.int32, device=dev) // 256
    col_l = torch.randint(0, R // 256, (L,), generator=g, device=dev,
                          dtype=torch.int32)
    rows = torch.arange(L, dtype=torch.int32, device=dev)
    rrows = torch.randperm(R, generator=g, device=dev).to(torch.int32)
    want = _probe_plain(col_l.cpu(), rows.cpu(), L, col_r.cpu(),
                        rrows.cpu(), R)
    assert int(want[4]) == -1
    before = kernels.PROBE_LAUNCHES
    got = probe_gather_count(col_l, rows, torch.tensor(L, device=dev),
                             col_r, rrows, R)
    torch.cuda.synchronize()
    assert kernels.PROBE_LAUNCHES == before + 1
    _probe_equal(got, want, "overflow")
    assert int(got[3][-1]) == 0                 # 2^32 wraps to 0


def test_sort_probe_launches_only_the_kernel_and_refuses(dev):
    """One probe on the card launches the probe kernel and neither a
    searchsorted nor a scan; the wrapper refuses what the kernel does not
    take, launching nothing."""
    from torch.profiler import ProfilerActivity, profile

    from radixhashjoin_tpu_torch.ops.join import probe_gather_count
    _g, col_l, rows, col_r, rrows, rc = _probe_sides(dev, 1 << 20, 1 << 20,
                                                     "ascending", 5)
    probe_gather_count(col_l, rows, 1000, col_r, rrows, rc)   # builds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        probe_gather_count(col_l, rows, 1000, col_r, rrows, rc)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("probe_kernel" in n for n in names), names
    assert any("probe_fill_kernel" in n for n in names), names
    assert not any("searchsorted" in n.lower() or "Scan" in n
                   for n in names), names
    x = torch.arange(64, dtype=torch.int32, device=dev)
    before = kernels.PROBE_LAUNCHES
    with pytest.raises(TypeError):
        kernels.probe_cuda(x.long(), x, 3, x)
    with pytest.raises(TypeError):
        kernels.probe_cuda(x, x, 3, x.long())
    with pytest.raises(ValueError, match="CUDA"):
        kernels.probe_cuda(x, x.cpu(), 3, x)
    with pytest.raises(ValueError):
        kernels.probe_cuda(x, x[::2], 3, x)
    with pytest.raises(ValueError):
        kernels.probe_cuda(x, x[:0], 0, x)
    with pytest.raises(ValueError):
        kernels.probe_cuda(x, x, torch.tensor(3), x)
    assert kernels.PROBE_LAUNCHES == before


def test_ssb_sort_backend_probes_on_the_kernel(dev):
    """SSB queries of every template through Engine on the sort backend,
    at the configuration's card test size, print the plain reference's
    lines; each probe of a join is one probe-kernel launch, counted in
    PROBE_LAUNCHES and not in LAUNCHES."""
    from benchmark import generator
    from benchmark.spec import Cell, load_benchmark
    from benchmark.tests.test_benchmark_cells import sized
    from radixhashjoin_tpu_torch.workload import parse_query
    cell = sized(Cell(load_benchmark(), "ssb_sf20.mixed"), "card")
    seed = 2_300_000_022
    columns = cell.schema.generate(cell.config, seed, dev)
    engine = Engine([Relation(list(c)) for c in columns],
                    EngineConfig(join_backend="sort"), device=dev)
    cycle = generator.requests(
        cell.traffic, cell.schema.templates(cell.config, columns), seed)
    ref = cell.reference(columns, dev)
    seen = set()
    for label, lines, _draws in cycle:
        if label in seen:
            continue
        seen.add(label)
        queries = [parse_query(ln) for ln in lines]
        want = ref.lines(lines)
        assert engine.run_batch(queries) == want, label   # warm (builds)
        before = kernels.PROBE_LAUNCHES
        launches = sum(kernels.LAUNCHES.values())
        got = engine.run_batch(queries)
        torch.cuda.synchronize()
        assert got == want, label
        assert kernels.PROBE_LAUNCHES > before, label
        assert sum(kernels.LAUNCHES.values()) == launches, label
    assert len(seen) == 13
    assert kernels.PROBE_LAUNCHES > 0


@pytest.mark.parametrize("count", [0, 1, 3000, 4096])
def test_dense_any_common_cuda_matches_cpu(dev, count):
    from radixhashjoin_tpu_torch.ops.join_dense import dense_any_common
    rng = np.random.default_rng(count)
    a = rng.integers(0, 5000, 4096).astype(np.int32)
    b = rng.integers(3000, 9000, 4096).astype(np.int32)
    want = dense_any_common(torch.from_numpy(a), torch.from_numpy(b), count,
                            16384)
    got = dense_any_common(torch.from_numpy(a).to(dev),
                           torch.from_numpy(b).to(dev), count, 16384)
    assert bool(got) == bool(want)


@pytest.mark.parametrize("src", [("rows", 0), ("mat", 1)])
def test_defer_attach_cuda_matches_cpu(dev, src):
    """A deferred attach through the stage runner: the compacted matrix
    (base rows, mult row, lv row), its count and its NULL flag."""
    from radixhashjoin_tpu_torch.ops.stage import run_stage
    results = []
    for ops in _fallback_operands(9, dev):
        d = ops["rows"].device
        live = (ops["rows"], ops["fresh_rows"])
        cnts = tuple(torch.tensor(n, dtype=torch.int32, device=d)
                     for n in (3500, 1800))
        plan = (("defer_attach", 0, 1, src),)
        out = run_stage(live, cnts, (ops["mat"],),
                        (torch.tensor(3900, dtype=torch.int32, device=d),),
                        (), (ops["col_full"], ops["col_fresh"]), (), plan,
                        1024, keep_mats=(0,))
        results.append([out[0].cpu(), out[3][0].cpu(), out[4][0].cpu()])
    assert all(torch.equal(a, b) for a, b in zip(*results))


@pytest.mark.parametrize("cfg", [{}, {"factorized": False},
                                 {"join_backend": "sort"},
                                 {"fuse_stages": False}])
def test_batch_fallback_cuda_matches_cpu(dev, cfg):
    """Every query shape through the batch path on the card: the same
    lines as on the CPU and as the oracle."""
    rng = np.random.default_rng(400)
    rels, _ = _tree_workload(rng)
    rels, queries = _general_queries(rng, rels, n_queries=16)
    eng = Engine(rels, EngineConfig(**cfg), device=dev)
    got = eng.run_batch(queries)
    assert got == Engine(rels, EngineConfig(**cfg),
                         device="cpu").run_batch(queries)
    oracle = OracleExecutor(rels)
    assert got == [format_result(oracle.execute(q), len(q.projections))
                   for q in queries]


@pytest.mark.parametrize("cfg", [{"stage_group": 8}, {"stage_group": 1},
                                 {"ftree_wave": False},
                                 {"defer_middle": False,
                                  "factorized": False}])
def test_settings_cuda_match_one_round(dev, cfg):
    """stage_group, ftree_wave=False and defer_middle=False on the card:
    the lines of one round, of the CPU and of the oracle, through the
    build and lookup kernels."""
    rng = np.random.default_rng(401)
    rels, _ = _tree_workload(rng)
    rels, queries = _general_queries(rng, rels, n_queries=20)
    base = Engine(rels, EngineConfig(stage_group=None),
                  device=dev).run_batch(queries)
    before = dict(kernels.LAUNCHES)
    eng = Engine(rels, EngineConfig(**cfg), device=dev)
    got = eng.run_batch(queries)
    assert got == base
    assert got == Engine(rels, EngineConfig(**cfg),
                         device="cpu").run_batch(queries)
    oracle = OracleExecutor(rels)
    assert got == [format_result(oracle.execute(q), len(q.projections))
                   for q in queries]
    assert all(kernels.LAUNCHES[k] > before[k] for k in ("bincount",
                                                         "gather"))
    if "stage_group" in cfg:
        # rounds of k queries (a round of queries without operators
        # dispatches nothing)
        assert eng.batch_executor.counters["dispatches"] > 1


@pytest.mark.parametrize("cfg", [{}, {"fuse_stages": False}])
def test_profile_shares_on_cuda(dev, cfg):
    """profile=True on the card: the oracle's lines, every recorded
    operator's share of the H100's bandwidth at most 1.0 (none on
    another card), the report's rows those operators."""
    from radixhashjoin_tpu_torch.utils.profiling import hbm_bytes_per_s
    rng = np.random.default_rng(402)
    rels, _ = _tree_workload(rng)
    rels, queries = _general_queries(rng, rels, n_queries=16)
    eng = Engine(rels, EngineConfig(profile=True, **cfg), device=dev)
    got = eng.run_batch(queries)
    oracle = OracleExecutor(rels)
    assert got == [format_result(oracle.execute(q), len(q.projections))
                   for q in queries]
    ops = eng.batch_executor.profiler.ops
    assert ops
    bw = hbm_bytes_per_s(dev)
    for name, s in ops.items():
        assert s.device.type == "cuda" and s.seconds > 0, name
        if bw is None:
            assert s.roofline_frac is None
        else:
            assert 0 < s.roofline_frac <= 1.0, (name, s)
    report = eng.batch_executor.profiler.report().splitlines()
    assert {ln.split()[0] for ln in report[1:-1]} == set(ops)


# ---- the huge-node windowed pass: builds into an accumulator, uint16
# planes, the pass itself at shrunken thresholds ----

def _acc_exact(idx, w, n_bins, g):
    """The build into a nonzero accumulator equals acc + the plain
    build, returns that same accumulator, and launches once."""
    acc = torch.randint(0, 1 << 20, (n_bins,), generator=g,
                        device=idx.device, dtype=torch.int32)
    want = acc + weighted_bincount_torch(idx, w, n_bins)
    before = kernels.LAUNCHES["bincount"]
    got = kernels.weighted_bincount_cuda(idx, w, n_bins, out=acc)
    torch.cuda.synchronize()
    assert got is acc
    assert kernels.LAUNCHES["bincount"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_bins", [700, SMEM_BINS, SMEM_BINS + 1, 1 << 20])
@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_bincount_adds_into_accumulator(dev, n_bins, dist):
    """Both kernels (the shared-memory histogram up to SMEM_BINS, the
    hot-bin cache above) and the cache's direct adds (2^20 mostly
    distinct bins) add into what `out` holds, also on Zipf-hot bins."""
    g = torch.Generator(device=dev).manual_seed(n_bins)
    n = 1 << 22
    idx = (zipf_keys(g, n, n_bins, dev) if dist == "zipf"
           else torch.randint(-2, n_bins + 2, (n,), generator=g, device=dev,
                              dtype=torch.int32))
    w = torch.randint(0, 100, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    _acc_exact(idx, w, n_bins, g)


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("n_bins", [1024, 1 << 20])
def test_bincount_accumulator_on_unaligned_views(dev, offset, n_bins):
    """Windows are views at any element offset: keys, weights and the
    accumulator each at offsets 1-3 of larger tensors."""
    g = torch.Generator(device=dev).manual_seed(offset)
    for n in (3, 4001, (1 << 20) + 1):
        base = torch.randint(-3, n_bins + 3, (n + 8,), generator=g,
                             device=dev, dtype=torch.int32)
        w = torch.randint(0, 100, (n + 8,), generator=g, device=dev,
                          dtype=torch.int32)
        acc = torch.randint(0, 1 << 20, (n_bins + 8,), generator=g,
                            device=dev, dtype=torch.int32)
        outside = acc.clone()
        view = acc[offset:offset + n_bins]
        want = view + weighted_bincount_torch(
            base[offset:offset + n], w[8 - offset:8 - offset + n], n_bins)
        got = kernels.weighted_bincount_cuda(
            base[offset:offset + n], w[8 - offset:8 - offset + n], n_bins,
            out=view)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        # nothing outside the view moved
        outside[offset:offset + n_bins] = want
        assert torch.equal(acc, outside)


def test_uint16_planes_widen_on_cuda(dev):
    """A uint16 plane uploads from numpy and widens by zero extension to
    int32 and int64 on the card (values with the top bit set included),
    and the window fold reads it exactly."""
    from radixhashjoin_tpu_torch.utils.limbs import fold_window
    host = np.arange(0, 1 << 16, 7, dtype=np.uint16)
    host[-1] = 0xFFFF
    plane = torch.from_numpy(host).to(dev)
    assert plane.dtype == torch.uint16
    want = torch.from_numpy(host.astype(np.int64))
    assert torch.equal(plane.to(torch.int64).cpu(), want)
    assert torch.equal(plane.to(torch.int32).cpu(), want.int())
    assert torch.equal(plane[5:77].to(torch.int64).cpu(), want[5:77])
    w = torch.full((len(host),), 3, dtype=torch.int32, device=dev)
    assert int(fold_window(plane, w)) == 3 * int(host.astype(np.int64).sum())


def _huge_shrunk(monkeypatch):
    from radixhashjoin_tpu_torch.models import device_catalog
    from radixhashjoin_tpu_torch.ops import factorized
    from radixhashjoin_tpu_torch.utils import limbs
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 2048)
    monkeypatch.setattr(limbs, "_BIG_WINDOW_ROWS", 4096)
    monkeypatch.setattr(device_catalog, "_NARROW_PLANE_MIN_ROWS", 1024)


def test_huge_pass_cuda_matches_cpu(dev, monkeypatch):
    """The windowed huge-node pass at shrunken thresholds on the card: a
    single join, a star with dimension projections, a fact filter, a
    NULL, a wiped boolean component and a chain of two huge nodes, equal
    to the CPU run and the oracle, with the build and lookup kernels
    launched at least once per window of the huge nodes."""
    _huge_shrunk(monkeypatch)
    rng = np.random.default_rng(97)
    n, n2 = 5 * 4096 + 77, 3 * 4096 + 11

    def col(hi, m):
        return rng.integers(0, hi, m).astype(np.uint64)

    fact = Relation([col(300, n), col(200, n), col(1000, n)])
    d1 = Relation([np.arange(300, dtype=np.uint64), col(1000, 300)])
    d2 = Relation([np.arange(200, dtype=np.uint64), col(1000, 200)])
    f2 = Relation([col(300, n2), col(1000, n2)])
    rels = [fact, d1, d2, f2]
    star = [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)]
    queries = [
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
              [Projection(0, 2), Projection(1, 1)]),
        Query([0, 1, 2], star, [FilterPred(1, 1, "<", 900)],
              [Projection(0, 2), Projection(1, 1), Projection(2, 1)]),
        Query([0, 1, 2], star, [FilterPred(0, 2, "<", 700)],
              [Projection(0, 2), Projection(2, 1)]),
        Query([0, 1, 2], star, [FilterPred(1, 1, "=", 55555)],
              [Projection(0, 2)]),
        Query([0, 1, 2, 2], [JoinPred(0, 0, 1, 0), JoinPred(2, 0, 3, 0)],
              [], [Projection(2, 1)]),
        Query([3, 1, 0], [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 2, 0)],
              [FilterPred(0, 1, "<", 800)],
              [Projection(0, 1), Projection(2, 2)]),
    ]
    cfg = EngineConfig()
    before = dict(kernels.LAUNCHES)
    got = Engine(rels, cfg, device=dev).run_batch(queries)
    grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert got == Engine(rels, cfg, device="cpu").run_batch(queries)
    oracle = OracleExecutor(rels)
    assert got == [format_result(oracle.execute(q), len(q.projections))
                   for q in queries]
    windows = -(-n // 2048)
    assert grew["bincount"] >= windows and grew["gather"] >= windows


def test_chain_two_deep_huge_cuda_matches_closed_form(dev, monkeypatch):
    """bench_scale's two-deep chain (fact1 ⋈ fact2 ⋈ dim) with both facts
    just past a shrunken huge-node threshold (2^14 + 1097 rows: five
    windows of 4096, the last one ragged) on the card: its line equals
    the closed form and the CPU run, and its three window loops launch
    the build at least three times and the lookup four times a window."""
    from radixhashjoin_tpu_torch import bench_scale
    from radixhashjoin_tpu_torch.ops import factorized
    _huge_shrunk(monkeypatch)
    monkeypatch.setattr(factorized, "_BIG_WAVE_ROWS", 1 << 14)
    n = (1 << 14) + 1097
    case = bench_scale.chain(n, np.random.default_rng(0), n_keys=512)
    before = dict(kernels.LAUNCHES)
    eng = Engine(case.rels, EngineConfig(), device=dev)
    got = eng.run_workload([[case.query]])
    grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert got == case.expected
    assert eng.batch_executor.counters["ftree_queries"] == 1
    assert Engine(case.rels, EngineConfig(),
                  device="cpu").run_workload([[case.query]]) == got
    windows = -(-n // factorized._win_rows())
    assert windows == 5
    assert grew["bincount"] >= 3 * windows and grew["gather"] >= 4 * windows


def test_bench_scale_lines_launch_the_kernels(dev):
    """bench_scale's CLI at 2^16 rows on the card, every config: each line
    exact (the dense probes element by element) and timed, each dense
    probe's exactness run launching the build and the fused double
    lookup, each engine config's the build and the lookup, the skew
    join's the rank kernel."""
    import io
    import json

    from radixhashjoin_tpu_torch import bench_scale
    out = io.StringIO()
    assert bench_scale.main(["--rows", "16", "--zipf-engine", "--zipf-rows",
                             "16", "--star-rows", "16", "--chain-rows", "16",
                             "--skew", "--skew-rows", "65536", "--devices",
                             "1"], out) == 0
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert len(lines) == 10
    for ln in lines:
        assert ln["exact"] is True and isinstance(ln["value"], float), ln
        if ln["metric"].startswith("skewaware"):
            keys = ("rank_hist",)
        elif ln["metric"].startswith("dense_probe"):
            keys = ("bincount", "gather2")
        else:
            keys = ("bincount", "gather")
        assert all(ln["launches"][k] > 0 for k in keys), ln


@pytest.mark.parametrize("n,n_bins", [(1, 1), (5000, 4), (1 << 20, 8)])
def test_partition_by_digit_runs_the_rank_kernel(dev, n, n_bins):
    """The distributed layer's binning on a CUDA tensor is the rank
    kernel (one launch) and equals the plain version on the CPU."""
    from radixhashjoin_tpu_torch.ops.radix_partition import partition_by_digit
    g = torch.Generator(device=dev).manual_seed(n)
    digit = torch.randint(0, n_bins + 1, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    vals = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    before = kernels.LAUNCHES["rank_hist"]
    (got,), hist, offs = partition_by_digit(digit, (vals,), n_bins)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rank_hist"] == before + 1
    (want,), whist, woffs = partition_by_digit(digit.cpu(), (vals.cpu(),),
                                               n_bins)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(hist.cpu(), whist) and torch.equal(offs.cpu(), woffs)


def test_dist_world_of_one_cuda_matches_oracle(dev):
    """The DistExecutor in a world of one NCCL rank (this process): the
    factorized wave and the exchange pipeline (heavy broadcast and
    all_to_all) answer the oracle's lines, through the rank kernel."""
    from radixhashjoin_tpu_torch.parallel import multihost
    from radixhashjoin_tpu_torch.parallel.dist_executor import DistExecutor
    rng = np.random.default_rng(5)
    n = 50_000
    rels = [Relation([rng.integers(0, 3000, n).astype(np.uint64),
                      rng.integers(0, 1000, n).astype(np.uint64)]),
            Relation([np.arange(3000, dtype=np.uint64),
                      rng.integers(0, 1000, 3000).astype(np.uint64)]),
            Relation([rng.integers(0, 3000, 4000).astype(np.uint64),
                      rng.integers(0, 1000, 4000).astype(np.uint64)])]
    queries = [
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(1, 1, "<", 900)],
              [Projection(0, 1), Projection(1, 1)]),
        Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 2, 0),
                          JoinPred(2, 1, 0, 1)], [], [Projection(2, 1)]),
    ]
    oracle = OracleExecutor(rels)
    want = [format_result(oracle.execute(q), len(q.projections))
            for q in queries]
    multihost.init_multihost(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                             device="cuda")
    try:
        for cfg in ({}, {"factorized": False},
                    {"factorized": False, "skew_heavy_fraction": 1.0}):
            before = kernels.LAUNCHES["rank_hist"]
            ex = DistExecutor(rels, EngineConfig(mesh_devices=1, **cfg),
                              n_devices=1)
            assert ex.run_batch(queries) == want
            if cfg:
                assert ex.counters["exchange_queries"] == 2
                assert kernels.LAUNCHES["rank_hist"] > before
    finally:
        multihost.shutdown()


# ---- the conjunctive select kernel (csrc/select.cu)

SELECT_N = [0, 1, kernels.SELECT_TILE - 1, kernels.SELECT_TILE,
            kernels.SELECT_TILE + 1, (1 << 20) + 3, 1 << 24]
INT32_MAX = 2**31 - 1


def _select_case(dev, n, k, mode, seed):
    """Columns (offset views for some k, so loads start unaligned),
    predicates of every opcode with -1, 0 and INT32_MAX among the
    constants, and for "rows" sorted padded rowids whose tail is
    garbage (negative and past the columns)."""
    from radixhashjoin_tpu_torch.ops.filter import OP_EQ, OP_GT, OP_LT
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    off = k % 4
    n_cols = max(1, min(k, 3))
    cols = []
    for _ in range(n_cols):
        base = torch.randint(-2, 12, (n + off + 8,), generator=g,
                             device=dev, dtype=torch.int32)
        base[::1013] = INT32_MAX
        base[::997] = -1
        cols.append(base[off:off + n])
    consts = {OP_EQ: [-1, 0, INT32_MAX, 5], OP_LT: [INT32_MAX, 11, 10, 0, -1],
              OP_GT: [-1, -2, 0, 1, INT32_MAX]}
    if k == 1:
        preds = [[(cols[0], op, v)] for op in consts for v in consts[op]]
    else:
        one = []
        for i in range(k):
            op = OP_EQ if i == 0 and rng.random() < 0.3 else int(
                rng.choice([OP_LT, OP_GT]))
            v = (int(rng.choice(consts[op])) if op == OP_EQ
                 or rng.random() < 0.15 else consts[op][i % 3])
            one.append((cols[i % n_cols], op, v))
        preds = [one]
    rows = None
    if mode == "rows":
        keep = torch.rand(n, generator=g, device=dev) < 0.7
        live = torch.nonzero(keep).flatten().to(torch.int32)
        tail = torch.randint(-9, n + 9, (n - live.numel() + 5,), generator=g,
                             device=dev, dtype=torch.int32)
        roff = (k + 1) % 4
        rows = torch.cat([torch.zeros(roff, dtype=torch.int32, device=dev),
                          live, tail])[roff:]
    return preds, rows


@pytest.mark.parametrize("mode", ["identity", "rows"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", SELECT_N)
def test_select_kernel_exact(dev, n, k, mode):
    """The kernel's rows and count equal the plain chain's bit for bit
    (filter_conj_torch on the same card): every opcode with the
    constants -1, 0 and INT32_MAX, identity and rowid input, live
    counts 0, below and equal to the lanes as a host and a device
    count, pad above and below the lanes, unaligned column and rowid
    views, and 5 predicates as two chained launches."""
    from radixhashjoin_tpu_torch.ops.filter import (filter_conj,
                                                    filter_conj_torch)
    cases, rows = _select_case(dev, n, k, mode, 1000 + 7 * n + k)
    lanes = n if rows is None else rows.shape[0]
    for preds in cases:
        for live in sorted({0, lanes // 2 + 1 if lanes else 0, lanes}):
            for pad in (lanes + 4096 + 3, lanes // 2):
                want, want_n = filter_conj_torch(rows, live, preds, pad)
                for cnt in (live, torch.tensor(live, dtype=torch.int32,
                                               device=dev)):
                    before = kernels.SELECT_LAUNCHES
                    got, got_n = filter_conj(rows, cnt, preds, pad)
                    torch.cuda.synchronize()
                    assert kernels.SELECT_LAUNCHES - before == (
                        -(-len(preds) // kernels.SELECT_MAX_PREDS)
                        if lanes else 0)
                    assert got.dtype == torch.int32 and got.shape == (pad,)
                    assert got_n.dtype == torch.int32 and got_n.shape == ()
                    assert got_n.device == got.device == want.device
                    assert int(got_n) == int(want_n), (live, pad, preds)
                    assert torch.equal(got, want), (live, pad)


def test_select_kernel_one_launch_a_call_and_refusals(dev):
    x = torch.arange(10000, dtype=torch.int32, device=dev)
    before = kernels.SELECT_LAUNCHES
    preds = [(x, 2, 100), (x, 1, 9000), (x, 1, 9500), (x, 2, 50)]
    for i in range(1, 5):
        rows, cnt = kernels.select_cuda(None, 10000, preds[:i], 16384)
        assert kernels.SELECT_LAUNCHES == before + i
    torch.cuda.synchronize()
    assert int(cnt) == 8899 and torch.equal(
        rows[:8899], torch.arange(101, 9000, dtype=torch.int32, device=dev))
    assert not rows[8899:].any()
    before = kernels.SELECT_LAUNCHES
    with pytest.raises(TypeError):
        kernels.select_cuda(None, 10, [(x.long(), 1, 3)], 16)
    with pytest.raises(TypeError):
        kernels.select_cuda(x.long(), 10, [(x, 1, 3)], 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.select_cuda(None, 10, [(x.cpu(), 1, 3)], 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.select_cuda(x.cpu(), 10, [(x, 1, 3)], 16)
    with pytest.raises(ValueError):
        kernels.select_cuda(None, torch.tensor(3), [(x, 1, 3)], 16)
    with pytest.raises(ValueError):
        kernels.select_cuda(None, 10, [(x[::2], 1, 3)], 16)
    with pytest.raises(ValueError):
        kernels.select_cuda(None, 10, [(x, 3, 3)], 16)
    with pytest.raises(ValueError):
        kernels.select_cuda(None, 10, [(x, 1, 2**31)], 16)
    with pytest.raises(ValueError):
        kernels.select_cuda(None, 10, [(x, 1, 3), (x[:5], 1, 3)], 16)
    with pytest.raises(ValueError):
        kernels.select_cuda(None, 10, [(x, 1, 3)] * 5, 16)
    assert kernels.SELECT_LAUNCHES == before


def test_ssb_flight1_selects_once_a_filtered_slot(dev):
    """SSB flight-1 queries through Engine at the configuration's card
    test size print the plain reference's lines; under a capture each
    filtered slot takes one select launch, one filter span, and the
    counters read its passes and predicates."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import generator
    from benchmark.spec import Cell, load_benchmark
    from benchmark.tests.test_benchmark_cells import sized
    from radixhashjoin_tpu_torch.utils import profiling
    from radixhashjoin_tpu_torch.workload import parse_query
    cell = sized(Cell(load_benchmark(), "ssb_sf20.flight1"), "card")
    seed = 2_300_000_017
    columns = cell.schema.generate(cell.config, seed, dev)
    engine = Engine([Relation(list(c)) for c in columns], EngineConfig(),
                    device=dev)
    cycle = generator.requests(
        cell.traffic, cell.schema.templates(cell.config, columns), seed)
    ref = cell.reference(columns, dev)
    seen = set()
    for label, lines, _draws in cycle:
        if label in seen:
            continue
        seen.add(label)
        queries = [parse_query(ln) for ln in lines]
        per_slot = [{} for _ in queries]
        for q, slots in zip(queries, per_slot):
            for f in q.filters:
                slots[f.slot] = slots.get(f.slot, 0) + 1
        n_slots = sum(len(s) for s in per_slot)
        assert all(k <= kernels.SELECT_MAX_PREDS
                   for s in per_slot for k in s.values())
        want = ref.lines(lines)
        assert engine.run_batch(queries) == want       # warm (builds)
        torch.cuda.synchronize()
        profiling.reset_spans()
        before = kernels.SELECT_LAUNCHES
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            got = engine.run_batch(queries)
            torch.cuda.synchronize()
        spans = profiling.span_totals()
        profiling.reset_spans()
        assert got == want, label
        assert kernels.SELECT_LAUNCHES - before == n_slots
        assert spans["filter"]["calls"] == n_slots
        assert spans["filter.passes"]["count"] == n_slots
        assert spans["filter.predicates"]["count"] == sum(
            len(q.filters) for q in queries)
    assert seen == {"q1.1", "q1.2", "q1.3"}
