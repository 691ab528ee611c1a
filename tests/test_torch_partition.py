"""The radix kernels' modules of the PyTorch port (ops/partition.py,
ops/radix_hist.py) against the JAX package's Pallas kernels in
interpret mode, exactly (integers, tolerance 0), at the parametrizations
of tests/test_pallas_partition.py and tests/test_pallas.py, with dead
lanes and padding garbage.

On the CPU the port runs the kernels' plain versions; the CUDA kernels
themselves are checked on a card (tests/test_torch_cuda.py,
chip_smoke.py). Here the CUDA wrappers must refuse CPU tensors and the
library names must follow each source.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixhashjoin_tpu.ops import pallas_partition as jpart
from radixhashjoin_tpu.ops.pallas_radix import (radix_histogram as j_hist,
                                                radix_histogram_xla)
from radixhashjoin_tpu_torch import kernels
from radixhashjoin_tpu_torch.ops import partition as tpart
from radixhashjoin_tpu_torch.ops.radix_hist import (radix_histogram,
                                                    radix_histogram_torch)

torch.set_num_threads(1)

BLOCK = jpart.BLOCK


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_block_is_the_reference_block():
    assert tpart.BLOCK == BLOCK == 2048


# ---- rank_and_hist ----

# the last: a width past the CUDA kernel's 8-warp blocks (767 bins)
# that interpret mode still runs in seconds
@pytest.mark.parametrize("n,n_bins", [(BLOCK, 8), (3 * BLOCK, 256),
                                      (BLOCK + 37, 16), (2 * BLOCK - 1, 7),
                                      (BLOCK + 1, 257), (BLOCK + 77, 1500)])
def test_rank_and_hist_matches_jax(n, n_bins):
    rng = np.random.default_rng(n + n_bins)
    digits = rng.integers(0, n_bins, n).astype(np.int32)
    ranks, bh = tpart.rank_and_hist(_t(digits), n_bins)
    jr, jh = jpart.rank_and_hist(jnp.asarray(digits), n_bins,
                                 interpret=True)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(bh.numpy(), np.asarray(jh))
    assert ranks.dtype == bh.dtype == torch.int32


def _skewed_digits(dist, n, n_bins, rng):
    """One hot digit, or sorted runs (each longer than a warp's chunk of
    the CUDA kernel) over [0, n_bins)."""
    if dist == "hot":
        return np.full(n, n_bins // 2, np.int32)
    return np.sort(rng.integers(0, n_bins, n)).astype(np.int32)


@pytest.mark.parametrize("dist", ["hot", "runs"])
@pytest.mark.parametrize("n,n_bins", [(3 * BLOCK + 5, 257), (BLOCK, 9)])
def test_rank_and_hist_skewed_matches_jax(dist, n, n_bins):
    digits = _skewed_digits(dist, n, n_bins, np.random.default_rng(n))
    ranks, bh = tpart.rank_and_hist(_t(digits), n_bins)
    jr, jh = jpart.rank_and_hist(jnp.asarray(digits), n_bins,
                                 interpret=True)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(bh.numpy(), np.asarray(jh))


def _stable_ranks(digits):
    """rank = position among the equal digits of the 2048-block."""
    out = np.zeros(len(digits), np.int64)
    for b in range(0, len(digits), BLOCK):
        blk = digits[b:b + BLOCK]
        for d in np.unique(blk):
            pos = np.flatnonzero(blk == d)
            out[b + pos] = np.arange(len(pos))
    return out


@pytest.mark.parametrize("n_bins", [7, 257, 8, 256])
def test_rank_and_hist_dead_digit_lanes(n_bins):
    """Real lanes whose digit is n_bins (the dead bin) are ranked among
    themselves and left out of the histograms. The JAX kernel agrees
    when n_bins % 8 != 0; when n_bins is a multiple of 8 its padded bin
    axis has no row for digit n_bins and it gives those lanes rank 0
    (a divergence recorded in ROADMAP.md; no consumer reads them:
    partition_order ranks with n_bins + 1 bins)."""
    rng = np.random.default_rng(n_bins)
    n = 2 * BLOCK + 99
    digits = rng.integers(0, n_bins + 1, n).astype(np.int32)
    ranks, bh = tpart.rank_and_hist(_t(digits), n_bins)
    np.testing.assert_array_equal(ranks.numpy(), _stable_ranks(digits))
    jr, jh = jpart.rank_and_hist(jnp.asarray(digits), n_bins,
                                 interpret=True)
    jr = np.asarray(jr)
    np.testing.assert_array_equal(bh.numpy(), np.asarray(jh))
    real = digits < n_bins
    np.testing.assert_array_equal(ranks.numpy()[real], jr[real])
    if n_bins % 8:
        np.testing.assert_array_equal(ranks.numpy(), jr)
    else:
        assert (jr[~real] == 0).all()


def test_rank_and_hist_out_of_range_digits():
    digits = np.array([3, -1, 3, 9, 3, 4], np.int32)
    ranks, bh = tpart.rank_and_hist(_t(digits), 4)
    assert ranks.tolist() == [0, 0, 1, 0, 2, 0]
    assert bh.tolist() == [[0, 0, 0, 3]]


def test_rank_and_hist_empty():
    ranks, bh = tpart.rank_and_hist(torch.zeros(0, dtype=torch.int32), 16)
    assert ranks.shape == (0,) and bh.shape == (0, 16)


# ---- partition_order and radix_sort_order ----

@pytest.mark.parametrize("n,n_bins,dead", [(BLOCK, 8, 0), (2 * BLOCK, 64, 7),
                                           (BLOCK - 100, 16, 31),
                                           (3 * BLOCK + 5, 256, 500)])
def test_partition_order_matches_jax(n, n_bins, dead):
    rng = np.random.default_rng(n + n_bins)
    digits = rng.integers(0, n_bins, n).astype(np.int32)
    if dead:
        digits[rng.choice(n, dead, replace=False)] = n_bins
    order, hist = tpart.partition_order(_t(digits), n_bins)
    jo, jh = jpart.partition_order(jnp.asarray(digits), n_bins,
                                   interpret=True)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(digits, kind="stable"))
    assert int(hist[n_bins]) == dead


@pytest.mark.parametrize("dist", ["hot", "runs"])
def test_partition_order_skewed_matches_jax(dist):
    n, n_bins = 2 * BLOCK + 300, 256
    digits = _skewed_digits(dist, n, n_bins, np.random.default_rng(1))
    order, hist = tpart.partition_order(_t(digits), n_bins)
    jo, jh = jpart.partition_order(jnp.asarray(digits), n_bins,
                                   interpret=True)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(digits, kind="stable"))


def test_partition_order_out_of_range_digits_stay_in_bounds():
    """Digits outside [0, n_bins] have no place in the order: with k
    digits in range, order[:k] is the stable argsort of those k (dead
    lanes last), order[k:] is 0, and the histogram counts only digits in
    range. The reference clips such digits and lets them collide
    (pallas_partition.py:145-147), a divergence ROADMAP.md §3 declares."""
    rng = np.random.default_rng(4)
    digits = rng.integers(0, 17, 3 * BLOCK + 9).astype(np.int32)
    digits[::7] = -5
    digits[3::11] = 17
    digits[5::13] = 2**31 - 1
    digits[6::17] = -2**31
    digits[8::19] = 18
    order, hist = tpart.partition_order(_t(digits), 16)
    ok = (digits >= 0) & (digits <= 16)
    k = int(ok.sum())
    got = order.numpy()
    assert order.shape == (len(digits),)
    assert (got >= 0).all() and (got < len(digits)).all()
    inside = np.flatnonzero(ok)
    np.testing.assert_array_equal(
        got[:k], inside[np.argsort(digits[inside], kind="stable")])
    assert (got[k:] == 0).all()
    np.testing.assert_array_equal(hist.numpy(),
                                  np.bincount(digits[ok], minlength=17))


def test_partition_order_empty():
    order, hist = tpart.partition_order(torch.zeros(0, dtype=torch.int32),
                                        8)
    assert order.shape == (0,) and hist.tolist() == [0] * 9


@pytest.mark.parametrize("n,bits,digit_bits", [(BLOCK, 8, 8),
                                               (2 * BLOCK + 11, 18, 8),
                                               (BLOCK, 20, 6),
                                               (BLOCK + 3, 18, 9)])
def test_radix_sort_order_matches_jax(n, bits, digit_bits):
    rng = np.random.default_rng(bits)
    keys = rng.integers(0, 1 << bits, n).astype(np.int32)
    order = tpart.radix_sort_order(_t(keys), bits, digit_bits)
    jo = jpart.radix_sort_order(jnp.asarray(keys), bits, digit_bits,
                                interpret=True)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(
        order.numpy(), torch.sort(_t(keys), stable=True).indices.numpy())


# ---- radix_histogram ----

@pytest.mark.parametrize("n,count,n_bins", [
    (4096, 4096, 256), (4096, 3000, 256), (8192, 1, 128), (2048, 0, 256),
    (1024, 1000, 256), (3000, 2999, 512)])
def test_radix_histogram_matches_jax(n, count, n_bins):
    rng = np.random.default_rng(n + count)
    vals = rng.integers(0, 1 << 18, n).astype(np.int32)
    got = radix_histogram(_t(vals), count, n_bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_hist(jnp.asarray(vals), count, n_bins,
                                       interpret=True)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(radix_histogram_xla(
            jnp.asarray(vals), jnp.int32(count), n_bins)))
    # a 0-d count tensor, as a caller with a device count passes it
    np.testing.assert_array_equal(
        radix_histogram(_t(vals), torch.tensor(count), n_bins).numpy(),
        got.numpy())


def test_radix_histogram_ignores_padding_garbage():
    vals = np.full(2048, -1, dtype=np.int32)   # sentinel lanes everywhere
    vals[:5] = [0, 1, 1, 2, 255]
    got = radix_histogram(_t(vals), 5, 256)
    want = np.asarray(j_hist(jnp.asarray(vals), 5, 256, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == 5 and got[1] == 2
    # negative values take their low bits, like the reference's mask
    assert radix_histogram_torch(_t(vals), 2048, 256)[255] == 2044


@pytest.mark.parametrize("n_bins", [0, 64, 257, 1000])
def test_radix_histogram_rejects_bins(n_bins):
    with pytest.raises(ValueError):
        radix_histogram(torch.zeros(4, dtype=torch.int32), 4, n_bins)


# ---- the CUDA side, as far as the CPU can check it ----

def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.radix_histogram_cuda(x, 4, 256)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rank_hist_cuda(x, 8)
    assert set(kernels.LAUNCHES) == {"bincount", "gather", "gather2",
                                     "radix_hist", "rank_hist"}


def test_each_library_hashes_its_own_source(tmp_path, monkeypatch):
    """Editing one source renames its library and no other, so an edit
    never loads a stale build."""
    srcs = {}
    for name, path in kernels.SOURCES.items():
        srcs[name] = tmp_path / f"{name}.cu"
        srcs[name].write_bytes(open(path, "rb").read())
    monkeypatch.setattr(kernels, "SOURCES",
                        {k: str(v) for k, v in srcs.items()})
    before = {k: kernels.library_path(k) for k in srcs}
    assert len(set(before.values())) == len(srcs)
    srcs["radix"].write_bytes(srcs["radix"].read_bytes() + b"\n// edit\n")
    after = {k: kernels.library_path(k) for k in srcs}
    assert after["tables"] == before["tables"]
    assert after["radix"] != before["radix"]


def test_rank_hist_bound_mirrors_the_source():
    """kernels.py checks n_bins against the limit csrc/radix.cu derives
    from the shared memory a block may opt into on sm_90 (227 KB): one
    warp's n_bins + 1 cells of 8 bytes."""
    assert (kernels.RANK_HIST_MAX_BINS + 1) * 8 == 227 * 1024
    src = open(kernels.SOURCES["radix"]).read()
    assert "kRankMaxBins = kMaxSmemBytes / 8 - 1" in src
    assert "kMaxSmemBytes = 227 * 1024" in src
    assert "kHistMaxBins = 32 * 1024" in src
    assert kernels.RADIX_HIST_MAX_BINS == 32 * 1024
