"""Message-table build/lookup of the PyTorch port
(radixhashjoin_tpu_torch/ops/tables.py) against the JAX package.

The port's plain versions must equal the JAX reference kernels exactly
(integers, tolerance 0): the weighted bincount against the Pallas one-hot
kernel in interpret mode and the XLA scatter; the gather against the
Pallas gather kernel in interpret mode and numpy. The CUDA kernels
themselves run only on a card (tests/test_torch_cuda.py, chip_smoke.py);
here the kernel module must import and refuse cleanly without nvcc.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixhashjoin_tpu.ops.tables import (table_gather_pallas,
                                          weighted_bincount_onehot,
                                          weighted_bincount_xla)
from radixhashjoin_tpu_torch import kernels
from radixhashjoin_tpu_torch.ops.tables import (scatter_table, table_gather,
                                                table_gather_torch,
                                                weighted_bincount_torch)

torch.set_num_threads(1)


@pytest.mark.parametrize("n,n_bins,wmax", [
    (5000, 700, 2**20),       # weights past every 7-/8-bit limb boundary
    (4096, 256, 2**30 // 4096),
    (1, 8, 5),
    (3000, 1024, 100),
])
def test_bincount_plain_matches_jax(n, n_bins, wmax):
    rng = np.random.default_rng(n + n_bins)
    # ~10% masked rows on the sentinel n_bins, plus negatives
    idx = np.where(rng.random(n) < 0.1, n_bins,
                   rng.integers(0, n_bins, n)).astype(np.int32)
    w = rng.integers(0, wmax, n).astype(np.int32)
    got = weighted_bincount_torch(torch.from_numpy(idx),
                                  torch.from_numpy(w), n_bins).numpy()
    xla = np.asarray(weighted_bincount_xla(jnp.asarray(idx), jnp.asarray(w),
                                           n_bins))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, xla)
    via_dispatch = scatter_table(torch.from_numpy(idx), torch.from_numpy(w),
                                 n_bins, "onehot").numpy()
    np.testing.assert_array_equal(via_dispatch, xla)
    # negative indices: the Pallas kernel (and the port) drop them; the
    # XLA scatter would wrap them numpy-style, so it is left out here
    idx[::97] = -1
    got = weighted_bincount_torch(torch.from_numpy(idx),
                                  torch.from_numpy(w), n_bins).numpy()
    pallas = np.asarray(weighted_bincount_onehot(
        jnp.asarray(idx), jnp.asarray(w), n_bins, interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_bincount_plain_empty():
    out = weighted_bincount_torch(torch.zeros(0, dtype=torch.int32),
                                  torch.zeros(0, dtype=torch.int32), 16)
    assert out.dtype == torch.int32 and out.shape == (16,)
    assert int(out.abs().sum()) == 0


@pytest.mark.parametrize("n,bins", [(1 << 15, 1 << 12), (100001, 1 << 16),
                                    (50000, 1 << 20)])
def test_gather_plain_matches_pallas_sorted(n, bins):
    rng = np.random.default_rng(5)
    table = rng.integers(-2**31, 2**31 - 1, bins).astype(np.int32)
    keys = np.sort(rng.integers(0, bins, n).astype(np.int32))
    keys[:3] = -2
    keys[-4:] = bins
    got = table_gather_torch(torch.from_numpy(table),
                             torch.from_numpy(keys)).numpy()
    ref = np.asarray(table_gather_pallas(jnp.asarray(table),
                                         jnp.asarray(keys), interpret=True))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,bins", [(1, 77), (1001, 77), (70000, 1 << 14)])
def test_gather_plain_matches_numpy_unsorted(n, bins):
    rng = np.random.default_rng(n)
    table = rng.integers(-2**31, 2**31 - 1, bins).astype(np.int32)
    keys = rng.integers(-50, bins + 50, n).astype(np.int32)
    ok = (keys >= 0) & (keys < bins)
    want = np.where(ok, table[np.clip(keys, 0, bins - 1)], 0)
    got = table_gather(torch.from_numpy(table), torch.from_numpy(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the adversarial shapes of tests/test_torch_cuda.py, held to JAX ----

SMEM_BINS = 48 * 1024          # csrc/tables.cu kSmemMaxBins
CACHE_SLOTS = 8192             # csrc/tables.cu kSlots


def _zipf_np(rng, n, n_keys):
    """The clipped Zipf(1.1) keys of bench_tables.zipf_keys, in numpy."""
    u = np.maximum(rng.random(n), 1e-30)
    return np.minimum(u ** -10.0, n_keys - 1).astype(np.int32)


def _warp_patterns(n_bins, reps):
    """Lanes of 32: all equal; all distinct; equal bins mixed with zero
    weights, the sentinel n_bins and -1; a ragged 17-lane tail."""
    lanes = np.arange(32)
    mixed = np.where(lanes % 4 == 0, n_bins, np.where(lanes % 4 == 1, -1,
                                                      lanes % 3))
    idx = np.concatenate([np.tile(np.concatenate(
        [np.full(32, 3), (lanes * 37) % n_bins, mixed]), reps),
        (lanes[:17] * 5) % n_bins])
    w = np.arange(1, idx.size + 1, dtype=np.int64) % 1000
    w[np.arange(idx.size) % 32 == 7] = 0
    return idx.astype(np.int32), w.astype(np.int32)


def _adversarial_build(case):
    """(idx, w, n_bins, negatives) of one adversarial build shape."""
    rng = np.random.default_rng(len(case))
    if case == "one_bin_total_2^31-1":
        n, n_bins = 4096, 1024
        w = np.full(n, (2**31 - 1) // n, np.int64)
        w[-1] += (2**31 - 1) - w.sum()
        return np.full(n, n_bins - 1, np.int32), w.astype(np.int32), n_bins
    if case.startswith("zipf"):
        spec = case.split("=")[1]
        n = 1 << 14
        n_bins = 1 << int(spec[2:]) if spec.startswith("2^") else int(spec)
        idx = _zipf_np(rng, n, n_bins)
        idx[rng.random(n) < 0.1] = n_bins
        idx[:: 1 << 10] = -1
        return idx, rng.integers(0, 100, n).astype(np.int32), n_bins
    if case == "more_bins_than_cache_slots":
        n = 1 << 16                   # runs of two equal keys
        idx = np.repeat(rng.integers(0, 3 * CACHE_SLOTS, n // 2), 2)
        w = rng.integers(1, 1000, n).astype(np.int32)
        return idx.astype(np.int32), w, 1 << 15
    if case.startswith("warp_patterns"):
        n_bins = int(case.split("=")[1])
        return (*_warp_patterns(n_bins, 20), n_bins)
    if case.startswith("n="):
        n = int(case[2:])
        idx = rng.integers(-2, 702, n).astype(np.int32)
        idx[0] = 699
        return idx, rng.integers(0, 1 << 20, n).astype(np.int32), 700
    n_bins = int(case.split("=")[1])              # shared-memory threshold
    idx = rng.integers(-3, n_bins + 3, 4096).astype(np.int32)
    return idx, rng.integers(0, 500, 4096).astype(np.int32), n_bins


BUILD_CASES = (["one_bin_total_2^31-1", "zipf_bins=4096", "zipf_bins=2^20",
                "more_bins_than_cache_slots", "warp_patterns_bins=64",
                "warp_patterns_bins=1000"]
               + [f"n={n}" for n in range(1, 10)]
               + [f"threshold_bins={b}" for b in (SMEM_BINS - 1, SMEM_BINS,
                                                  SMEM_BINS + 1)])


@pytest.mark.parametrize("case", BUILD_CASES)
def test_bincount_plain_matches_jax_adversarial(case):
    """The plain build equals the XLA scatter (on rows with no negative
    index, which it would wrap) and, below 2^13 bins, the Pallas kernel in
    interpret mode (on every row)."""
    idx, w, n_bins = _adversarial_build(case)
    got = weighted_bincount_torch(torch.from_numpy(idx), torch.from_numpy(w),
                                  n_bins).numpy()
    keep = idx >= 0
    xla = np.asarray(weighted_bincount_xla(jnp.asarray(idx[keep]),
                                           jnp.asarray(w[keep]), n_bins))
    np.testing.assert_array_equal(got, xla)
    if n_bins <= 1 << 13:
        pallas = np.asarray(weighted_bincount_onehot(
            jnp.asarray(idx), jnp.asarray(w), n_bins, interpret=True))
        np.testing.assert_array_equal(got, pallas)
    if case == "one_bin_total_2^31-1":
        assert int(got[n_bins - 1]) == 2**31 - 1


GATHER_CASES = ([f"n={n}" for n in range(1, 10)]
                + [f"threshold_bins={b}" for b in (SMEM_BINS - 1, SMEM_BINS,
                                                   SMEM_BINS + 1)])


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_plain_matches_jax_adversarial(case):
    """The plain lookup equals numpy on unsorted keys and the Pallas gather
    kernel (interpret mode) on the same keys sorted."""
    rng = np.random.default_rng(len(case))
    n, bins = ((int(case[2:]), 77) if case.startswith("n=")
               else (4097, int(case.split("=")[1])))
    table = rng.integers(-2**31, 2**31 - 1, bins).astype(np.int32)
    keys = rng.integers(-5, bins + 5, n).astype(np.int32)
    ok = (keys >= 0) & (keys < bins)
    want = np.where(ok, table[np.clip(keys, 0, bins - 1)], 0)
    np.testing.assert_array_equal(
        table_gather_torch(torch.from_numpy(table),
                           torch.from_numpy(keys)).numpy(), want)
    sk = np.sort(keys)
    ref = np.asarray(table_gather_pallas(jnp.asarray(table), jnp.asarray(sk),
                                         interpret=True))
    np.testing.assert_array_equal(
        table_gather_torch(torch.from_numpy(table),
                           torch.from_numpy(sk)).numpy(), ref)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("rem", [1, 2, 3])
def test_tables_plain_on_unaligned_views(offset, rem):
    """Contiguous views at element offsets 1-3 of a larger tensor with
    n % 4 = rem (the CUDA lookup's scalar head and tail): both plain
    versions equal the JAX functions on the same values."""
    rng = np.random.default_rng(offset * 10 + rem)
    n, bins = 4 * 250 + rem, 1000
    base = rng.integers(-3, bins + 3, n + 8).astype(np.int32)
    keys = torch.from_numpy(base)[offset:offset + n]
    assert keys.is_contiguous() and keys.storage_offset() == offset
    table = rng.integers(-2**31, 2**31 - 1, bins).astype(np.int32)
    sk = np.sort(base[offset:offset + n])
    np.testing.assert_array_equal(
        table_gather_torch(torch.from_numpy(table),
                           torch.from_numpy(sk)).numpy(),
        np.asarray(table_gather_pallas(jnp.asarray(table), jnp.asarray(sk),
                                       interpret=True)))
    ok = (keys.numpy() >= 0) & (keys.numpy() < bins)
    np.testing.assert_array_equal(
        table_gather_torch(torch.from_numpy(table), keys).numpy(),
        np.where(ok, table[np.clip(keys.numpy(), 0, bins - 1)], 0))
    w = torch.from_numpy(rng.integers(0, 100, n + 8).astype(np.int32))
    w = w[8 - offset:8 - offset + n]
    np.testing.assert_array_equal(
        weighted_bincount_torch(keys, w, bins).numpy(),
        np.asarray(weighted_bincount_onehot(
            jnp.asarray(keys.numpy()), jnp.asarray(w.numpy()), bins,
            interpret=True)))


@pytest.mark.parametrize("impl", ["mxu", "hier", "sorted", "xla"])
def test_unported_impls_raise(impl):
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        scatter_table(x, x, 8, impl)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        table_gather(x, x, impl)


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.weighted_bincount_cuda(x, x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.table_gather_cuda(x, x)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """The kernel module imports with no nvcc and no card (this file
    imports it); building then raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(kernels, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    assert not (tmp_path / "build").exists()
