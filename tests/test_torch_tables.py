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
