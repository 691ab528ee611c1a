"""Message-table build/lookup of the PyTorch port
(radixhashjoin_tpu_torch/ops/tables.py) against the JAX package.

The port's plain versions must equal the JAX reference kernels exactly
(integers, tolerance 0): the weighted bincount against the Pallas one-hot
kernel in interpret mode and the XLA scatter; the gather against the
Pallas gather kernel in interpret mode and numpy. The port has one build
and one lookup a device, picked by the tensor's device; every table
variant of JAX's dispatch (mxu, hier, sorted, one-hot, diffcum, the fused
double lookup) and every impl name it takes must give the values of the
port's one dispatch on the same inputs, element for element. The CUDA
kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py); here the kernel module must import and refuse cleanly
without nvcc.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixhashjoin_tpu.ops import tables as jtables
from radixhashjoin_tpu.ops.tables import (table_gather_pallas,
                                          weighted_bincount_onehot,
                                          weighted_bincount_xla)
from radixhashjoin_tpu_torch import kernels
from radixhashjoin_tpu_torch.ops import tables as ptables
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
                                 n_bins).numpy()
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


@pytest.mark.parametrize("impl", ["mxu", "hier", "sorted", "xla", "auto",
                                  "onehot", "hier_presorted", "unknown"])
def test_unported_impls_raise(impl):
    """JAX's dispatch under every impl name (the test's name is from when
    the TPU-shaped ones raised) gives the values of the port's one
    scatter_table, table_gather and table_gather2, which take no name,
    element for element; including JAX's fall-through to the engines for
    names it does not branch on (in-range lookup keys: JAX's engine
    gather promises them). JAX's "onehot" build is its Pallas kernel,
    which interpret mode runs slowly; its MXU build stands in (the same
    values)."""
    rng = np.random.default_rng(len(impl))
    n, bins = 3000, 600
    idx = rng.integers(0, bins + 4, n).astype(np.int32)
    w = rng.integers(0, 1 << 16, n).astype(np.int32)
    jimpl = impl if impl != "onehot" else "mxu"
    want = np.asarray(jtables.scatter_table(jnp.asarray(idx), jnp.asarray(w),
                                            bins, jimpl))
    np.testing.assert_array_equal(
        scatter_table(_t(idx), _t(w), bins).numpy(), want)
    table = rng.integers(-2**31, 2**31 - 1, bins).astype(np.int32)
    keys = rng.integers(0, bins, n).astype(np.int32)
    want = np.asarray(jtables.table_gather(jnp.asarray(table),
                                           jnp.asarray(keys), impl))
    np.testing.assert_array_equal(
        table_gather(_t(table), _t(keys)).numpy(), want)
    ja, jb = jtables.table_gather2(jnp.asarray(table),
                                   jnp.asarray(table[::-1]),
                                   jnp.asarray(keys), impl)
    pa, pb = ptables.table_gather2(_t(table), _t(table[::-1]), _t(keys))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


# ---- the JAX package's other variants, held to the port's one dispatch

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _build_input(case, rng):
    """(idx, w, n_bins) of one build case: weights below a bound that
    keeps every bin's total < 2**31."""
    if case == "zipf":
        n, bins = 20000, 3000
        idx = _zipf_np(rng, n, bins)
        idx[rng.random(n) < 0.1] = bins          # the wave's mask sentinel
        return idx, rng.integers(0, 1000, n).astype(np.int32), bins
    if case == "negatives_out_of_range":
        n, bins = 5000, 700
        idx = rng.integers(-50, bins + 50, n).astype(np.int32)
        idx[::37] = np.iinfo(np.int32).max
        return idx, rng.integers(0, 1 << 20, n).astype(np.int32), bins
    if case == "sparse_spilling":                 # 1 key in ~5 bins
        n, bins = 6000, 1 << 15
        idx = rng.integers(0, bins, n).astype(np.int32)
        return idx, rng.integers(0, 1 << 20, n).astype(np.int32), bins
    if case == "one_bin_total_2^31-1":
        n, bins = 4096, 1024
        w = np.full(n, (2**31 - 1) // n, np.int64)
        w[-1] += (2**31 - 1) - w.sum()
        return np.full(n, 5, np.int32), w.astype(np.int32), bins
    n, bins = (int(x) for x in case.split("x"))   # "rows x bins"
    return (rng.integers(0, bins, n).astype(np.int32),
            rng.integers(0, 1 << 24, n).astype(np.int32), bins)


BUILD_VARIANT_CASES = ["zipf", "negatives_out_of_range", "sparse_spilling",
                       "one_bin_total_2^31-1", "1x8", "7x17", "4099x4096",
                       "2048x2048"]


@pytest.mark.parametrize("name", ["sorted", "mxu", "hier"])
@pytest.mark.parametrize("case", BUILD_VARIANT_CASES)
def test_build_variant_matches_jax(name, case):
    """The port's one build (scatter_table) equals JAX's
    weighted_bincount_{sorted,mxu,hier} on the same inputs (negative keys
    too: each drops them) and the plain build."""
    rng = np.random.default_rng(len(case) * 7 + len(name))
    idx, w, bins = _build_input(case, rng)
    got = scatter_table(_t(idx), _t(w), bins)
    assert got.dtype == torch.int32 and got.shape == (bins,)
    want = np.asarray(getattr(jtables, f"weighted_bincount_{name}")(
        jnp.asarray(idx), jnp.asarray(w), bins))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), weighted_bincount_torch(_t(idx), _t(w), bins).numpy())


@pytest.mark.parametrize("case", ["sorted", "sentinel_anchored_block",
                                  "imperfect_order", "sparse_spilling"])
def test_hier_presorted_matches_jax(case):
    """JAX's hier build with presorted=True (a window of a node-sorted
    column), small blocks, against the port's window build
    (scatter_add_window into a zero table): sorted keys; a block anchored
    at the mask sentinel n_bins holding later smaller keys (they spill);
    an imperfect order; sparse keys that leave their windows."""
    rng = np.random.default_rng(len(case))
    n, bins, block, sub = 4000, 900, 128, 128
    idx = np.sort(rng.integers(0, bins, n)).astype(np.int32)
    if case == "sentinel_anchored_block":
        idx[1024:1030] = bins                  # masked rows, then the rest
        idx[1280] = bins                       # a block starts here
    elif case == "imperfect_order":
        idx[::50] = rng.integers(-2, bins + 2, idx[::50].shape[0])
    elif case == "sparse_spilling":
        idx = np.sort(rng.integers(0, 1 << 16, n)).astype(np.int32)
        bins = 1 << 16
    w = rng.integers(0, 1 << 20, n).astype(np.int32)
    got = ptables.scatter_add_window(
        torch.zeros(bins, dtype=torch.int32), _t(idx), _t(w)).numpy()
    want = np.asarray(jtables.weighted_bincount_hier(
        jnp.asarray(idx), jnp.asarray(w), bins, block_rows=block,
        sub_width=sub, presorted=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, weighted_bincount_torch(_t(idx), _t(w), bins).numpy())


def _lookup_input(case, rng):
    """(table, keys, sorted) of one lookup case."""
    if case == "zipf":
        n, bins = 20000, 3000
        keys = _zipf_np(rng, n, bins)
    elif case == "out_of_range":
        n, bins = 5000, 700
        keys = rng.integers(-40, bins + 40, n).astype(np.int32)
        keys[::53] = np.iinfo(np.int32).max
    elif case == "sparse_spilling":
        n, bins = 3000, 1 << 15
        keys = rng.integers(0, bins, n).astype(np.int32)
    else:
        n, bins = (int(x) for x in case.split("x"))
        keys = rng.integers(0, bins, n).astype(np.int32)
    table = rng.integers(-2**31, 2**31 - 1, bins).astype(np.int32)
    table[:4] = [-2**31, 2**31 - 1, -1, 0]     # every byte boundary
    return table, keys


LOOKUP_VARIANT_CASES = ["zipf", "out_of_range", "sparse_spilling", "1x5",
                        "9x17", "4099x8192"]


@pytest.mark.parametrize("case", LOOKUP_VARIANT_CASES)
def test_gather_onehot_matches_jax(case):
    """The port's one lookup (table_gather; unsorted keys, out-of-range
    ones give 0) equals JAX's table_gather_onehot and the plain lookup."""
    table, keys = _lookup_input(case, np.random.default_rng(len(case)))
    got = table_gather(_t(table), _t(keys)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtables.table_gather_onehot(
        jnp.asarray(table), jnp.asarray(keys))))
    np.testing.assert_array_equal(
        got, table_gather_torch(_t(table), _t(keys)).numpy())


@pytest.mark.parametrize("name", ["diffcum", "hier"])
@pytest.mark.parametrize("case", LOOKUP_VARIANT_CASES)
def test_sorted_gather_variant_matches_jax(name, case):
    """The port's one lookup (table_gather) on sorted keys equals JAX's
    table_gather_{diffcum,hier} and the plain lookup; JAX's hier lookup
    with 128-key blocks and windows, and in two cases also on the
    unsorted keys (every out-of-window key takes its spill gather)."""
    table, keys = _lookup_input(case, np.random.default_rng(len(case) + 3))
    fn_j = getattr(jtables, f"table_gather_{name}")
    kw = {"block_rows": 128, "sub_width": 128} if name == "hier" else {}
    sk = np.sort(keys)
    got = table_gather(_t(table), _t(sk)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(fn_j(jnp.asarray(table), jnp.asarray(sk), **kw)))
    np.testing.assert_array_equal(
        got, table_gather_torch(_t(table), _t(sk)).numpy())
    if name == "hier" and case in ("zipf", "out_of_range"):
        got = table_gather(_t(table), _t(keys)).numpy()
        np.testing.assert_array_equal(got, np.asarray(fn_j(
            jnp.asarray(table), jnp.asarray(keys), block_rows=64,
            sub_width=32)))


@pytest.mark.parametrize("case", LOOKUP_VARIANT_CASES)
def test_gather2_matches_jax(case):
    """table_gather2 (on a CPU tensor, the plain version of the fused
    kernel) equals JAX's table_gather2 (its one-hot matmul of both
    tables' bytes under "onehot") and two plain lookups."""
    rng = np.random.default_rng(len(case) + 9)
    ta, keys = _lookup_input(case, rng)
    tb = rng.integers(-2**31, 2**31 - 1, ta.shape[0]).astype(np.int32)
    ok = (keys >= 0) & (keys < ta.shape[0])
    want = [np.where(ok, t[np.clip(keys, 0, t.shape[0] - 1)], 0)
            for t in (ta, tb)]
    ja, jb = jtables.table_gather2(jnp.asarray(ta), jnp.asarray(tb),
                                   jnp.asarray(keys), "onehot")
    np.testing.assert_array_equal(np.asarray(ja), want[0])
    np.testing.assert_array_equal(np.asarray(jb), want[1])
    ga, gb = ptables.table_gather2(_t(ta), _t(tb), _t(keys))
    np.testing.assert_array_equal(ga.numpy(), want[0])
    np.testing.assert_array_equal(gb.numpy(), want[1])


@pytest.mark.parametrize("case", LOOKUP_VARIANT_CASES)
def test_gather_pairs_matches_jax(case):
    """table_gather_pairs (the dense probe's lookup: both tables in the
    columns of one int32[n, 2], as the kernel reads them) equals JAX's
    table_gather2 on the two tables."""
    rng = np.random.default_rng(len(case) + 19)
    ta, keys = _lookup_input(case, rng)
    tb = rng.integers(-2**31, 2**31 - 1, ta.shape[0]).astype(np.int32)
    ja, jb = jtables.table_gather2(jnp.asarray(ta), jnp.asarray(tb),
                                   jnp.asarray(keys), "onehot")
    ga, gb = ptables.table_gather_pairs(_t(np.stack([ta, tb], 1)), _t(keys))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jb))


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.weighted_bincount_cuda(x, x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.table_gather_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.table_gather2_cuda(torch.zeros(4, 2, dtype=torch.int32), x)


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
