"""The port's distributed primitives (radixhashjoin_tpu_torch.ops.
radix_partition and parallel/) against the JAX package, on the CPU.

partition_by_digit / radix_partition run in this process and must equal
JAX's element for element. The radix-exchange join, the cross-rank rowid
gather and the int64 all_reduce run on spawned gloo worlds of 2 and 4
ranks, every case of one world in ONE group (a module-scoped fixture,
tests/torch_dist_ranks.py ops_cases), and are held against JAX's
functions on a 4-device mesh (the conftest's virtual CPU devices) and a
Counter oracle: exact, tolerance 0. Cases: uniform keys, ragged live
counts with an empty rank, a detected bin overflow, a dominant key
through the skew-aware join, chunked and capacity-bounded gathers, and
partial sums past 2**63. Every digit the layer bins lies in [0, n_bins].
"""

import collections
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from radixhashjoin_tpu.ops import radix_partition as jrp
from radixhashjoin_tpu.parallel import (dist_join_count_sum,
                                        dist_join_skewaware, make_mesh)
from radixhashjoin_tpu.parallel import dist_ops as jops
from radixhashjoin_tpu.parallel.dist_join import radix_exchange
from radixhashjoin_tpu_torch.ops import radix_partition as trp
from radixhashjoin_tpu_torch.parallel import dist_ops as tops
from radixhashjoin_tpu_torch.parallel import multihost
from radixhashjoin_tpu_torch.parallel.mesh import make_mesh as tmake_mesh

import torch_dist_ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
GROUP_TIMEOUT_S = 240
U64_MASK = (1 << 64) - 1


# ---- partition_by_digit / radix_partition (this process) ----

@pytest.mark.parametrize("n_bins,n", [(1, 1000), (4, 5000), (257, 20000),
                                      (8, 0)])
def test_partition_by_digit_matches_reference(n_bins, n):
    rng = np.random.default_rng(n_bins + n)
    digit = rng.integers(0, n_bins + 1, n).astype(np.int32)   # n_bins dead
    a = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    b = np.arange(n, dtype=np.int32)
    (ja, jb), jh, jo = jrp.partition_by_digit(jnp.asarray(digit),
                                              (jnp.asarray(a), jnp.asarray(b)),
                                              n_bins)
    (ta, tb), th, to = trp.partition_by_digit(torch.from_numpy(digit),
                                              (torch.from_numpy(a),
                                               torch.from_numpy(b)), n_bins)
    for j, t in ((ja, ta), (jb, tb), (jh, th), (jo, to)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
        assert t.dtype == torch.int32


@pytest.mark.parametrize("n_bins", [8, 256])
def test_radix_partition_matches_reference(n_bins):
    rng = np.random.default_rng(n_bins)
    n, count = 4096, 3000
    vals = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    rows = rng.permutation(n).astype(np.int32)
    want = jrp.radix_partition(jnp.asarray(vals), jnp.asarray(rows), count,
                               n_bins)
    got = trp.radix_partition(torch.from_numpy(vals), torch.from_numpy(rows),
                              count, n_bins)
    for j, t in zip(want, got):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("capacity", [4096, 600])
def test_rank_local_primitives_match_reference(capacity):
    """The collective-free halves of the exchange (_bin_pairs,
    _pack_prefix, _mask_heavy, _flat_probe) element for element against
    JAX's, with sentinel (dead) lanes, a truncating capacity and heavy
    digits."""
    rng = np.random.default_rng(capacity)
    n, n_dest = 4096, 4
    vals = rng.integers(0, 300, n).astype(np.int32)
    vals[rng.random(n) < 0.2] = 2**31 - 1                  # dead lanes
    rows = rng.permutation(n).astype(np.int32)
    heavy = np.array([False, True, False, True])
    j = jops._bin_pairs(jnp.asarray(vals), jnp.asarray(rows), n_dest,
                        capacity, np.int32(2**31 - 1))
    t = tops._bin_pairs(torch.from_numpy(vals), torch.from_numpy(rows),
                        n_dest, capacity, 2**31 - 1)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for keep in (True, False):
        np.testing.assert_array_equal(
            np.asarray(jops._mask_heavy(jnp.asarray(vals), jnp.asarray(heavy),
                                        n_dest, np.int32(2**31 - 1), keep)),
            tops._mask_heavy(torch.from_numpy(vals), torch.from_numpy(heavy),
                             n_dest, 2**31 - 1, keep).numpy())
    flags = vals % 3 == 0
    j = jops._pack_prefix(jnp.asarray(flags), capacity, jnp.asarray(vals),
                          jnp.asarray(rows))
    t = tops._pack_prefix(torch.from_numpy(flags), capacity,
                          torch.from_numpy(vals), torch.from_numpy(rows))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    lv = np.where(rng.random(n) < 0.1, -1, vals % 50).astype(np.int32)
    j = jops._flat_probe(jnp.asarray(lv), jnp.asarray(vals))
    t = tops._flat_probe(torch.from_numpy(lv), torch.from_numpy(vals))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_mesh_never_truncates():
    """No world: make_mesh raises; a CUDA world past the visible cards
    raises before anything starts (this host has none)."""
    with pytest.raises(RuntimeError, match="process group"):
        tmake_mesh(2)
    with pytest.raises(RuntimeError, match="visible cards"):
        multihost.check_devices(2, "cuda")
    multihost.check_devices(4, "cpu")


# ---- the spawned worlds ----

def _oracle(lv, rv):
    cnt = collections.Counter(rv.tolist())
    return (sum(cnt[x] for x in lv.tolist()),
            sum(cnt[x] * x for x in lv.tolist()))


def _shards(vals, n):
    return list(np.asarray(vals).reshape(n, -1))


def _join_cases(n):
    """(name, case) of the join functions on an n-rank layout."""
    cases = []
    rng = np.random.default_rng(0)
    cap = 512
    lv = rng.integers(0, 200, n * cap).astype(np.int32)
    rv = rng.integers(0, 200, n * cap).astype(np.int32)
    full = np.full(n, cap)
    cases.append(("uniform", dict(kind="count_sum", lv=_shards(lv, n),
                                  rv=_shards(rv, n), lc=full, rc=full,
                                  capacity=cap)))
    # ragged live prefixes, rank 1 with no live left row, rank n-1 with
    # no live right row
    rng = np.random.default_rng(1)
    cap = 256
    lv = rng.integers(0, 50, n * cap).astype(np.int32)
    rv = rng.integers(0, 50, n * cap).astype(np.int32)
    lc = np.array([256, 0, 17, 200][:n])
    rc = np.array([256, 3, 250, 0][:n])
    rc[-1] = 0
    for kind in ("exchange", "count_sum"):
        cases.append((f"ragged_{kind}", dict(
            kind=kind, lv=_shards(lv, n), rv=_shards(rv, n), lc=lc, rc=rc,
            capacity=cap)))
    # every row on one key: its destination overflows a small capacity
    cap = 64
    same = np.full(n * cap, 8, np.int32)
    cases.append(("overflow", dict(kind="count_sum", lv=_shards(same, n),
                                   rv=_shards(same, n), lc=np.full(n, cap),
                                   rc=np.full(n, cap), capacity=16)))
    # a dominant key: the skew-aware join stays exact with no overflow
    rng = np.random.default_rng(7)
    cap = 256
    lv = rng.integers(0, 50, n * cap).astype(np.int32)
    rv = rng.integers(0, 50, n * cap).astype(np.int32)
    rv[: n * cap // 2] = 8
    cases.append(("dominant", dict(kind="skewaware", lv=_shards(lv, n),
                                   rv=_shards(rv, n), lc=np.full(n, cap),
                                   rc=np.full(n, cap), capacity=cap,
                                   heavy_fraction=0.25)))
    rng = np.random.default_rng(9)
    lv = rng.integers(0, 500, n * cap).astype(np.int32)
    rv = rng.integers(0, 500, n * cap).astype(np.int32)
    cases.append(("skew_uniform", dict(kind="skewaware", lv=_shards(lv, n),
                                       rv=_shards(rv, n), lc=np.full(n, cap),
                                       rc=np.full(n, cap), capacity=cap,
                                       heavy_fraction=0.25)))
    return cases


def _gather_cases(n):
    cap = 4096
    rng = np.random.default_rng(3)
    col = rng.integers(0, 2**31 - 1, n * cap).astype(np.int32)
    cases = []
    for m, skewed in ((1 << 15, False), (1 << 15, True), (1 << 10, False)):
        if skewed:               # every request owned by the last rank
            idxs = rng.integers((n - 1) * cap, n * cap, m).astype(np.int32)
        else:
            idxs = rng.integers(0, n * cap, m).astype(np.int32)
        live = rng.random(m) < 0.9
        cases.append((f"gather_{m}_{'skewed' if skewed else 'uniform'}",
                      dict(kind="gather", col=_shards(col, n), idxs=idxs,
                           live=live, gcap=5 * m // 8, skewed=skewed,
                           want=np.where(live, col[idxs], 0))))
    return cases


def _wrap_case(n):
    parts = [(1 << 62) + 12345 * r + 7 for r in range(n)]
    return [("wrap", dict(kind="wrap", parts=parts))]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request):
    """Every case of one world size in one spawned gloo group: {case
    name: (case, per-rank results)} plus the digit ranges seen."""
    n = request.param
    named = _join_cases(n) + _gather_cases(n) + _wrap_case(n)
    outs = multihost.run_ranks(torch_dist_ranks.ops_cases, n,
                               ([c for _, c in named],), device="cpu",
                               timeout=GROUP_TIMEOUT_S)
    res = {name: (case, [outs[r][0][i] for r in range(n)])
           for i, (name, case) in enumerate(named)}
    digits = [d for r in range(n) for d in outs[r][1]]
    return n, res, digits


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(4)


def _jax_layout(case, n):
    """The live rows of an n-rank case laid out in 4 equal shards."""
    if n == 4:
        return [np.concatenate(case[k]) for k in ("lv", "rv")] + [
            np.asarray(case["lc"], np.int32), np.asarray(case["rc"], np.int32)]
    out = []
    for k, c in (("lv", "lc"), ("rv", "rc")):
        live = np.concatenate([s[:cnt] for s, cnt in zip(case[k], case[c])])
        cap = len(case[k][0]) * n // 4
        pad = np.full(4 * cap, 0, np.int32)
        counts = np.zeros(4, np.int32)
        for i in range(4):
            part = live[i * cap:(i + 1) * cap]
            pad[i * cap:i * cap + len(part)] = part
            counts[i] = len(part)
        out.append((pad, counts))
    return [out[0][0], out[1][0], out[0][1], out[1][1]]


_jit_count_sum = jax.jit(dist_join_count_sum,
                         static_argnames=("mesh", "capacity"))
_jit_skewaware = jax.jit(dist_join_skewaware,
                         static_argnames=("mesh", "capacity",
                                          "heavy_fraction"))


def _jax_join(jmesh, case, n):
    lv, rv, lc, rc = _jax_layout(case, n)
    args = (jmesh, jnp.asarray(lv), jnp.asarray(lc), jnp.asarray(rv),
            jnp.asarray(rc))
    cap = case["capacity"] * n // 4
    # jitted: eager shard_map takes ~15 s a call on the CPU, jit ~0.5 s
    if case["kind"] == "skewaware":
        p, lo, hi, ovf = _jit_skewaware(
            *args, capacity=cap, heavy_fraction=case["heavy_fraction"])
    else:
        p, lo, hi, ovf = _jit_count_sum(*args, capacity=cap)
    return int(p), int(lo) + (int(hi) << 16), int(ovf)


@pytest.mark.parametrize("name", ["uniform", "ragged_count_sum", "overflow",
                                  "dominant", "skew_uniform"])
def test_dist_joins_match_reference(world, jmesh, name):
    n, res, _ = world
    case, outs = res[name]
    live_l = np.concatenate([s[:c] for s, c in zip(case["lv"], case["lc"])])
    live_r = np.concatenate([s[:c] for s, c in zip(case["rv"], case["rc"])])
    # every rank reads the same global answer
    assert all(o == outs[0] for o in outs)
    pairs, vsum, ovf = outs[0]
    if name == "overflow":
        assert ovf > 0                 # the skew signal, never a silent drop
        if n == 4:
            assert ovf == _jax_join(jmesh, case, n)[2]
        return
    assert (pairs, vsum) == _oracle(live_l, live_r)
    assert ovf == 0
    jp, jsum, jovf = _jax_join(jmesh, case, n)
    assert (pairs, vsum) == (jp, jsum)
    if n == 4:
        assert ovf == jovf


def test_radix_exchange_matches_reference(world, jmesh):
    """Each rank's flat values after the exchange: with 4 ranks, element
    for element JAX's per-device result; with any world, every live row
    arrives exactly once, at the rank owning its digit."""
    n, res, _ = world
    case, outs = res["ragged_exchange"]
    for r, (lf, rf, _ovf) in enumerate(outs):
        assert ((lf == -1) | (lf % n == r)).all()
        assert ((rf == 2**31 - 1) | (rf % n == r)).all()
    got_l = np.concatenate([o[0] for o in outs])
    live_l = np.concatenate([s[:c] for s, c in zip(case["lv"], case["lc"])])
    np.testing.assert_array_equal(np.sort(got_l[got_l >= 0]),
                                  np.sort(live_l))
    if n != 4:
        return
    cap = case["capacity"]

    @partial(shard_map, mesh=jmesh, in_specs=(P("x"),) * 4,
             out_specs=(P("x"), P("x"), P("x")))
    def body(lv, lc, rv, rc):
        lf, rf, ovf = radix_exchange(lv, lc[0], rv, rc[0], 4, cap, "x")
        return lf, rf, ovf.reshape(1)
    lv, rv, lc, rc = _jax_layout(case, n)
    jl, jr, jo = (np.asarray(x) for x in jax.jit(body)(
        jnp.asarray(lv), jnp.asarray(lc), jnp.asarray(rv), jnp.asarray(rc)))
    for r, (lf, rf, ovf) in enumerate(outs):
        np.testing.assert_array_equal(lf, jl.reshape(4, -1)[r])
        np.testing.assert_array_equal(rf, jr.reshape(4, -1)[r])
        assert ovf == jo[r]


@pytest.mark.parametrize("name", ["gather_32768_uniform",
                                  "gather_32768_skewed",
                                  "gather_1024_uniform"])
def test_dist_gather_chunked_matches_unchunked(world, name):
    """Chunked gathers equal the unchunked one and the owner's values; a
    bounded capacity answers the same when it holds and raises the
    overflow on the owner (never a silent drop) when ownership skew
    exceeds it."""
    n, res, _ = world
    case, outs = res[name]
    live = case["live"]
    for got in outs:                   # dead lanes read garbage: masked
        base, ovf = got["base"]
        assert not ovf
        np.testing.assert_array_equal(np.where(live, base, 0), case["want"])
        np.testing.assert_array_equal(np.where(live, got["chunked"][0], 0),
                                      case["want"])
        assert not got["chunked"][1]
        vals, ovf = got["bounded"]
        if case["skewed"]:
            assert ovf
        else:
            assert not ovf
            np.testing.assert_array_equal(np.where(live, vals, 0),
                                          case["want"])


def test_int64_all_reduce_wraps_like_the_oracle(world):
    """Partial sums past 2**63 add mod 2**64 on gloo, as the exact folds
    need (the reference psums 16-bit halves instead)."""
    n, res, _ = world
    case, outs = res["wrap"]
    want = sum(case["parts"]) & U64_MASK
    assert sum(case["parts"]) >= 1 << 63
    for got in outs:
        assert got & U64_MASK == want


def test_every_binned_digit_is_in_range(world):
    """partition_order's declared divergence (digits outside [0, n_bins],
    ROADMAP.md §3) cannot arise: every digit the layer binned in this
    module's cases lay in [0, n_bins]."""
    _n, _res, digits = world
    assert digits
    assert all(0 <= lo and hi <= nb for lo, hi, nb in digits)
