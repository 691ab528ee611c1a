"""Data-scale join benchmarks of the port (counterpart:
scripts/bench_scale.py): one JSON line per config, with the reference
script's metric names, JSON keys and flags.

    python -m radixhashjoin_tpu_torch.bench_scale [--rows 26] [--skew] ...
    python -m radixhashjoin_tpu_torch.bench_scale --device cpu --rows 12 \\
        --zipf-engine --zipf-rows 12 --star-rows 12 --chain-rows 12 --skew

Configs, in the reference's order (each a function below that takes a
row count and a generator and returns its data and what the closed form
expects):

  dense_probe_uniform_tuples_per_s         `dense_uniform`: ops/join_dense
                                           dense_probe, 2^rows uniform
                                           keys a side over 2^20
  dense_probe_fk_tuples_per_s              `dense_fk`: 2^rows fact keys
                                           against a 2^20-row unique side
  dense_probe_narrow_domain_tuples_per_s   `dense_narrow`: keys below 4096
  star_join_engine_tuples_per_s            `star`: fact ⋈ dim1 ⋈ dim2
                                           through the engine, min(2^rows,
                                           2^24) fact rows, 2^20-row dims
  star_join_smalldim_engine_tuples_per_s   `star` with 1024-row dims
  zipf_join_engine_tuples_per_s            `zipf_join` (--zipf-engine):
                                           Zipf(1.1) fact ⋈ 2^20-row dim
  star_join_big_engine_tuples_per_s        `star_big` (--star-rows)
  chain_join_big_engine_tuples_per_s       `chain` (--chain-rows): fact1 ⋈
                                           fact2 ⋈ dim; past 2^28 rows a
                                           fact both facts are huge nodes
  skewaware_dist_join_tuples_per_s         `skew_join` (--skew):
                                           parallel.dist_join_skewaware

Every config is held exact before anything is timed: a dense probe's
pair total against the bincount product of its keys, and its per-left
counts, offsets, first match positions and right-side order element by
element against a bincount of the right keys (check_probe); an engine
config's lines against its closed-form NumPy oracle (unique dimension
keys make each sum a direct formula); the distributed join's pairs and
sum against a NumPy count. An inexact config raises. Each line carries
the kernel launches of its exactness run (kernels.counted: the counts
are set to 0 before it), not of the timed calls.

Host columns come from one np.random.default_rng(0) stream, drawn in the
reference's order. Device-side keys (the dense probes, the skew join)
come from torch.Generators on the target device, where the reference
draws them with jax.random, so those keys differ from the reference's.
The Zipf draws raise u to -1 / 0.1 (-10 exactly), as the big star of
the reference and the port's earlier cells do; the reference's Zipf
config writes -1 / (s - 1), whose last bit differs.

Timing, on the card only: a dense probe by CUDA events (bench_kernels
time_ms: WARMUP untimed calls, then `ITERS`); an engine config and the
distributed join by the host clock around calls that each end in a
readback, after WARMUP untimed calls (the first held exact). The
roofline keys count the bytes of the columns as the port's DeviceCatalog
holds them (int32 keys; uint16 planes only past _NARROW_PLANE_MIN_ROWS =
2^28 rows) against the card's published bandwidth (utils/profiling.py).
On the CPU (--device cpu) every exactness check runs on the plain
versions and nothing is timed: the lines say "not measured". Without a
card the default device cuda exits 2.

--impl takes the port's table impl names ("auto", "onehot"); the
reference's "xla" and "both" compare XLA with TPU one-hot paths the port
does not have and exit 2. --wsort takes the reference's values, and each
runs the port's one unsorted window pass. --skew runs a world of one
rank in this process (NCCL on the card), or N spawned ranks with
--devices N (gloo with --device cpu).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional, Sequence, TextIO

import numpy as np
import torch

from . import kernels
from .bench_kernels import WARMUP, time_ms
from .bench_tables import zipf_keys
from .config import EngineConfig
from .models import device_catalog
from .models.engine import Engine, resolve_device
from .ops.join_dense import dense_probe
from .ops.tables import check_impl
from .storage import INT32_MAX, Relation
from .utils.profiling import hbm_bytes_per_s
from .workload import FilterPred, JoinPred, Projection, Query

NOT_MEASURED = "not measured"
ITERS = 5
N_KEYS = 1 << 20
DOMAIN = 1 << 21
NARROW_DOMAIN = 1 << 12
SMALL_DIM_KEYS = 1 << 10
STAR_MAX_ROWS = 1 << 24          # the reference's host->device upload bound
# torch.Generator seeds of the device-side keys: the dense probes, and the
# skew join (regenerated on every rank)
PROBE_SEED = 0
SKEW_SEED = 3
U64 = np.uint64


# ---- configs: data and what the closed form expects ----

@dataclasses.dataclass
class Probe:
    """One dense-probe config: its device keys and live counts (0-d int32
    tensors), the value domain, and the closed form's pair count."""
    lvals: torch.Tensor
    lcount: torch.Tensor
    rvals: torch.Tensor
    rcount: torch.Tensor
    domain: int
    pairs: int

    def args(self):
        return (self.lvals, self.lcount, self.rvals, self.rcount,
                self.domain)


@dataclasses.dataclass
class Case:
    """One engine config: relations, its query, the oracle's lines."""
    rels: List[Relation]
    query: Query
    expected: List[str]


def _randint(gen: torch.Generator, hi: int, n: int) -> torch.Tensor:
    return torch.randint(0, hi, (n,), generator=gen, device=gen.device,
                         dtype=torch.int32)


def _probe(lvals, rvals, domain) -> Probe:
    """A probe with every lane live; pairs = Σ_k left(k) · right(k)."""
    dev = lvals.device
    counts = [torch.tensor(v.shape[0], dtype=torch.int32, device=dev)
              for v in (lvals, rvals)]
    left, right = (np.bincount(v.cpu().numpy(), minlength=domain)
                   for v in (lvals, rvals))
    pairs = int((left.astype(np.int64) * right).sum())
    return Probe(lvals, counts[0], rvals, counts[1], domain, pairs)


def dense_uniform(n: int, gen: torch.Generator) -> Probe:
    """n uniform keys a side over 2^20 values, in a 2^21 domain."""
    lv = _randint(gen, N_KEYS, n)
    return _probe(lv, _randint(gen, N_KEYS, n), DOMAIN)


def dense_fk(n: int, gen: torch.Generator) -> Probe:
    """n uniform fact keys against a unique 2^20-row dimension (the
    fact -> dimension shape): every fact row matches once."""
    lv = _randint(gen, N_KEYS, n)
    rv = torch.randperm(N_KEYS, generator=gen, device=gen.device,
                        dtype=torch.int32)
    return _probe(lv, rv, DOMAIN)


def dense_narrow(n: int, gen: torch.Generator) -> Probe:
    """n fact keys below 4096 against a unique 4096-row dimension, in a
    4096-value domain."""
    lv = _randint(gen, NARROW_DOMAIN, n)
    rv = torch.randperm(NARROW_DOMAIN, generator=gen, device=gen.device,
                        dtype=torch.int32)
    return _probe(lv, rv, NARROW_DOMAIN)


def check_probe(probe: Probe, result) -> int:
    """Raise unless dense_probe's (order, lo, offsets, cum, total) is
    right, on the probe's device: the total the closed form's (-1 past
    2^31 - 1 pairs, its capacity contract); element by element, each
    left row's count (cum - offsets) the right side's count of its key,
    offsets their exclusive prefix sum (int32, wrapping as the probe's
    contract says), lo the first position of the key in the value-sorted
    right side, and order a stable value-sort of the right side (a
    permutation, keys non-decreasing, row indices rising among equal
    keys). Returns the total."""
    order, lo, offsets, cum, total = result
    want = probe.pairs if probe.pairs <= INT32_MAX else -1
    total = int(total)
    lv, rv = probe.lvals.long(), probe.rvals.long()
    per_key = torch.bincount(rv, minlength=probe.domain)
    counts = per_key[lv]
    first = (torch.cumsum(per_key, 0) - per_key)[lv]
    offs = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    order = order.long()
    keys = rv[order]
    step = keys[1:] - keys[:-1]
    checks = {
        "total": total == want and int(counts.sum()) == probe.pairs,
        "counts": torch.equal((cum - offsets).long(), counts),
        "offsets": torch.equal(offsets, offs),
        "lo": torch.equal(lo.long(), first),
        "order": bool(torch.bincount(order, minlength=len(rv)).eq(1).all()
                      and ((step > 0) | ((step == 0)
                           & (order[1:] > order[:-1]))).all())}
    if not all(checks.values()):
        raise AssertionError(f"dense_probe differs from the closed form "
                             f"(total {total}, closed form {probe.pairs}): "
                             f"{checks}")
    return total


def _zipf(rng: np.random.Generator, n: int, n_keys: int) -> np.ndarray:
    """Zipf(1.1) over [0, n_keys) by inverse CDF, clipped in float before
    the cast (u^-10 overflows int64)."""
    u = rng.random(n) + 1e-12
    return np.minimum(u ** (-1.0 / 0.1), n_keys - 1).astype(U64)


def _vals(rng: np.random.Generator, hi: int, n: int) -> np.ndarray:
    return rng.integers(0, hi, n).astype(U64)


def _u64_sum(x: np.ndarray) -> int:
    return int(x.sum(dtype=U64))


STAR_QUERY = Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0)],
                   [FilterPred(1, 1, "<", 900)],
                   [Projection(0, 2), Projection(1, 1), Projection(2, 1)])


def _star_case(k1: np.ndarray, k2: np.ndarray, fv: np.ndarray,
               d1v: np.ndarray, d2v: np.ndarray) -> Case:
    """fact(k1, k2, fv) ⋈ dim1 ⋈ dim2 with unique dimension keys: a fact
    row joins one row of each dimension and lives iff dim1's passes."""
    live = (d1v < 900)[k1.astype(np.intp)]
    exp = [_u64_sum(fv[live]), _u64_sum(d1v[k1[live].astype(np.intp)]),
           _u64_sum(d2v[k2[live].astype(np.intp)])]
    del live
    keys = np.arange(len(d1v), dtype=U64)
    return Case([Relation([k1, k2, fv]), Relation([keys, d1v]),
                 Relation([keys, d2v])], STAR_QUERY,
                [" ".join(map(str, exp))])


def star(n: int, rng: np.random.Generator, n_keys: int = N_KEYS) -> Case:
    """The star of scripts/bench_scale.py:191-218 (and :220-246 with
    n_keys = 1024): uniform fact keys, values below 1000."""
    k1, k2, fv = (_vals(rng, n_keys, n), _vals(rng, n_keys, n),
                  _vals(rng, 1000, n))
    d1v = _vals(rng, 1000, n_keys)
    return _star_case(k1, k2, fv, d1v, _vals(rng, 1000, n_keys))


def star_big(n: int, rng: np.random.Generator, n_keys: int = N_KEYS) -> Case:
    """The star of scripts/bench_scale.py:315-371: a Zipf(1.1) first key,
    a uniform second key."""
    k1 = _zipf(rng, n, n_keys)
    k2, fv = _vals(rng, n_keys, n), _vals(rng, 1000, n)
    d1v = _vals(rng, 1000, n_keys)
    return _star_case(k1, k2, fv, d1v, _vals(rng, 1000, n_keys))


ZIPF_QUERY = Query([0, 1], [JoinPred(0, 0, 1, 0)],
                   [FilterPred(1, 1, "<", 900)],
                   [Projection(0, 1), Projection(1, 1)])


def zipf_join(n: int, rng: np.random.Generator,
              n_keys: int = N_KEYS) -> Case:
    """BASELINE config 4 (scripts/bench_scale.py:248-313): a Zipf(1.1)
    fact of n rows ⋈ a unique n_keys-row dimension, filtered; fact row r
    participates iff its key passes the dimension's filter."""
    zk = _zipf(rng, n, n_keys)
    pay = _vals(rng, 1000, n)
    dval = _vals(rng, 1000, n_keys)
    keep = dval < 900
    wk = keep[zk.astype(np.intp)]
    exp0 = _u64_sum(pay[wk])
    cnt = np.bincount(zk[wk].astype(np.intp), minlength=n_keys)
    exp1 = _u64_sum(dval * cnt.astype(U64) * keep)
    del wk, cnt
    return Case([Relation([zk, pay]),
                 Relation([np.arange(n_keys, dtype=U64), dval])],
                ZIPF_QUERY, [f"{exp0} {exp1}"])


CHAIN_QUERY = Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0)],
                    [FilterPred(2, 1, "<", 900)],
                    [Projection(0, 1), Projection(1, 2), Projection(2, 1)])


def chain(n: int, rng: np.random.Generator, n_keys: int = N_KEYS) -> Case:
    """The two-deep chain of scripts/bench_scale.py:373-441: fact1(k, v) ⋈
    fact2(a, b, v) ⋈ dim(key, v) on fact1.k = fact2.a and fact2.b =
    dim.key, n rows a fact. Past _BIG_WAVE_ROWS = 2^28 rows both facts
    are huge nodes, fact2 an interior one (exactly 2^28 rows is not past
    it). The closed form is the reference's bincount algebra: keep[k] the
    dimension filter, m1[k] fact1's rows with key k, w2[r] = m1[a_r] ·
    keep[b_r] fact2 row r's weight."""
    ck1, f1v = _vals(rng, n_keys, n), _vals(rng, 1000, n)
    ck2a, ck2b = _vals(rng, n_keys, n), _vals(rng, n_keys, n)
    f2v, dv = _vals(rng, 1000, n), _vals(rng, 1000, n_keys)
    keep = (dv < 900).astype(U64)
    m1 = np.bincount(ck1.astype(np.intp), minlength=n_keys).astype(U64)
    a = ck2a.astype(np.intp)
    m1a = m1[a]
    kb = keep[ck2b.astype(np.intp)]
    # fact2 rows passing the dimension's filter, by key a
    m2k = np.bincount(a[kb > 0], minlength=n_keys).astype(U64)
    e0 = _u64_sum(f1v * m2k[ck1.astype(np.intp)])
    e1 = _u64_sum(f2v * (m1a * kb))
    del kb
    m2b = np.bincount(ck2b.astype(np.intp), weights=m1a.astype(np.float64),
                      minlength=n_keys)
    del a, m1a
    # float64 weight sums are exact below 2^53
    if not m2b.max() < 2**53:
        raise AssertionError(f"chain oracle: a weight sum of {m2b.max()} "
                             f"is past float64's exact range")
    e2 = _u64_sum(dv * m2b.astype(U64) * keep)
    return Case([Relation([ck1, f1v]), Relation([ck2a, ck2b, f2v]),
                 Relation([np.arange(n_keys, dtype=U64), dv])],
                CHAIN_QUERY, [f"{e0} {e1} {e2}"])


def skew_join(n: int, gen: torch.Generator, n_keys: int = N_KEYS):
    """Zipf(1.1) left keys and uniform right keys, n each, on the
    generator's device; returns (left, right)."""
    return zipf_keys(gen, n, n_keys, gen.device), _randint(gen, n_keys, n)


def skew_expected(lvals: torch.Tensor, rvals: torch.Tensor):
    """(pairs, sum of matched left values mod 2^64 as a signed int), the
    NumPy count the distributed join must equal."""
    lv, rv = (v.cpu().numpy().astype(np.intp) for v in (lvals, rvals))
    cnt = np.bincount(rv, minlength=int(lv.max(initial=0)) + 1)[lv]
    total = _u64_sum(lv.astype(U64) * cnt.astype(U64))
    return int(cnt.sum()), total - (1 << 64) if total >= 1 << 63 else total


# ---- measurement ----

def plane_bytes(rows: int) -> int:
    """Bytes a row of a projection plane of values below 2^16 takes in the
    port's DeviceCatalog."""
    return 2 if rows > device_catalog._NARROW_PLANE_MIN_ROWS else 4


def roofline(bytes_min: int, seconds: Optional[float],
             dev: torch.device) -> dict:
    """The reference's roofline keys: the least bytes the program must
    move, the rate against them, and that rate's share of the card's
    published bandwidth."""
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if seconds is None:
        return {"bytes_min": int(bytes_min),
                "gbps_min_traffic": NOT_MEASURED,
                "pct_hbm_peak": NOT_MEASURED, "device_kind": kind}
    gbps = bytes_min / seconds / 1e9
    peak = hbm_bytes_per_s(dev)
    return {"bytes_min": int(bytes_min), "gbps_min_traffic": gbps,
            "pct_hbm_peak": 100 * gbps * 1e9 / peak if peak else None,
            "device_kind": kind}


def _rate(work: int, seconds: Optional[float]) -> dict:
    if seconds is None:
        return {"value": NOT_MEASURED, "unit": "tuples/s",
                "seconds": NOT_MEASURED}
    return {"value": work / seconds, "unit": "tuples/s", "seconds": seconds}


def _emit(out: TextIO, line: dict) -> dict:
    print(json.dumps(line), file=out, flush=True)
    return line


def run_probe(metric: str, probe: Probe, dev: torch.device, out: TextIO,
              work: int, **fields) -> dict:
    result, launches = kernels.counted(lambda: dense_probe(*probe.args()))
    total = check_probe(probe, result)
    del result
    seconds = None
    if dev.type == "cuda":
        seconds = time_ms(lambda: dense_probe(*probe.args()), ITERS) / 1e3
    return _emit(out, {"metric": metric, **fields, "output_pairs": total,
                       "pairs": probe.pairs, **_rate(work, seconds),
                       "launches": launches, "exact": True})


def run_engine(case: Case, config: EngineConfig, dev: torch.device):
    """The case's query through Engine.run_workload: held exact on each
    of WARMUP untimed runs, then ITERS timed runs on the card. Returns
    (lines, seconds a run or None off the card, counters, the launches of
    the first run)."""
    eng = Engine(case.rels, config, device=dev)
    for i in range(WARMUP if dev.type == "cuda" else 1):
        got, counts = kernels.counted(
            lambda: eng.run_workload([[case.query]]))
        if i == 0:
            launches = counts
        if got != case.expected:
            raise AssertionError(f"engine lines {got} != closed form "
                                 f"{case.expected}")
    seconds = None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        for _ in range(ITERS):
            got = eng.run_workload([[case.query]])   # ends in a readback
        seconds = (time.perf_counter() - t0) / ITERS
        if got != case.expected:
            raise AssertionError(f"timed run gave {got}")
    counters = dict(eng.batch_executor.counters)
    del eng
    free_memory(dev)
    return got, seconds, counters, launches


def free_memory(dev: torch.device) -> None:
    """Collect garbage and, on the card, return the allocator's cached
    blocks, so that the next config starts from its own peak."""
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _skew_rank(mesh, n: int, n_keys: int, timed: bool) -> dict:
    """One rank of the skew-aware join: every rank draws the same keys
    and takes its n // world rows of each side; the per-destination
    capacity doubles until nothing overflows; the global pairs and sum
    must equal the NumPy count over the ranks' rows."""
    import torch.distributed as dist

    from .parallel.dist_join import dist_join_skewaware
    gen = torch.Generator(device=mesh.device).manual_seed(SKEW_SEED)
    lz, rv = skew_join(n, gen, n_keys)
    per = n // mesh.size
    want = skew_expected(lz[:per * mesh.size], rv[:per * mesh.size])
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    lv, rvv = lz[rows].contiguous(), rv[rows].contiguous()
    cnt = torch.tensor(per, dtype=torch.int32, device=mesh.device)
    capacity = max(2 * per // mesh.size, 1024)

    def run():
        return dist_join_skewaware(mesh, lv, cnt, rvv, cnt,
                                   capacity=capacity, heavy_fraction=0.2)
    def until_no_overflow():
        nonlocal capacity
        while True:
            got = run()
            if got[2] == 0:
                return got
            capacity *= 2
    got, launches = kernels.counted(until_no_overflow)
    if tuple(got[:2]) != want:
        raise AssertionError(f"skew-aware join (pairs, sum) {got[:2]} != "
                             f"NumPy count {want}")
    seconds = None
    if timed:
        for _ in range(WARMUP - 1):
            run()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            got = run()                       # ends in a readback
        seconds = (time.perf_counter() - t0) / ITERS
    return {"pairs": got[0], "sum": got[1], "overflow": got[2],
            "capacity": capacity, "seconds": seconds,
            "backend": dist.get_backend(), "launches": launches}


def run_skew(n: int, n_devices: int, dev: torch.device) -> dict:
    """The skew-aware join on n_devices ranks: one in this process (a
    world of one, joined here unless one exists), else spawned ranks of
    dev's type. Rank 0's result."""
    from .parallel import multihost
    return multihost.run_world(_skew_rank, n_devices,
                               (n, N_KEYS, dev.type == "cuda"), device=dev,
                               timeout=900)


def main(argv: Optional[Sequence[str]] = None,
         out: TextIO = sys.stdout) -> int:
    p = argparse.ArgumentParser(
        prog="python -m radixhashjoin_tpu_torch.bench_scale",
        description="data-scale join benchmarks: one JSON line per config")
    p.add_argument("--rows", type=int, default=26,
                   help="log2 rows per side (default 2^26 = 67M)")
    p.add_argument("--devices", type=int, default=0,
                   help="ranks of the skew config (0 = the visible cards "
                        "on cuda, 1 on the CPU)")
    p.add_argument("--skew-rows", type=int, default=1 << 16,
                   help="rows for the skew-aware distributed config")
    p.add_argument("--impl", default="auto",
                   help="table kernels of the small-dim star join: auto | "
                        "onehot (the reference's xla and both are not "
                        "ported)")
    p.add_argument("--zipf-engine", action="store_true",
                   help="BASELINE config 4: Zipf(1.1) join + SUM through "
                        "the engine")
    p.add_argument("--zipf-only", action="store_true",
                   help="skip the probes and stars (implies --zipf-engine "
                        "unless --star-rows or --chain-rows is given)")
    p.add_argument("--zipf-rows", type=int, default=27,
                   help="log2 fact rows for --zipf-engine (default 134M)")
    p.add_argument("--star-rows", type=int, default=0,
                   help="log2 fact rows for the big STAR join config "
                        "(0 = skip)")
    p.add_argument("--wsort", default="auto", choices=["auto", "on", "off"],
                   help="ftree_window_sort of the big engine configs; every "
                        "value runs the port's one unsorted window pass")
    p.add_argument("--chain-rows", type=int, default=0,
                   help="log2 rows a fact for the big CHAIN config (fact1 "
                        "JOIN fact2 JOIN dim; 0 = skip). The huge-node pass "
                        "takes facts of more than 2^28 rows, so 28 does not "
                        "reach it: 29 does")
    p.add_argument("--skew", action="store_true",
                   help="also run the distributed skew-aware config")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    try:
        check_impl(args.impl)
        dev = resolve_device(args.device)
    except (NotImplementedError, RuntimeError) as e:
        print(f"bench_scale: {e}", file=sys.stderr)
        return 2
    if args.zipf_only:
        args.zipf_engine = args.zipf_engine or not (args.star_rows
                                                    or args.chain_rows)
    n = 1 << args.rows
    rng = np.random.default_rng(0)
    if not args.zipf_only:
        gen = torch.Generator(device=dev).manual_seed(PROBE_SEED)
        run_probe("dense_probe_uniform_tuples_per_s", dense_uniform(n, gen),
                  dev, out, 2 * n, rows_per_side=n)
        run_probe("dense_probe_fk_tuples_per_s", dense_fk(n, gen), dev, out,
                  n + N_KEYS, fact_rows=n, dim_rows=N_KEYS)
        run_probe("dense_probe_narrow_domain_tuples_per_s",
                  dense_narrow(n, gen), dev, out, n + NARROW_DOMAIN,
                  fact_rows=n, dim_rows=NARROW_DOMAIN, domain=NARROW_DOMAIN)
        free_memory(dev)
        nf = min(n, STAR_MAX_ROWS)
        for metric, n_keys, cfg in (
                ("star_join_engine_tuples_per_s", N_KEYS, {}),
                ("star_join_smalldim_engine_tuples_per_s", SMALL_DIM_KEYS,
                 {"ftree_scatter": args.impl, "ftree_gather": args.impl})):
            got, seconds, counters, launches = run_engine(
                star(nf, rng, n_keys), EngineConfig(**cfg), dev)
            extra = {"table_impl": args.impl} if cfg else {}
            _emit(out, {"metric": metric, "fact_rows": nf,
                        "dim_rows": n_keys, "n_joins": 2, **extra,
                        "factorized": counters["ftree_queries"] > 0,
                        **_rate(nf + 2 * n_keys, seconds),
                        "sums": got[0][:60], "launches": launches,
                        "exact": True})

    if args.zipf_engine:
        nz = 1 << args.zipf_rows
        case = zipf_join(nz, rng)
        keys = case.rels[0].values[0][:1 << 22]
        top = np.bincount(keys.astype(np.intp)).max() / len(keys)
        # the materializing path cross-checks while its pair matrix fits
        modes = (True, False) if args.zipf_rows <= 27 else (True,)
        for factorized in modes:
            got, seconds, _c, launches = run_engine(
                case, EngineConfig(factorized=factorized,
                                   ftree_window_sort=args.wsort), dev)
            line = {"metric": "zipf_join_engine_tuples_per_s", "rows": nz,
                    "zipf_s": 1.1, "n_keys": N_KEYS,
                    "hot_key_share": float(top), "factorized": factorized,
                    "wsort": args.wsort, "oracle_checked": True,
                    "cross_checked": len(modes) > 1,
                    **_rate(nz + N_KEYS, seconds), "sums": got[0][:60],
                    "launches": launches}
            if factorized:
                # one fused pass over the fact: the key and the plane
                line.update(fused_passes=1, **roofline(
                    nz * (4 + plane_bytes(nz)), seconds, dev))
            _emit(out, {**line, "exact": True})
        del case

    if args.star_rows:
        ns = 1 << args.star_rows
        got, seconds, counters, launches = run_engine(
            star_big(ns, rng), EngineConfig(ftree_window_sort=args.wsort),
            dev)
        # one fused pass: key1 + key2 + the plane a fact row
        _emit(out, {"metric": "star_join_big_engine_tuples_per_s",
                    "rows": ns, "zipf_s": 1.1, "n_keys": N_KEYS,
                    "n_joins": 2,
                    "factorized": counters["ftree_queries"] > 0,
                    "wsort": args.wsort, "oracle_checked": True,
                    **_rate(ns + 2 * N_KEYS, seconds), "sums": got[0][:80],
                    "fused_passes": 1,
                    **roofline(ns * (8 + plane_bytes(ns)), seconds, dev),
                    "launches": launches, "exact": True})

    if args.chain_rows:
        nc = 1 << args.chain_rows
        got, seconds, counters, launches = run_engine(
            chain(nc, rng), EngineConfig(ftree_window_sort=args.wsort), dev)
        _emit(out, {**chain_line(nc, got[0], seconds, dev,
                                 counters["ftree_queries"] > 0, args.wsort),
                    "launches": launches})

    if args.skew:
        ns = min(n, args.skew_rows)
        ndev = args.devices or (torch.cuda.device_count()
                                if dev.type == "cuda" else 1)
        r = run_skew(ns, ndev, dev)
        _emit(out, {"metric": "skewaware_dist_join_tuples_per_s",
                    "devices": ndev, "backend": r["backend"],
                    "rows_per_side": ns, "output_pairs": r["pairs"],
                    "sum": r["sum"], "overflow": r["overflow"],
                    "capacity": r["capacity"],
                    **_rate(2 * ns, r["seconds"]),
                    "launches": r["launches"], "exact": True})
    return 0


def chain_line(nc: int, sums: str, seconds: Optional[float],
               dev: torch.device, factorized: bool = True,
               wsort: str = "auto") -> dict:
    """The chain's line. Its roofline reads three window loops: fact2's
    up-pass build (key a + key b), fact1's down pass (key + plane) and
    fact2's (keys a, b + plane)."""
    p = plane_bytes(nc)
    return {"metric": "chain_join_big_engine_tuples_per_s",
            "rows_per_fact": nc, "n_keys": N_KEYS, "n_joins": 2,
            "factorized": factorized, "wsort": wsort,
            "oracle_checked": True, **_rate(2 * nc, seconds),
            "sums": sums[:80], "fused_passes": 3,
            **roofline(nc * (8 + (4 + p) + (8 + p)), seconds, dev),
            "exact": True}


if __name__ == "__main__":
    sys.exit(main())
