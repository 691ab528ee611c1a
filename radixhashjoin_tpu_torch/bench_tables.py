"""Build and lookup kernels of csrc/tables.cu on the card, at the shapes
the main path gives them (counterpart of scripts/bench_tables.py and
scripts/bench_gather.py, the JAX package's message-table shootouts; the
JAX package's other table variants are not ported, ops/tables.py).

    python -m radixhashjoin_tpu_torch.bench_tables [--log-rows 26]

For each case, one JSON line: the kernel first held element-exact
(torch.equal) against its plain version, then CUDA-event means (WARMUP
untimed calls, then `iters` calls) of the kernel (`ms`), the plain
version (`plain_ms`) and one PyTorch library call that computes the same
function on the same inputs (`library_ms`: `index_add_` on indices whose
out-of-range rows were sent to a spare bin before timing; the faster of
`index_select` and `torch.take` on keys clamped before timing), and
`bound_ms`: the bytes the function must move (each input read once, each
output written once) over the card's 3.35 TB/s. A lookup line also gives
`sector_gbps`: one 32-byte L2 sector per key over `ms`, the L2-to-SM
traffic of its random table reads, which bounds a table that lives in
L2 when it exceeds the DRAM bound. The fused double lookup (`gather2`)
reads a table of interleaved pairs; its library calls are one
`index_select` of the pairs' rows and two `index_select`s of the two
tables, and it also gives `two_gathers_ms`, two launches of the lookup
kernel on the same keys.

Needs one CUDA card; without one it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Iterator, List, Optional, Sequence, TextIO

import torch

from . import kernels
from .bench_kernels import time_ms
from .ops.tables import (table_gather2_torch, table_gather_torch,
                         weighted_bincount_torch)

HBM_BYTES_PER_S = 3.35e12
SECTOR_BYTES = 32
SMEM_BINS = 48 * 1024        # csrc/tables.cu kSmemMaxBins
CACHE_SLOTS = 8192           # csrc/tables.cu kSlots
ITERS = 20
LOG_ROWS = 26


def zipf_keys(gen: torch.Generator, n: int, n_keys: int,
              device: torch.device, s: float = 1.1) -> torch.Tensor:
    """Inverse-CDF power law over [0, n_keys), the scripts/bench_scale.py
    generator: rank ~ u^(-1/(s-1)), clipped to the last key (a quarter of
    the rows at s = 1.1 and 2^20 keys)."""
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    r = torch.clamp(u.clamp_min(1e-30) ** (-1.0 / (s - 1.0)),
                    max=n_keys - 1)
    return r.to(torch.int32)


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def build_cases(dev: torch.device, gen: torch.Generator,
                log_rows: int = LOG_ROWS) -> Iterator[dict]:
    """The build's timed shapes, one at a time (at log_rows 26 each holds
    up to 512 MB): a message table of 2^26 clipped-Zipf(1.1) rows into
    2^20 bins with ~10% rows on the mask sentinel and a few -1s (weights
    < 100 keep the hot bin below 2^31), the same with uniform keys, and
    2^24 rows into the 1024-bin probe table, into the mid-size tables of
    which three (16K bins) and two (24K) blocks fit an SM, and into tables
    at the shared-memory limit."""
    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    n, bins = 1 << log_rows, 1 << 20
    idx = zipf_keys(gen, n, bins, dev)
    sent = torch.rand(n, generator=gen, device=dev) < 0.1
    idx = torch.where(sent, bins, idx)
    idx[:: 1 << (log_rows - 4)] = -1
    w = randint(0, 100, n)
    del sent
    yield {"label": f"zipf1.1 n=2^{log_rows} bins=2^20", "main": True,
           "args": (idx, w, bins)}
    idx = randint(0, bins, n)
    yield {"label": f"uniform n=2^{log_rows} bins=2^20",
           "args": (idx, w, bins)}
    del idx, w
    n = 1 << (log_rows - 2)
    w = randint(0, 1000, n)
    for label, keys, bins in (
            ("uniform", randint(0, 1024, n), 1024),
            ("uniform", randint(0, 16 * 1024, n), 16 * 1024),
            ("uniform", randint(0, 24 * 1024, n), 24 * 1024),
            ("uniform", randint(0, SMEM_BINS, n), SMEM_BINS),
            ("zipf1.1", zipf_keys(gen, n, SMEM_BINS, dev), SMEM_BINS)):
        yield {"label": f"{label} n=2^{log_rows - 2} bins={bins}",
               "args": (keys, w, bins)}


def gather_cases(dev: torch.device, gen: torch.Generator,
                 log_rows: int = LOG_ROWS) -> Iterator[dict]:
    """The lookup's timed shapes: 2^26 unsorted keys (a few out of range)
    into a 2^20-entry table (the main path's), a 2^18-entry table (the L2
    random-read rate: the table fits L2 and the keys stream), a table at
    the shared-memory limit and the 1024-entry probe table; 2^24 sorted
    keys into 2^20."""
    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    n = 1 << log_rows
    for bins, main in ((1 << 20, True), (1 << 18, False),
                       (SMEM_BINS, False), (1024, False)):
        table = randint(-2**31, 2**31 - 1, bins)
        keys = randint(-1000, bins + 1000, n)
        log = bins.bit_length() - 1
        shown = f"2^{log}" if bins == 1 << log else str(bins)
        yield {"label": f"unsorted n=2^{log_rows} bins={shown}",
               "main": main,
               "args": (table, keys)}
    del keys
    table = randint(-2**31, 2**31 - 1, 1 << 20)
    keys = torch.sort(randint(0, 1 << 20, 1 << (log_rows - 2))).values
    yield {"label": f"sorted n=2^{log_rows - 2} bins=2^20",
           "args": (table, keys)}


def gather2_cases(dev: torch.device, gen: torch.Generator,
                  log_rows: int = LOG_ROWS) -> Iterator[dict]:
    """The fused double lookup at the main lookup's shape: 2^26 unsorted
    keys (a few out of range) into two 2^20-entry tables, interleaved as
    the dense probe builds them (int32[2^20, 2])."""
    bins, n = 1 << 20, 1 << log_rows
    pairs = torch.randint(-2**31, 2**31 - 1, (bins, 2), generator=gen,
                          device=dev, dtype=torch.int32)
    keys = torch.randint(-1000, bins + 1000, (n,), generator=gen,
                         device=dev, dtype=torch.int32)
    yield {"label": f"unsorted n=2^{log_rows} bins=2^20", "main": True,
           "args": (pairs, keys)}


def _flat(x) -> torch.Tensor:
    """A result as one tensor (a pair of lookups concatenated)."""
    return torch.cat(x) if isinstance(x, tuple) else x


def _bincount_library(idx, w, n_bins) -> Callable[[], torch.Tensor]:
    spare = torch.where((idx >= 0) & (idx < n_bins), idx, n_bins)

    def call():
        return torch.zeros(n_bins + 1, dtype=torch.int32,
                           device=idx.device).index_add_(0, spare, w)
    return call


def _gather_library(table, keys) -> Dict[str, Callable[[], torch.Tensor]]:
    clamped = keys.clamp(0, table.shape[0] - 1)
    wide = clamped.long()                  # torch.take takes int64 only
    return {"index_select": lambda: table.index_select(0, clamped),
            "take": lambda: torch.take(table, wide)}


def measure(kind: str, case: dict, iters: int = ITERS) -> dict:
    """Exactness, then the timings of one case (see the module doc)."""
    args = case["args"]
    if kind == "bincount":
        idx, w, bins = args

        def kernel():
            return kernels.weighted_bincount_cuda(idx, w, bins)

        def plain():
            return weighted_bincount_torch(idx, w, bins)
        library = {"index_add_": _bincount_library(idx, w, bins)}
        n_bytes = idx.numel() * 8 + bins * 4
    elif kind == "gather2":
        pairs, keys = args
        ta, tb = (pairs[:, c].contiguous() for c in (0, 1))

        def kernel():
            return kernels.table_gather2_cuda(pairs, keys)

        def plain():
            return table_gather2_torch(ta, tb, keys)
        rows = _gather_library(pairs, keys)["index_select"]
        ca, cb = (_gather_library(t, keys)["index_select"] for t in (ta, tb))
        library = {"index_select_rows": rows,
                   "index_select_x2": lambda: (ca(), cb())}
        n = keys.numel()
        n_bytes = n * 12 + 2 * min(ta.numel(), n) * 4
    else:
        table, keys = args

        def kernel():
            return kernels.table_gather_cuda(table, keys)

        def plain():
            return table_gather_torch(table, keys)
        library = _gather_library(table, keys)
        n = keys.numel()
        n_bytes = n * 8 + min(table.numel(), n) * 4
    want = _flat(plain())
    got = _flat(kernel())
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{kind} {case['label']}: kernel != plain "
                             f"(max abs err {err})")
    row = {"kernel": kind, "case": case["label"], "exact": True,
           "max_abs_err": err, "ms": time_ms(kernel, iters),
           "plain_ms": time_ms(plain, iters)}
    lib_ms = {name: time_ms(fn, iters) for name, fn in library.items()}
    row["library_call"] = min(lib_ms, key=lib_ms.get)
    row["library_ms"] = lib_ms[row["library_call"]]
    if len(lib_ms) > 1:
        row["library_ms_each"] = lib_ms
    row["bound_ms"] = bound_ms(n_bytes)
    row["bound_by"] = "bytes"
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    if kind == "gather":
        row["sector_gbps"] = keys.numel() * SECTOR_BYTES / row["ms"] / 1e6
    if kind == "gather2":
        row["two_gathers_ms"] = time_ms(
            lambda: (kernels.table_gather_cuda(ta, keys),
                     kernels.table_gather_cuda(tb, keys)), iters)
    return row


def run(dev: torch.device, out: Optional[TextIO] = sys.stdout,
        log_rows: int = LOG_ROWS) -> List[dict]:
    """Every case of both kernels; returns the rows (also printed)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for kind, cases in (("bincount", build_cases(dev, gen, log_rows)),
                        ("gather", gather_cases(dev, gen, log_rows)),
                        ("gather2", gather2_cases(dev, gen, log_rows))):
        for case in cases:
            row = measure(kind, case)
            row["main"] = bool(case.get("main"))
            rows.append(row)
            if out is not None:
                print(json.dumps(row), file=out, flush=True)
            del case
    return rows


def main(argv: Optional[Sequence[str]] = None,
         out: TextIO = sys.stdout) -> int:
    p = argparse.ArgumentParser(
        prog="python -m radixhashjoin_tpu_torch.bench_tables",
        description="build and lookup kernels on the card: one JSON line "
                    "per case")
    p.add_argument("--log-rows", type=int, default=LOG_ROWS,
                   help="rows of the largest cases (others: 4x fewer)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_tables: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    built = kernels.build()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "build_seconds": built["seconds"],
                      "ptxas": [ln.strip() for ln in built["log"].splitlines()
                                if "Used" in ln or "spill" in ln]}),
          file=out, flush=True)
    run(dev, out, args.log_rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
