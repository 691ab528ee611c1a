"""Kernel shootout of the port (counterpart: scripts/bench_kernels.py):
one JSON line per measurement, the same measurements and metric names.

    python -m radixhashjoin_tpu_torch.bench_kernels [--log-rows 23]
    python -m radixhashjoin_tpu_torch.bench_kernels --device cpu --log-rows 12

On the card it measures, at n = 2**log_rows rows over a 2**18 domain:

  xla_gather_gbps                  the lookup kernel (csrc/tables.cu)
  xla_scatter_add_gbps             the build kernel, unit weights
  pallas_radix_histogram_tuples_per_s
                                   the radix histogram kernel
                                   (csrc/radix.cu), 256 bins
  dense_probe_tuples_per_s         ops/join_dense.dense_probe (build +
                                   two lookups on the kernels)
  sort_probe_tuples_per_s          ops/join.probe_gather_count (a
                                   torch.sort of the right side, the
                                   probe kernel of csrc/probe.cu)
  pallas_partition_tuples_per_s    ops/partition.partition_order, 256
                                   digits (the rank kernel), with the
                                   rank kernel alone (257 bins), the
                                   18-bit radix sort (9-bit digits) and
                                   torch.sort(stable=True) beside it

The metric names are the reference script's, so its lines and these
compare one to one; a key named after XLA holds the rate of the port's
plain PyTorch version of the same function, the counterpart of XLA's.
Every cell first asserts that the kernel's result equals its plain
version's (the two probes equal each other; the partition and the radix
sort equal torch.sort(stable=True)), then times each side with CUDA
events: `WARMUP` untimed calls, then `iters` calls between two events,
reported as the mean. A mean below the event timer's resolution prints
"below_floor": true and no rate.

On the CPU (--device cpu) the kernels' plain versions run and every
exactness check runs, but nothing is timed: the lines say
"not measured". Without a card the default device cuda exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Optional, Sequence, TextIO

import torch

from .models.engine import resolve_device
from .ops.join import probe_gather_count
from .ops.join_dense import dense_probe
from .ops.partition import (partition_order, radix_sort_order,
                            rank_and_hist, rank_and_hist_torch)
from .ops.radix_hist import radix_histogram, radix_histogram_torch
from .ops.tables import (scatter_table, table_gather, table_gather_torch,
                         weighted_bincount_torch)

# cudaEventElapsedTime's resolution is about half a microsecond
EVENT_RESOLUTION_MS = 0.0005
WARMUP = 3
DOMAIN = 1 << 18


def time_ms(fn: Callable[[], object], iters: int = 10,
            warmup: int = WARMUP) -> float:
    """Mean milliseconds per call on the current CUDA stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _equal(name: str, got, want) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel result differs from its "
                             f"plain version")


class _Bench:
    def __init__(self, dev: torch.device, n: int, out: TextIO):
        self.dev, self.n, self.out = dev, n, out
        self.on_card = dev.type == "cuda"
        self.head = {"platform": "gpu" if self.on_card else "cpu",
                     "device": (torch.cuda.get_device_name(dev)
                                if self.on_card else "cpu"),
                     "rows": n}

    def ms(self, fn, iters: int) -> Optional[float]:
        return time_ms(fn, iters) if self.on_card else None

    @staticmethod
    def rate(work: float, ms: Optional[float], scale: float = 1.0):
        """work / second, scaled; None when not measured or below the
        timer's resolution."""
        if ms is None or ms < EVENT_RESOLUTION_MS:
            return None
        return work / (ms / 1e3) / scale

    def emit(self, metric: str, unit: str, ms: Optional[float],
             value, **extra) -> None:
        """One line; `extra` holds the side rates and times, left out
        when nothing was timed (a CPU run)."""
        line = {"metric": metric, **self.head, "unit": unit, "exact": True}
        if ms is None:
            line["value"] = "not measured"
        else:
            if value is None:
                line["below_floor"] = True
            else:
                line["value"] = value
            line["ms"] = ms
            line.update(extra)
        print(json.dumps(line), file=self.out, flush=True)


def run(dev: torch.device, log_rows: int, out: TextIO = sys.stdout) -> None:
    n = 1 << log_rows
    b = _Bench(dev, n, out)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device=dev,
                             dtype=torch.int32)

    table = randint(1000, DOMAIN)
    idx = randint(DOMAIN, n)
    ones = torch.ones(n, dtype=torch.int32, device=dev)

    # gather (column lookup)
    _equal("gather", table_gather(table, idx), table_gather_torch(table,
                                                                  idx))
    ms = b.ms(lambda: table_gather(table, idx), 10)
    plain = b.ms(lambda: table_gather_torch(table, idx), 10)
    b.emit("xla_gather_gbps", "GB/s", ms, b.rate(n * 4, ms, 1e9),
           plain_gbps=b.rate(n * 4, plain, 1e9), plain_ms=plain)

    # scatter-add (dense hash build)
    _equal("scatter_add", scatter_table(idx, ones, DOMAIN),
           weighted_bincount_torch(idx, ones, DOMAIN))
    ms = b.ms(lambda: scatter_table(idx, ones, DOMAIN), 10)
    plain = b.ms(lambda: weighted_bincount_torch(idx, ones, DOMAIN), 10)
    b.emit("xla_scatter_add_gbps", "GB/s", ms, b.rate(n * 4, ms, 1e9),
           plain_gbps=b.rate(n * 4, plain, 1e9), plain_ms=plain)

    # radix histogram: kernel vs its plain version
    _equal("radix_histogram", radix_histogram(idx, n, 256),
           radix_histogram_torch(idx, n, 256))
    ms = b.ms(lambda: radix_histogram(idx, n, 256), 10)
    plain = b.ms(lambda: radix_histogram_torch(idx, n, 256), 10)
    b.emit("pallas_radix_histogram_tuples_per_s", "tuples/s", ms,
           b.rate(n, ms), xla_bincount_tuples_per_s=b.rate(n, plain),
           plain_ms=plain)

    # join probes: the dense probe (build + lookups on the kernels) and
    # the sort probe compute the same five outputs
    rv = randint(DOMAIN, n)
    rows = torch.arange(n, dtype=torch.int32, device=dev)

    def sort_probe():
        return probe_gather_count(idx, rows, n, rv, rows, n)
    dense = dense_probe(idx, n, rv, n, DOMAIN)
    for name, got, want in zip(("order", "lo", "offsets", "cum", "total"),
                               dense, sort_probe()):
        _equal(f"dense_probe {name} vs sort probe", got, want)
    del dense
    ms = b.ms(lambda: dense_probe(idx, n, rv, n, DOMAIN), 10)
    b.emit("dense_probe_tuples_per_s", "tuples/s", ms, b.rate(2 * n, ms))
    ms = b.ms(sort_probe, 10)
    b.emit("sort_probe_tuples_per_s", "tuples/s", ms, b.rate(2 * n, ms))
    del rv

    # one-pass partition + 18-bit radix sort vs torch.sort(stable=True)
    digits = randint(256, n)
    order, hist = partition_order(digits, 256)
    _equal("partition_order", order,
           torch.sort(digits, stable=True).indices.to(torch.int32))
    _equal("partition hist", hist[:256],
           torch.bincount(digits, minlength=256).to(torch.int32))
    _equal("radix_sort_order", radix_sort_order(idx, 18, 9),
           torch.sort(idx, stable=True).indices.to(torch.int32))
    for got, want in zip(rank_and_hist(digits, 257),
                         rank_and_hist_torch(digits, 257)):
        _equal("rank_and_hist", got, want)
    ms = b.ms(lambda: partition_order(digits, 256), 5)
    ms_rank = b.ms(lambda: rank_and_hist(digits, 257), 10)
    ms_radix = b.ms(lambda: radix_sort_order(idx, 18, 9), 5)
    ms_sort = b.ms(lambda: torch.sort(idx, stable=True), 10)
    b.emit("pallas_partition_tuples_per_s", "tuples/s", ms, b.rate(n, ms),
           rank_hist_tuples_per_s=b.rate(n, ms_rank), rank_hist_ms=ms_rank,
           radix_sort_18bit_tuples_per_s=b.rate(n, ms_radix),
           radix_sort_ms=ms_radix,
           xla_argsort_tuples_per_s=b.rate(n, ms_sort), argsort_ms=ms_sort)


def main(argv: Optional[Sequence[str]] = None,
         out: TextIO = sys.stdout) -> int:
    p = argparse.ArgumentParser(
        prog="python -m radixhashjoin_tpu_torch.bench_kernels",
        description="kernel shootout: one JSON line per measurement")
    p.add_argument("--log-rows", type=int, default=23)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_kernels: {e}", file=sys.stderr)
        return 2
    run(dev, args.log_rows, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
