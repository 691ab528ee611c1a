"""The engine's primitive ops timed at the golden workload's padded shapes
(counterpart: scripts/bench_microops.py). One JSON line per op and size.

    python -m radixhashjoin_tpu_torch.bench_microops
    python -m radixhashjoin_tpu_torch.bench_microops --device cpu

At n = 8192 and 65536 int32 keys over a 131072-value domain (from a
torch.Generator on the target device, where the reference draws them
with jax.random): argsort, sort, the domain scatter-add (ops/tables.py
scatter_table: the build kernel of csrc/tables.cu), cumsums over the
domain and over n, the domain gather (ops/tables.py table_gather: the
lookup kernel), a filter mask with its cumsum, ops/join_dense
dense_probe (a self-join, n - 7 live rows a side) and dense_expand of
its first n pairs. A kernel's line names the plain PyTorch call of its
plain version and times that beside it.

Every op with a counterpart is held exact before timing: each kernel
against its plain version, dense_probe against the sort probe
(ops/join.py probe_count), dense_expand against a NumPy expansion. On
the card each op is timed by CUDA events (bench_kernels time_ms: WARMUP
untimed calls, then REPS) and printed in microseconds; on the CPU
(--device cpu) the checks run on the plain versions and nothing is
timed: the lines say "not measured". Without a card the default device
cuda exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence, TextIO

import numpy as np
import torch

from .bench_kernels import time_ms
from .models.engine import resolve_device
from .ops.join import probe_count
from .ops.join_dense import dense_expand, dense_probe
from .ops.tables import (scatter_table, table_gather, table_gather_torch,
                         weighted_bincount_torch)

DOMAIN = 131072
SIZES = (8192, 65536)
DEAD = 7                      # padded lanes of the probe's sides
REPS = 20
SEED = 0


def keys(n: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, DOMAIN, (n,), generator=gen, device=gen.device,
                         dtype=torch.int32)


def probe_and_expand(v: torch.Tensor):
    """dense_probe of v against itself with n - DEAD live rows a side, and
    dense_expand of its first n pairs: (probe outputs, (left, right))."""
    n = v.shape[0]
    cnt = torch.tensor(n - DEAD, dtype=torch.int32, device=v.device)
    pr = dense_probe(v, cnt, v, cnt, DOMAIN)
    return pr, dense_expand(*pr[:4], n)


def expand_numpy(v: np.ndarray, live: int, out_size: int):
    """The first out_size pairs of the self-join of v[:live] in the
    probe's order (by left row, then by right row in stable value order),
    with NumPy: (left, right) int32. Lanes past the pair total repeat the
    last pair's owner with a clipped right row, as dense_expand's do."""
    lv = v[:live].astype(np.int64)
    per_value = np.bincount(lv, minlength=DOMAIN)
    counts = per_value[lv]
    cum = np.cumsum(counts)
    k = np.arange(out_size)
    owner = np.searchsorted(cum, np.minimum(k, cum[-1] - 1), side="right")
    first = np.cumsum(per_value) - per_value          # value -> sorted start
    pos = first[lv[owner]] + k - (cum - counts)[owner]
    order = np.argsort(np.where(np.arange(len(v)) < live, v, DOMAIN),
                       kind="stable")
    return (owner.astype(np.int32),
            order[np.clip(pos, 0, len(v) - 1)].astype(np.int32))


def _equal(name, got, want) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: result differs from its plain "
                             f"version")


def run(dev: torch.device, out: TextIO = sys.stdout) -> None:
    on_card = dev.type == "cuda"
    head = {"metric": "microop_us",
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu"}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def us(fn) -> object:
        return time_ms(fn, REPS) * 1e3 if on_card else "not measured"

    for n in SIZES:
        v = keys(n, gen)
        ones = torch.ones(n, dtype=torch.int32, device=dev)
        tbl = torch.zeros(DOMAIN, dtype=torch.int32, device=dev)
        _equal("scatter_add_domain", scatter_table(v, ones, DOMAIN),
               weighted_bincount_torch(v, ones, DOMAIN))
        _equal("gather_domain", table_gather(tbl, v),
               table_gather_torch(tbl, v))
        pr, (li, ri) = probe_and_expand(v)
        cnt = torch.tensor(n - DEAD, dtype=torch.int32, device=dev)
        for name, got, want in zip(("order", "lo", "offsets", "cum",
                                    "total"), pr,
                                   probe_count(v, cnt, v, cnt)):
            _equal(f"dense_probe {name} vs the sort probe", got, want)
        want_l, want_r = expand_numpy(v.cpu().numpy(), n - DEAD, n)
        _equal("dense_expand left", li.cpu(), torch.from_numpy(want_l))
        _equal("dense_expand right", ri.cpu(), torch.from_numpy(want_r))

        def filt():
            m = v < 1000
            return torch.cumsum(m.to(torch.int32), 0), m
        rows = [
            ("argsort", us(lambda: torch.argsort(v)), {}),
            ("sort", us(lambda: torch.sort(v)), {}),
            ("scatter_add_domain",
             us(lambda: scatter_table(v, ones, DOMAIN)),
             {"kernel": "csrc/tables.cu rhj_weighted_bincount",
              "exact": True, "plain_call": "index_add_",
              "plain_us": us(lambda: weighted_bincount_torch(v, ones,
                                                             DOMAIN))}),
            ("cumsum_domain", us(lambda: torch.cumsum(tbl, 0)), {}),
            ("cumsum_n", us(lambda: torch.cumsum(v, 0)), {}),
            ("gather_domain", us(lambda: table_gather(tbl, v)),
             {"kernel": "csrc/tables.cu rhj_table_gather",
              "exact": True, "plain_call": "index_select",
              "plain_us": us(lambda: table_gather_torch(tbl, v))}),
            ("filter_mask_cumsum", us(filt), {}),
            ("dense_probe", us(lambda: dense_probe(v, cnt, v, cnt, DOMAIN)),
             {"exact": True}),
            ("dense_expand", us(lambda: dense_expand(*pr[:4], n)),
             {"exact": True}),
        ]
        for name, value, extra in rows:
            print(json.dumps({**head, "op": name, "n": n, "value": value,
                              **extra}), file=out, flush=True)


def main(argv: Optional[Sequence[str]] = None,
         out: TextIO = sys.stdout) -> int:
    p = argparse.ArgumentParser(
        prog="python -m radixhashjoin_tpu_torch.bench_microops",
        description="primitive ops at the golden workload's shapes: one "
                    "JSON line per op and size")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_microops: {e}", file=sys.stderr)
        return 2
    run(dev, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
