"""The control of `correct`: the cell's own reference (`cell.reference`,
reference/semantics.py unless its configuration names another) with its
SUMs accumulated in float32 instead of exact 64-bit integers, which
breaks the exactness the configurations state, put in the program's
place and run through the harness at a cell's own size.

    python3 -m benchmark.control --workload <name> --seeds <a,b,c>
                                 [--seconds <s>]

Prints one JSON line a seed with its checks; every seed has to come out
not correct (PERF.md gives the readings). The benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import torch

from .harness import run_cell
from .spec import ROOT, Cell, load_benchmark


class Control:
    """An engine whose answers are `reference`'s, summed in float32."""

    def __init__(self, reference, relations, device):
        self.ref = reference([rel.values for rel in relations], device,
                             sum_dtype=torch.float32)

    def run_batch(self, batch):
        return self.ref.lines([q.text for q in batch])


def control(cell: Cell):
    """The `engine_factory` of `run_cell` that puts the cell's control in
    the program's place."""
    return functools.partial(Control, cell.reference)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None,
                   help="window length (default: the benchmark's)")
    args = p.parse_args(argv)
    bench = load_benchmark(ROOT)
    cell = Cell(bench, args.workload, ROOT)
    seconds = args.seconds or bench["run_seconds"]
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(cell, seed, seconds, False, dev, time.perf_counter(),
                     engine_factory=control(cell))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
