"""CLI entry: `python -m radixhashjoin_tpu_torch [--device cuda|cpu]
[--backend auto|dense|sort] [--oracle] [--reorder-joins] [--no-native]
[--profile] [--mesh N] < init+work` — the reference binary's stdin
contract (counterpart: radixhashjoin_tpu/__main__.py, less its
--no-batch: the wave-batched executor answers every query shape, and
--backend sort gives the materializing sort join).

The default device is cuda. Without a card the CLI exits non-zero; it
runs on the CPU (the plain PyTorch versions of the kernels) only when
asked with --device cpu. --oracle answers with the NumPy oracle,
--reorder-joins turns on the stats-driven join order, --no-native loads
and parses in Python instead of the C++ host runtime, and --profile
prints the batch executor's per-operator table to stderr after the run.
--mesh N runs the distributed executor on N ranks, one process per
device (parallel/worker.py): N cards, or N gloo ranks with --device cpu.
"""

from __future__ import annotations

import argparse
import sys

from .config import EngineConfig
from .models.engine import main, resolve_device


def cli() -> None:
    p = argparse.ArgumentParser(
        prog="radixhashjoin_tpu_torch",
        description="PyTorch + CUDA vectorized query engine "
                    "(SIGMOD-2018-contest stream protocol on stdin)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device the engine runs on (default: cuda)")
    p.add_argument("--backend", choices=["auto", "dense", "sort"],
                   default="auto", help="equi-join backend")
    p.add_argument("--oracle", action="store_true",
                   help="force the NumPy oracle executor")
    p.add_argument("--reorder-joins", action="store_true",
                   help="enable the stats-driven join-order planner")
    p.add_argument("--no-native", action="store_true",
                   help="disable the C++ host runtime")
    p.add_argument("--profile", action="store_true",
                   help="print per-operator roofline table to stderr")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="execute distributed over N ranks (one process per "
                        "device)")
    args = p.parse_args()
    config = EngineConfig(
        join_backend=args.backend,
        force_oracle=args.oracle,
        enable_join_reordering=args.reorder_joins,
        use_native_runtime=not args.no_native,
        profile=args.profile,
        mesh_devices=args.mesh,
    )
    try:
        device = resolve_device(args.device)
        if args.mesh:
            from .parallel.multihost import check_devices
            check_devices(args.mesh, args.device)
    except RuntimeError as e:
        print(f"radixhashjoin_tpu_torch: {e}", file=sys.stderr)
        raise SystemExit(2)
    if args.mesh:
        from .parallel.worker import run_cli
        run_cli(args.mesh, config, args.device)
        return
    engine = main(config=config, device=device)
    if args.profile:
        sys.stdout.flush()
        print(engine.batch_executor.profiler.report(), file=sys.stderr)


if __name__ == "__main__":
    cli()
