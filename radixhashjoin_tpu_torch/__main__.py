"""CLI entry: `python -m radixhashjoin_tpu_torch [--device cuda|cpu]
[--no-batch] [--mesh N] < init+work` — the reference binary's stdin
contract (counterpart: radixhashjoin_tpu/__main__.py).

The default device is cuda. Without a card the CLI exits non-zero; it
runs on the CPU (the plain PyTorch versions of the kernels) only when
asked with --device cpu. --no-batch runs every query through the
per-query executor (models/executor.py), which answers every query
shape; the default wave-batched path runs queries that factorize.
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
    p.add_argument("--no-batch", action="store_true",
                   help="execute queries one at a time (the per-query "
                        "executor)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="execute distributed over N ranks (one process per "
                        "device)")
    args = p.parse_args()
    config = EngineConfig(batch_execution=not args.no_batch,
                          mesh_devices=args.mesh)
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
    main(config=config, device=device)


if __name__ == "__main__":
    cli()
