"""CLI entry: `python -m radixhashjoin_tpu_torch [--device cuda|cpu]
[--no-batch] < init+work` — the reference binary's stdin contract
(counterpart: radixhashjoin_tpu/__main__.py).

The default device is cuda. Without a card the CLI exits non-zero; it
runs on the CPU (the plain PyTorch versions of the kernels) only when
asked with --device cpu. --no-batch runs every query through the
per-query executor (models/executor.py), which answers every query
shape; the default wave-batched path runs queries that factorize.
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
    args = p.parse_args()
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"radixhashjoin_tpu_torch: {e}", file=sys.stderr)
        raise SystemExit(2)
    main(config=EngineConfig(batch_execution=not args.no_batch),
         device=device)


if __name__ == "__main__":
    cli()
