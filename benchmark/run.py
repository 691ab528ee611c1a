"""Run one cell of BENCHMARK.json once, on one NVIDIA card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

The last line of standard output is the result's JSON object (with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics); the line before it is the run's own record (route,
set-up split, counters). Each number compared with the reference is
printed beside its limit as the last lines of standard error and under
the result's last key, "checks". Without a CUDA card, with a module of
jax, jaxlib, flax or the JAX package loaded after the window, or without
the program beside the benchmark, the run prints no result and exits 1.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the program
    builds its csrc/ libraries into radixhashjoin_tpu_torch/build/)."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    from benchmark.harness import forbidden_modules, run_cell
    from benchmark.spec import Cell, load_benchmark
    cell = Cell(load_benchmark(ROOT), args.workload, ROOT)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    try:
        import radixhashjoin_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 1
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 1
    info = result.pop("info")
    print(json.dumps(info), flush=True)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
