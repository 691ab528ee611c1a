"""One rank of a distributed CLI run (counterpart:
scripts/multihost_worker.py and the --mesh path of
radixhashjoin_tpu/__main__.py).

`python -m radixhashjoin_tpu_torch --mesh N [--device cpu]` starts the N
ranks itself: this process is rank 0, and it spawns ranks 1..N-1 on a
free local port. Under torchrun (`torchrun --nproc-per-node N -m
radixhashjoin_tpu_torch --mesh N`) every process joins the world from
torchrun's environment instead. Either way, rank 0 reads the stdin
stream (relation paths, `Done`, query batches) and broadcasts the parsed
workload; every rank loads the relations and keeps its row shard; rank 0
alone prints the result lines.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, TextIO

from ..config import EngineConfig
from ..models.engine import Engine
from ..workload import parse_init_stream, parse_work_stream
from . import multihost
from .mesh import Mesh, make_mesh

# how long rank 0 waits for the other ranks to finish after its own run
JOIN_TIMEOUT_S = 600


def serve(mesh: Mesh, config: EngineConfig, stdin: Optional[TextIO] = None,
          stdout: Optional[TextIO] = None) -> Engine:
    """This rank's part of one CLI run; only rank 0 reads `stdin` and
    writes `stdout`. Returns the rank's engine."""
    payload = None
    if mesh.rank == 0:
        stdin = stdin or sys.stdin
        paths = parse_init_stream(stdin)
        try:
            payload = (paths, parse_work_stream(stdin))
        except (ValueError, IndexError) as e:
            payload = f"malformed work stream: {e}"
    payload = mesh.broadcast_object(payload)
    if isinstance(payload, str):
        print(f"radixhashjoin_tpu_torch: {payload}", file=sys.stderr)
        raise SystemExit(1)
    paths, batches = payload
    try:
        engine = Engine.from_paths(paths, config, mesh=mesh)
    except (OSError, AssertionError) as e:
        print(f"radixhashjoin_tpu_torch: cannot load relations: {e}",
              file=sys.stderr)
        raise SystemExit(1)
    lines = engine.run_workload(batches)
    if mesh.rank == 0:
        out = stdout or sys.stdout
        for line in lines:
            out.write(line + "\n")
        out.flush()
    return engine


def _spawned_rank(mesh: Mesh, config: EngineConfig) -> None:
    serve(mesh, config)


def run_cli(n: int, config: EngineConfig, device: str = "cuda") -> None:
    """The CLI's --mesh N: join (torchrun) or start an N-rank world, and
    serve this rank's part."""
    if "WORLD_SIZE" in os.environ:
        multihost.init_multihost(device=device)
        try:
            serve(make_mesh(n), config)
        finally:
            multihost.shutdown()
        return
    addr = f"127.0.0.1:{multihost.free_port()}"
    procs, results = multihost.start_ranks(
        _spawned_rank, n, range(1, n), addr, (config,), device)
    try:
        multihost.init_multihost(addr, n, 0, device=device)
        serve(make_mesh(n), config)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    finally:
        multihost.shutdown()
    multihost.join_ranks(procs, results, n - 1, JOIN_TIMEOUT_S)
