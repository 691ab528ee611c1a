"""Engine facade: catalog + executor + workload runner (counterpart:
radixhashjoin_tpu/models/engine.py:26-157).

Relations load once (storage.py), every query runs on the device the
caller names, and results print in input order with the reference
binary's stdin/stdout contract. One executor answers every query: the
wave-batched BatchExecutor (models/batch.py), over its DeviceCatalog,
which runs every query shape in the same batch: a factorized wave for
tree-shaped queries, materialized stage ops for the rest (with
join_backend="sort", the per-op sort join). `execute(q)` is a batch of
one.

With mesh_devices=N the engine is one rank of an N-rank run
(parallel/): its catalog is row-sharded and every query runs through
the DistExecutor (parallel/dist_executor.py), a batch's factorized
queries in one distributed wave, the rest query by query.

Both paths run each query through `_plan` first: the stats-driven join
reordering of models/planner.py when enable_join_reordering is set.
force_oracle=True answers every query with the NumPy oracle (oracle.py)
instead; the engine takes that route only when asked.

Relations load, and the CLI's work stream parses and its lines format,
through the C++ host runtime (runtime/native.py) unless
use_native_runtime=False: then storage.py, workload.py and
oracle.format_result do it, with the same results.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, TextIO

import torch

from ..config import DEFAULT, EngineConfig
from ..oracle import OracleExecutor, format_result
from ..storage import Relation, load_relation
from ..workload import Query, parse_init_stream, parse_work_stream
from .batch import BatchExecutor
from .device_catalog import resolve_device
from .planner import reorder_joins


class Engine:
    """End-to-end engine over a set of loaded relations, on one device."""

    def __init__(self, relations: Sequence[Relation],
                 config: EngineConfig = DEFAULT, *,
                 device: Optional[torch.device] = None, mesh=None):
        """`device`: where a single-device engine runs (default: the
        card, resolve_device("cuda")). With config.mesh_devices the engine
        is this rank's part of a distributed run over `mesh` (default: the
        initialized world, parallel/mesh.py make_mesh), on the mesh's
        device."""
        self.relations = list(relations)
        self.config = config
        self._oracle = OracleExecutor(self.relations)
        self.dist_executor = None
        if config.mesh_devices:
            from ..parallel.dist_executor import DistExecutor
            self.dist_executor = DistExecutor(
                self.relations, config, mesh=mesh,
                n_devices=config.mesh_devices)
            self.device = self.dist_executor.device
            self.batch_executor = None
            return
        self.device = resolve_device("cuda" if device is None else device)
        self.batch_executor = BatchExecutor(self.relations, config,
                                            device=self.device)

    @classmethod
    def from_paths(cls, paths: Sequence[str],
                   config: EngineConfig = DEFAULT, *,
                   device: Optional[torch.device] = None,
                   mesh=None) -> "Engine":
        """Load the relations (through the C++ loader unless
        config.use_native_runtime is False) and build the engine."""
        if config.use_native_runtime:
            from ..runtime import load_relation_native as load
        else:
            load = load_relation
        return cls([load(p) for p in paths], config, device=device,
                   mesh=mesh)

    def execute(self, q: Query) -> Optional[List[int]]:
        """One query by the route of run_batch_raw (the oracle under
        force_oracle, the distributed executor under a mesh, else a
        batch of one): projection sums, or None for a NULL line."""
        q = self._plan(q)
        if self.config.force_oracle:
            return self._oracle.execute(q)
        if self.dist_executor is not None:
            return self.dist_executor.execute(q)
        return self.batch_executor.run_batch([q])[0]

    def _plan(self, q: Query) -> Query:
        """Stats-driven join reordering (models/planner.py); off by
        default for written-order parity."""
        if self.config.enable_join_reordering:
            return reorder_joins(q, self.relations)
        return q

    def run_batch_raw(self, batch: Sequence[Query]
                      ) -> List[Optional[List[int]]]:
        """One query batch on the device (on the host's oracle under
        force_oracle): per-query sums (None = NULL line), unformatted."""
        if self.config.force_oracle:
            return [self.execute(q) for q in batch]
        planned = [self._plan(q) for q in batch]
        if self.dist_executor is not None:
            return self.dist_executor.run_batch_raw(planned)
        return self.batch_executor.run_batch(planned)

    def run_batch(self, batch: Sequence[Query]) -> List[str]:
        out = self.run_batch_raw(batch)
        return [format_result(r, len(q.projections))
                for r, q in zip(out, batch)]

    def run_workload_raw(self, batches: Sequence[Sequence[Query]]
                         ) -> List[Optional[List[int]]]:
        """All batches at once: batch framing is parse-level only (the
        reference also schedules every query of every batch before
        printing), and one mega-batch maximizes the wave's width."""
        return self.run_batch_raw([q for batch in batches for q in batch])

    def run_workload(self, batches: Sequence[Sequence[Query]]) -> List[str]:
        raw = self.run_workload_raw(batches)
        queries = [q for batch in batches for q in batch]
        return [format_result(r, len(q.projections))
                for r, q in zip(raw, queries)]


def main(stdin: TextIO = None, stdout: TextIO = None,
         config: EngineConfig = DEFAULT, device="cuda") -> Engine:
    """stdin-protocol entry point, contract-identical to the reference
    binary: relation paths until `Done`, then query batches
    (`F`-terminated), then one result line per query in input order.
    The work stream parses and the lines format through the C++ host
    runtime unless config.use_native_runtime is False.
    Returns the engine (its executor's counters describe the run)."""
    dev = resolve_device(device)
    native = config.use_native_runtime
    if native:
        from ..runtime import format_results_native, parse_work_native
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    paths = parse_init_stream(stdin)
    try:
        engine = Engine.from_paths(paths, config, device=dev)
    except (OSError, AssertionError) as e:
        print(f"radixhashjoin_tpu_torch: cannot load relations: {e}",
              file=sys.stderr)
        raise SystemExit(1)
    try:
        batches = (parse_work_native(stdin.read()) if native
                   else parse_work_stream(stdin))
    except (ValueError, IndexError) as e:
        print(f"radixhashjoin_tpu_torch: malformed work stream: {e}",
              file=sys.stderr)
        raise SystemExit(1)
    if native:
        raw = engine.run_workload_raw(batches)
        stdout.write(format_results_native(
            raw, [len(q.projections) for b in batches for q in b]))
    else:
        for line in engine.run_workload(batches):
            stdout.write(line + "\n")
    return engine
