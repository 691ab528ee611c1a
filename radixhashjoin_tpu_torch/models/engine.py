"""Engine facade: catalog + executors + workload runner (counterpart:
radixhashjoin_tpu/models/engine.py:26-157).

Relations load once (storage.py), every query runs on the device the
caller names, and results print in input order with the reference
binary's stdin/stdout contract. Two executors share one DeviceCatalog:

* batch_execution=True (the default): the wave-batched BatchExecutor
  (models/batch.py), which answers every query shape in the same batch:
  a factorized wave for tree-shaped queries, materialized stage ops for
  the rest;
* batch_execution=False: the per-query TorchExecutor
  (models/executor.py), the materializing sort join one query at a
  time.

With mesh_devices=N the engine is one rank of an N-rank run
(parallel/): its catalog is row-sharded and every query runs through
the DistExecutor (parallel/dist_executor.py), a batch's factorized
queries in one distributed wave, the rest query by query.

Both paths run each query through `_plan` first: the stats-driven join
reordering of models/planner.py when enable_join_reordering is set.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, TextIO

import torch

from ..config import DEFAULT, EngineConfig
from ..oracle import format_result
from ..storage import Relation, load_relation
from ..workload import Query, parse_init_stream, parse_work_stream
from .batch import BatchExecutor
from .device_catalog import DeviceCatalog
from .executor import TorchExecutor
from .planner import reorder_joins


class Engine:
    """End-to-end engine over a set of loaded relations, on one device."""

    def __init__(self, relations: Sequence[Relation],
                 config: EngineConfig = DEFAULT, *,
                 device: Optional[torch.device] = None, mesh=None):
        """`device`: where a single-device engine runs. With
        config.mesh_devices the engine is this rank's part of a
        distributed run over `mesh` (default: the initialized world,
        parallel/mesh.py make_mesh), on the mesh's device."""
        self.relations = list(relations)
        self.config = config
        self.dist_executor = None
        if config.mesh_devices:
            from ..parallel.dist_executor import DistExecutor
            self.dist_executor = DistExecutor(
                self.relations, config, mesh=mesh,
                n_devices=config.mesh_devices)
            self.device = self.dist_executor.device
            self.batch_executor = self.executor = None
            return
        self.device = torch.device(device)
        if config.batch_execution:
            self.batch_executor = BatchExecutor(self.relations, config,
                                                device=self.device)
            catalog = self.batch_executor.catalog
        else:
            self.batch_executor = None
            catalog = DeviceCatalog(self.relations, config,
                                    device=self.device)
        self.executor = TorchExecutor(self.relations, catalog=catalog)

    @classmethod
    def from_paths(cls, paths: Sequence[str],
                   config: EngineConfig = DEFAULT, *,
                   device: Optional[torch.device] = None,
                   mesh=None) -> "Engine":
        return cls([load_relation(p) for p in paths], config, device=device,
                   mesh=mesh)

    def execute(self, q: Query) -> Optional[List[int]]:
        """One query through the per-query executor (or the distributed
        one): projection sums, or None for a NULL line."""
        if self.dist_executor is not None:
            return self.dist_executor.execute(self._plan(q))
        return self.executor.execute(self._plan(q))

    def _plan(self, q: Query) -> Query:
        """Stats-driven join reordering (models/planner.py); off by
        default for written-order parity."""
        if self.config.enable_join_reordering:
            return reorder_joins(q, self.relations)
        return q

    def run_batch_raw(self, batch: Sequence[Query]
                      ) -> List[Optional[List[int]]]:
        """One query batch on the device: per-query sums (None = NULL
        line), unformatted."""
        if self.dist_executor is not None and self.config.batch_execution:
            return self.dist_executor.run_batch_raw(
                [self._plan(q) for q in batch])
        if self.batch_executor is None:
            return [self.execute(q) for q in batch]
        return self.batch_executor.run_batch([self._plan(q) for q in batch])

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


def resolve_device(device) -> torch.device:
    """The device a run asked for; a CUDA device without a card raises
    (never a silent CPU)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False (run on device 'cpu', --device cpu on the command "
                "line, for the plain PyTorch versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def main(stdin: TextIO = None, stdout: TextIO = None,
         config: EngineConfig = DEFAULT, device="cuda") -> Engine:
    """stdin-protocol entry point, contract-identical to the reference
    binary: relation paths until `Done`, then query batches
    (`F`-terminated), then one result line per query in input order.
    Returns the engine (its executors' counters describe the run)."""
    dev = resolve_device(device)
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
        batches = parse_work_stream(stdin)
    except (ValueError, IndexError) as e:
        print(f"radixhashjoin_tpu_torch: malformed work stream: {e}",
              file=sys.stderr)
        raise SystemExit(1)
    for line in engine.run_workload(batches):
        stdout.write(line + "\n")
    return engine
