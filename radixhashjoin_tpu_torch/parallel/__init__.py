"""Distributed execution: one process per device under torch.distributed
(counterpart: radixhashjoin_tpu/parallel/).

The reference runs one controller over a JAX device mesh with shard_map
programs; the port runs every rank as its own process with the same host
program, NCCL collectives between cards and gloo between CPU ranks:

  per-chunk histograms + merge        -> local bincount + all_reduce
  partition scatter across ranks      -> level-0 digit binning (the rank
                                         kernel) + all_to_all
  per-bucket build/probe              -> rank-local sort + searchsorted,
                                         or the factorized wave with one
                                         all_reduce per tree level

mesh.py (a rank's view and its collectives), multihost.py (joining and
spawning ranks), dist_join.py (the radix-exchange join), dist_ops.py
(the executor's operators), dist_executor.py (queries), worker.py (the
CLI's ranks).
"""

from .dist_executor import DistExecutor
from .dist_join import (dist_join_count_sum, dist_join_skewaware,
                        radix_exchange)
from .mesh import make_mesh

__all__ = ["make_mesh", "dist_join_count_sum", "dist_join_skewaware",
           "radix_exchange", "DistExecutor"]
