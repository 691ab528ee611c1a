"""Engine configuration of the port (counterpart: radixhashjoin_tpu/config.py).

Field names and defaults are the reference's for every field the port
keeps. The reference's knobs that its engine never reads (radix bits,
exchange slack, dtype policy, limb chunking, Pallas interpret mode) are
not fields here, and neither are the four that chose a second path no
workload needs: the per-query executor (the batch executor answers
every query shape), the two message-table variant names (the tensor's
device picks the one implementation, ops/tables.py) and the sorted
huge-node windows (the port runs one unsorted window pass). Passing one
of them raises TypeError, as any unknown field does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class EngineConfig:
    # --- shape bucketing: padded sizes are min_pad * pad_base**k ---
    min_pad: int = 1024
    pad_base: int = 2

    # --- execution backend ---
    # "auto": the dense direct-address path when the catalog's value
    # domain fits max_dense_domain (int32 entries: 2**24 -> 64 MB table
    # on the device), else the sort join; "dense" / "sort" force one.
    join_backend: str = "auto"
    max_dense_domain: int = 1 << 24

    # dense backend: fuse each round into one stage (ops/stage.py);
    # False runs the per-op path (one stacked readback per join wave)
    fuse_stages: bool = True
    # a tree-shaped query within the exact caps runs as count-message
    # passing (ops/factorized.py); False materializes every query
    factorized: bool = True
    # non-deferable middle joins expand at a stats-estimated size inside
    # the same stage; a device flag records mis-speculation and the query
    # retries on the exact readback path
    speculate_expansions: bool = True
    speculate_slack: float = 4.0        # padding over the estimate
    speculate_max: int = 1 << 22        # never speculate wider than this
    # stats-driven join reordering (models/planner.py); off =>
    # written-order parity
    enable_join_reordering: bool = False

    # the NumPy oracle (oracle.py) answers every query; the device
    # executor still builds, and nothing else routes to the oracle
    force_oracle: bool = False
    # every factorized query of a round runs in ONE level-batched wave;
    # False runs each as its own ("ftree", ...) stage op
    ftree_wave: bool = True
    # queries per round of the fused batch path (a positive int); None
    # runs a batch as one round. The reference's 64: on the H100, 64-query
    # rounds measured no slower than one round on the 70-query CLI
    # (PERF.md §6)
    stage_group: Optional[int] = 64
    # defer a middle join's fresh attach when no later join references
    # the attached slot: rows never expand (a mult row carries the
    # multiplicity) and the readback boundary disappears
    defer_middle: bool = True
    # load, parse and format through the C++ host runtime
    # (runtime/native); a failed build raises, False runs the Python
    # loader and parser
    use_native_runtime: bool = True
    # per-operator timing + roofline accounting (utils/profiling.py):
    # synchronizes after every recorded operator
    profile: bool = False

    # --- the distributed layer (parallel/, one process per device) ---
    # a world of N ranks under torch.distributed runs every query through
    # parallel/dist_executor.py, the catalog row-sharded over the ranks
    mesh_devices: Optional[int] = None
    # a level-0 digit holding more than this share of a case-1 join's
    # right rows is broadcast (all_gather) instead of exchanged
    skew_heavy_fraction: float = 0.25
    # sub-exchanges of the case-1 left side (power of two dividing the
    # shard width; 1 disables)
    exchange_chunks: int = 4
    # sub-gathers of a cross-rank rowid gather (skipped below 4096 lanes)
    gather_chunks: int = 4
    # chunks of the case-2 fresh-side broadcast and the case-3 pair-set
    # test (each all_gather moves width / K lanes a rank)
    broadcast_chunks: int = 4
    # per-destination gather and exchange capacity starts at ~2x the
    # uniform share and retries x4 on overflow; False pins the worst case
    gather_capacity: bool = True

    def __post_init__(self) -> None:
        check_config(self)


def check_config(config: EngineConfig) -> None:
    """Raise ValueError for a value the port does not know."""
    sg = config.stage_group
    if sg is not None and (isinstance(sg, bool) or not isinstance(sg, int)
                           or sg < 1):
        raise ValueError(f"stage_group must be None or a positive int, "
                         f"got {sg!r}")
    if config.join_backend not in ("auto", "dense", "sort"):
        raise ValueError(f"unknown join_backend {config.join_backend!r}")


DEFAULT = EngineConfig()
