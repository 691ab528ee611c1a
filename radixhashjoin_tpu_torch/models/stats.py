"""Selectivity statistics propagation (counterpart:
radixhashjoin_tpu/models/stats.py, copied line for line: host code, no
device work).

The reference's per-query statistics semantics (relList_stats, seeded
from load-time column stats and updated per filter):

* `> k`:  distinct' = distinct * (max - k + 1) / (max - low), low' = k+1
* `< k`:  distinct' = distinct * (k - 1 - low) / (max - low), max' = k-1
* `= k`:  low' = max' = k, distinct' = 1
* any filter, other columns c: distinct_c' =
      distinct_c * (1 - (1 - |F|/size)^(size/distinct_c))
  with |F| the surviving row count, then size' = |F|.

They feed the join-order planner (models/planner.py) and the batch
executor's speculative expansion sizing (models/batch.py _spec_size).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from ..storage import Relation


@dataclasses.dataclass
class SlotStats:
    """Per-slot propagated stats (one per query slot, like stats[i])."""
    size: int
    low: List[int]
    max: List[int]
    distinct: List[int]

    @classmethod
    def from_relation(cls, rel: Relation) -> "SlotStats":
        return cls(size=rel.num_tuples,
                   low=[s.min for s in rel.stats],
                   max=[s.max for s in rel.stats],
                   distinct=[s.distinct for s in rel.stats])

    def apply_filter(self, col: int, op: str, k: int,
                     surviving: int) -> None:
        """Propagate one filter's effect; `surviving` = |F| after it."""
        lo, hi, d = self.low[col], self.max[col], self.distinct[col]
        if op == ">":
            if d != 1 and hi > lo:
                self.distinct[col] = (d * (hi - k + 1)) // (hi - lo)
            self.low[col] = k + 1
        elif op == "<":
            if d != 1 and hi > lo:
                self.distinct[col] = (d * max(k - 1 - lo, 0)) // (hi - lo)
            self.max[col] = k - 1
        else:
            self.low[col] = self.max[col] = k
            self.distinct[col] = 1
        for c in range(len(self.distinct)):
            if c != col and self.size > 0 and self.distinct[c] > 0:
                frac = 1.0 - surviving / self.size
                self.distinct[c] = int(
                    self.distinct[c] *
                    (1.0 - frac ** (self.size / self.distinct[c])))
        self.size = surviving


def estimate_join_output(a: SlotStats, ca: int, b: SlotStats, cb: int) -> float:
    """Classic equi-join cardinality estimate |A||B| / max(dA, dB), with a
    range-overlap correction from the propagated [low, max] intervals."""
    da = max(a.distinct[ca], 1)
    db = max(b.distinct[cb], 1)
    lo = max(a.low[ca], b.low[cb])
    hi = min(a.max[ca], b.max[cb])
    if hi < lo:
        return 0.0
    ra = a.max[ca] - a.low[ca] + 1
    rb = b.max[cb] - b.low[cb] + 1
    overlap = (hi - lo + 1) / max(min(ra, rb), 1)
    return a.size * b.size / max(da, db) * min(overlap, 1.0)


def seed_stats(relations: Sequence[Relation], slots: Sequence[int]
               ) -> List[SlotStats]:
    return [SlotStats.from_relation(relations[r]) for r in slots]
