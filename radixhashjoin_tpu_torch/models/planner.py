"""Join-order planner (counterpart: radixhashjoin_tpu/models/planner.py,
copied line for line: host code, no device work).

Gated behind EngineConfig.enable_join_reordering (default off =
written-order parity). Greedy connected ordering: repeatedly pick the
cheapest next join by the stats-based cardinality estimate
(models/stats.py), constrained to joins touching an already-joined slot
once a component exists. The connectivity constraint keeps the engine's
chaining semantics (a fresh case-1 join wipes other slots' data): for
connected-in-order plans the output multiset equals the written order's.

Same-slot predicates (pure row filters) are hoisted to the front.
"""

from __future__ import annotations

from typing import List, Sequence

from ..storage import Relation
from ..workload import JoinPred, Query
from .stats import SlotStats, estimate_join_output, seed_stats


def reorder_joins(q: Query, relations: Sequence[Relation]) -> Query:
    """Return a Query with a (possibly) cheaper join order."""
    if len(q.joins) <= 1:
        return q
    stats = seed_stats(relations, q.slots)
    for f in q.filters:
        surviving = _rough_filter_estimate(stats[f.slot], f.col, f.op,
                                           f.value)
        stats[f.slot].apply_filter(f.col, f.op, f.value, surviving)

    remaining: List[JoinPred] = list(q.joins)
    ordered: List[JoinPred] = []
    joined: set = set()

    # hoist same-slot (row-filter) predicates: cheapest first, no reordering
    # hazard (they commute with everything)
    for j in list(remaining):
        if j.slot1 == j.slot2:
            remaining.remove(j)
            ordered.append(j)

    while remaining:
        if joined:
            candidates = [j for j in remaining
                          if j.slot1 in joined or j.slot2 in joined]
            if not candidates:
                # disconnected component: preserve written order from here
                # (the case-1 wipe makes reordering unsafe)
                ordered.extend(remaining)
                break
        else:
            candidates = remaining
        best = min(candidates, key=lambda j: estimate_join_output(
            stats[j.slot1], j.col1, stats[j.slot2], j.col2))
        remaining.remove(best)
        ordered.append(best)
        joined.update((best.slot1, best.slot2))
        _propagate_join(stats, best)

    return Query(q.slots, ordered, q.filters, q.projections, text=q.text)


def _rough_filter_estimate(s: SlotStats, col: int, op: str, k: int) -> int:
    """Range-uniformity estimate of a filter's surviving count."""
    lo, hi = s.low[col], s.max[col]
    if hi < lo:
        return 0
    width = hi - lo + 1
    if op == "=":
        return max(s.size // max(s.distinct[col], 1), 1) if lo <= k <= hi else 0
    if op == "<":
        frac = max(min((k - lo) / width, 1.0), 0.0)
    else:
        frac = max(min((hi - k) / width, 1.0), 0.0)
    return int(s.size * frac)


def _propagate_join(stats: List[SlotStats], j: JoinPred) -> None:
    """Textbook post-join stats: both sides take the estimated output size;
    join-key distincts drop to the min; ranges intersect."""
    a, b = stats[j.slot1], stats[j.slot2]
    est = int(estimate_join_output(a, j.col1, b, j.col2))
    d = min(max(a.distinct[j.col1], 1), max(b.distinct[j.col2], 1))
    lo = max(a.low[j.col1], b.low[j.col2])
    hi = min(a.max[j.col1], b.max[j.col2])
    a.size = b.size = max(est, 1)
    a.distinct[j.col1] = b.distinct[j.col2] = d
    a.low[j.col1] = b.low[j.col2] = lo
    a.max[j.col1] = b.max[j.col2] = hi
