"""Join-order planner (counterpart: radixhashjoin_tpu/models/planner.py:
host code, no device work).

Gated behind EngineConfig.enable_join_reordering (default off =
written-order parity). Greedy connected ordering: repeatedly pick the
cheapest next join by the stats-based cardinality estimate
(models/stats.py), constrained to joins touching an already-joined slot
once a component exists.

Under the reference's chaining semantics (oracle.py) only one kind of
query keeps its result when its joins move: one whose written order
attaches one fresh slot per join (a tree of joins over distinct slots).
Then every connected order builds the same tree and the same multiset.
Anything else changes lines when reordered: a fresh same-slot predicate
or a case-1 join (both slots fresh) wipes the intermediate, and a
case-3 step (both slots joined) tests its own pair set for NULL, so
hoisting or moving such a step changes what it sees. Such queries keep
their written order. This is a declared divergence from the JAX
package, whose planner hoists same-slot predicates and reorders every
query (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import List, Sequence

from ..storage import Relation
from ..workload import JoinPred, Query
from .stats import SlotStats, estimate_join_output, seed_stats


def reorder_joins(q: Query, relations: Sequence[Relation]) -> Query:
    """Return a Query with a (possibly) cheaper join order; a query whose
    written order does not attach one fresh slot per join comes back
    unchanged."""
    if len(q.joins) <= 1 or not fresh_slot_chain(q.joins):
        return q
    stats = seed_stats(relations, q.slots)
    for f in q.filters:
        surviving = _rough_filter_estimate(stats[f.slot], f.col, f.op,
                                           f.value)
        stats[f.slot].apply_filter(f.col, f.op, f.value, surviving)

    remaining: List[JoinPred] = list(q.joins)
    ordered: List[JoinPred] = []
    joined: set = set()

    while remaining:
        # the joins form a tree over the slots, so a connected candidate
        # exists until none remain
        candidates = ([j for j in remaining
                       if j.slot1 in joined or j.slot2 in joined]
                      if joined else remaining)
        best = min(candidates, key=lambda j: estimate_join_output(
            stats[j.slot1], j.col1, stats[j.slot2], j.col2))
        remaining.remove(best)
        ordered.append(best)
        joined.update((best.slot1, best.slot2))
        _propagate_join(stats, best)

    return Query(q.slots, ordered, q.filters, q.projections, text=q.text)


def fresh_slot_chain(joins: Sequence[JoinPred]) -> bool:
    """True when the written order attaches one fresh slot per join: the
    first join joins two distinct slots and every later one exactly one
    joined slot with one fresh slot (no same-slot predicate, no case-1
    wipe, no case-3 step)."""
    joined: set = set()
    for j in joins:
        if j.slot1 == j.slot2:
            return False
        n_joined = (j.slot1 in joined) + (j.slot2 in joined)
        if joined and n_joined != 1:
            return False
        joined.update((j.slot1, j.slot2))
    return True


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
