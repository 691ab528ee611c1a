"""NumPy oracle of the query semantics, and the result-line format
(counterpart: radixhashjoin_tpu/oracle.py).

A direct, device-free implementation of the same semantics as the
engine, exact for arbitrary uint64 data: the port's own reference for
tests and for chip_smoke.py. Per query (file:line cites are into the
C++ engine the contract comes from):

1. Filters narrow per-slot live rowid sets with strict <, >, =; an
   emptied slot NULLs the query (Query.cpp:81-158).
2. Joins run in written order over an aligned intermediate (slot ->
   rowid column):
   - both slots fresh: the intermediate becomes every matching (r1, r2)
     pair and any other slot's rows are discarded (intermediate.cpp:92-103);
   - one slot fresh: every existing row is replicated once per matching
     live row of the fresh slot (intermediate.cpp:52-66,108-125);
   - both joined: keep rows whose two values are equal
     (intermediate.cpp:72-87,130-138);
   - same-slot predicate: a fresh slot becomes its live rows with
     col1 == col2 (wiping the rest, like a fresh pair); a joined slot
     keeps rows with equal columns. It never NULLs (Query.cpp:168-170).
   - A join NULLs the query iff its PAIR SET is empty
     (Query.cpp:188-191): a both-joined step may filter away every row
     with a non-empty pair set, and then the line is zero sums.
3. Projections: wrapping uint64 SUM of the column over the final
   intermediate with multiplicity; 0 for a never-joined slot
   (Query.cpp:66-74,198-200,226-235).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .storage import Relation
from .workload import Query


def _expand_match(left_vals: np.ndarray, right_vals: np.ndarray):
    """All (i, j) with left_vals[i] == right_vals[j], grouped by i: sort
    the right side once, binary-search each left value, expand counts."""
    order = np.argsort(right_vals, kind="stable")
    rs = right_vals[order]
    lo = np.searchsorted(rs, left_vals, side="left")
    hi = np.searchsorted(rs, left_vals, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e
    left_idx = np.repeat(np.arange(len(left_vals), dtype=np.int64), counts)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total, dtype=np.int64) - offsets[left_idx]
    right_idx = order[lo[left_idx] + within]
    return left_idx, right_idx


class OracleExecutor:
    """Executes queries with NumPy."""

    def __init__(self, relations: Sequence[Relation]):
        self.relations = relations

    def _col(self, rel_id: int, col: int) -> np.ndarray:
        return self.relations[rel_id].values[col]

    def execute(self, q: Query) -> Optional[List[int]]:
        """Projection sums, or None for an all-NULL line."""
        rels = self.relations
        live: List[np.ndarray] = [
            np.arange(rels[q.slots[s]].num_tuples, dtype=np.int64)
            for s in range(len(q.slots))]
        for f in q.filters:
            vals = self._col(q.slots[f.slot], f.col)[live[f.slot]]
            k = np.uint64(f.value)
            if f.op == "=":
                mask = vals == k
            elif f.op == "<":
                mask = vals < k
            else:
                mask = vals > k
            live[f.slot] = live[f.slot][mask]
            if len(live[f.slot]) == 0:
                return None

        inter: Dict[int, np.ndarray] = {}    # slot -> aligned rowid column
        for j in q.joins:
            s1, c1, s2, c2 = j.slot1, j.col1, j.slot2, j.col2
            colA = self._col(q.slots[s1], c1)
            colB = self._col(q.slots[s2], c2)
            if s1 == s2:
                if s1 not in inter:
                    rows = live[s1]
                    inter = {s1: rows[colA[rows] == colB[rows]]}
                else:
                    keep = colA[inter[s1]] == colB[inter[s2]]
                    inter = {s: v[keep] for s, v in inter.items()}
                continue
            j1, j2 = s1 in inter, s2 in inter
            if not j1 and not j2:
                li, ri = _expand_match(colA[live[s1]], colB[live[s2]])
                if len(li) == 0:
                    return None
                inter = {s1: live[s1][li], s2: live[s2][ri]}
            elif j1 and j2:
                v1 = colA[inter[s1]]
                v2 = colB[inter[s2]]
                if len(np.intersect1d(v1, v2)) == 0:
                    return None
                keep = v1 == v2
                inter = {s: v[keep] for s, v in inter.items()}
            else:
                if j1:
                    full, fresh = s1, s2
                    full_vals = colA[inter[full]]
                    fresh_vals = colB[live[fresh]]
                else:
                    full, fresh = s2, s1
                    full_vals = colB[inter[full]]
                    fresh_vals = colA[live[fresh]]
                li, ri = _expand_match(full_vals, fresh_vals)
                if len(li) == 0:
                    return None
                inter = {s: v[li] for s, v in inter.items()}
                inter[fresh] = live[fresh][ri]

        sums: List[int] = []
        for p in q.projections:
            rows = inter.get(p.slot)
            if rows is None or len(rows) == 0:
                sums.append(0)
            else:
                col = self._col(q.slots[p.slot], p.col)
                sums.append(int(col[rows].sum(dtype=np.uint64)))
        return sums


def format_result(sums: Optional[List[int]], n_proj: int) -> str:
    """One output line (Query::print, Query.cpp:226-235)."""
    if sums is None:
        return " ".join(["NULL"] * n_proj)
    return " ".join(str(s) for s in sums)


def run_workload(relations: Sequence[Relation], batches) -> List[str]:
    ex = OracleExecutor(relations)
    return [format_result(ex.execute(q), len(q.projections))
            for batch in batches for q in batch]
