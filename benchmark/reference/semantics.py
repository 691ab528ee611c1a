"""Plain PyTorch reference of the contest's query semantics.

It imports nothing of the program. It reads the relations the benchmark
generated (host uint64 columns) and the query text, and works every
answer out again on the device it is given, one query at a time:

1. Filters (strict <, >, =) narrow each slot's live rowids; a slot left
   empty makes the line NULL.
2. Joins run in written order over an intermediate (slot -> aligned
   rowids). Two fresh slots: the intermediate becomes every matching
   pair. One fresh slot: each row is repeated once per matching live row
   of the fresh slot. Both joined: rows whose two values differ go. A
   predicate between two columns of one slot keeps the rows where they
   are equal (a fresh slot's live rows then become the intermediate). A
   join whose pair set is empty makes the line NULL.
3. Each projection is the wrapping uint64 SUM of its column over the
   final intermediate, with multiplicity; 0 for a slot never joined.

This is the semantics of the reference binary's Query.cpp and
intermediate.cpp that the program answers to. `sum_dtype=torch.float32`
accumulates the SUMs in float32 instead of exact 64-bit integers: the
control of PERF.md, which breaks the exactness the configurations state.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

U64 = (1 << 64) - 1
I64_MAX = (1 << 63) - 1


def parse(line: str) -> Tuple[List[int], list, list, list]:
    """(slots, joins, filters, projections) of `tables|predicates|
    projections`; a predicate's comparator is the first of = < > after
    its left reference, and a right side with a dot is a join (always
    equi)."""
    tables, preds, projs = line.split("|")
    slots = [int(t) for t in tables.split()]
    joins, filters = [], []
    for pred in (p for p in preds.split("&") if p.strip()):
        at = min(pred.index(ch) for ch in "=<>" if ch in pred)
        s1, c1 = (int(x) for x in pred[:at].split("."))
        rhs = pred[at + 1:]
        if "." in rhs:
            s2, c2 = (int(x) for x in rhs.split("."))
            joins.append((s1, c1, s2, c2))
        else:
            filters.append((s1, c1, pred[at], int(rhs)))
    proj = [tuple(int(x) for x in p.split(".")) for p in projs.split()]
    return slots, joins, filters, proj


def format_line(sums: Optional[List[int]], n_proj: int) -> str:
    if sums is None:
        return " ".join(["NULL"] * n_proj)
    return " ".join(str(s) for s in sums)


class Reference:
    """Answers query lines over `relations` (lists of host uint64 columns)
    on `device`. Columns upload at first use, as int64 (every generated
    value is below 2^63)."""

    def __init__(self, relations: Sequence[Sequence[np.ndarray]], device,
                 sum_dtype: torch.dtype = torch.int64):
        self.relations = relations
        self.device = torch.device(device)
        self.sum_dtype = sum_dtype
        self._cols: Dict[tuple, torch.Tensor] = {}

    def col(self, rel: int, c: int) -> torch.Tensor:
        key = (rel, c)
        if key not in self._cols:
            host = np.asarray(self.relations[rel][c])
            if len(host) and int(host.max()) > I64_MAX:
                raise ValueError(f"relation {rel} column {c} holds a value "
                                 f"past 2^63")
            with warnings.catch_warnings():   # read-only input, never written
                warnings.simplefilter("ignore", UserWarning)
                self._cols[key] = torch.from_numpy(
                    host.view(np.int64)).to(self.device)
        return self._cols[key]

    def rows(self, rel: int) -> int:
        return len(self.relations[rel][0])

    @staticmethod
    def _compare(vals: torch.Tensor, op: str, k: int) -> torch.Tensor:
        if k > I64_MAX:          # past every value
            return torch.full_like(vals, op == "<", dtype=torch.bool)
        if op == "=":
            return vals == k
        return vals < k if op == "<" else vals > k

    @staticmethod
    def _expand(left: torch.Tensor, right: torch.Tensor):
        """Every (i, j) with left[i] == right[j], grouped by i."""
        order = torch.argsort(right, stable=True)
        rs = right[order]
        lo = torch.searchsorted(rs, left, side="left")
        counts = torch.searchsorted(rs, left, side="right") - lo
        li = torch.repeat_interleave(
            torch.arange(len(left), device=left.device), counts)
        if len(li) == 0:
            return li, li
        start = torch.cumsum(counts, 0) - counts
        within = torch.arange(len(li), device=left.device) - start[li]
        return li, order[lo[li] + within]

    def answer(self, line: str) -> Optional[List[int]]:
        """The line's SUMs, or None for a NULL line."""
        slots, joins, filters, projs = parse(line)
        dev = self.device
        live = [torch.arange(self.rows(r), device=dev) for r in slots]
        for s, c, op, k in filters:
            vals = self.col(slots[s], c)[live[s]]
            live[s] = live[s][self._compare(vals, op, k)]
            if len(live[s]) == 0:
                return None
        inter: Dict[int, torch.Tensor] = {}
        for s1, c1, s2, c2 in joins:
            a, b = self.col(slots[s1], c1), self.col(slots[s2], c2)
            if s1 == s2:
                if s1 not in inter:
                    r = live[s1]
                    inter = {s1: r[a[r] == b[r]]}
                else:
                    keep = a[inter[s1]] == b[inter[s1]]
                    inter = {s: v[keep] for s, v in inter.items()}
                continue
            j1, j2 = s1 in inter, s2 in inter
            if not j1 and not j2:
                li, ri = self._expand(a[live[s1]], b[live[s2]])
                if len(li) == 0:
                    return None
                inter = {s1: live[s1][li], s2: live[s2][ri]}
            elif j1 and j2:
                v1, v2 = a[inter[s1]], b[inter[s2]]
                if not torch.isin(v1, v2).any():
                    return None
                keep = v1 == v2
                inter = {s: v[keep] for s, v in inter.items()}
            else:
                full, fresh, cf, cr = ((s1, s2, a, b) if j1
                                       else (s2, s1, b, a))
                li, ri = self._expand(cf[inter[full]], cr[live[fresh]])
                if len(li) == 0:
                    return None
                inter = {s: v[li] for s, v in inter.items()}
                inter[fresh] = live[fresh][ri]
        sums = []
        for s, c in projs:
            rows = inter.get(s)
            if rows is None or len(rows) == 0:
                sums.append(0)
                continue
            vals = self.col(slots[s], c)[rows]
            if self.sum_dtype == torch.int64:
                sums.append(int(vals.sum()) & U64)    # wraps mod 2^64
            else:
                sums.append(int(vals.to(self.sum_dtype).sum().item()) & U64)
        return sums

    def lines(self, request: Sequence[str]) -> List[str]:
        return [format_line(self.answer(q), len(parse(q)[3]))
                for q in request]
