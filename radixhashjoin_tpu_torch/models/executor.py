"""Per-query executor: filters -> ordered join pipeline with rowid
intermediates -> exact u64 SUM projections (counterpart:
radixhashjoin_tpu/models/executor.py:67-217 JaxExecutor, ported line for
line).

It answers every query shape (cycles, same-slot predicates, queries
without joins, any multiplicity) by materializing the rowid
intermediate, where the wave-batched path (models/batch.py) only runs
queries that factorize:

* live rowid sets — padded int32 rowid arrays + a host count;
* equi-join — the sort join of ops/join.py, two-pass count-then-
  materialize: the host reads back each join's pair total and picks a
  padded output size (catalog.bucket);
* chaining cases 1/2/3 — gathers / replication / masked compaction;
* SUM projections — int64 folds per projection plane (ops/aggregate.py).

Every count the host needs is one device-to-host readback, as in the
reference. There is no route to the oracle and none to the CPU: the
executor runs on the catalog's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..ops.aggregate import sum_column_over_rows
from ..ops.compact import compact, compact_mask_positions
from ..ops.filter import filter_live, gather_clamped
from ..ops.join import (JoinCapacityError, any_common, expand_pairs,
                        probe_count)
from ..storage import Relation
from ..utils.limbs import combine_planes
from ..workload import Query
from .device_catalog import DeviceCatalog


def _eq_mask(a: torch.Tensor, b: torch.Tensor, count: int) -> torch.Tensor:
    idx = torch.arange(a.shape[0], dtype=torch.int32, device=a.device)
    return (a == b) & (idx < count)


class _Live:
    """A slot's live rowid set: padded device int32 rowids + host count."""

    __slots__ = ("rows", "count")

    def __init__(self, rows: torch.Tensor, count: int):
        self.rows = rows
        self.count = count


class TorchExecutor:
    """Executes parsed queries one at a time on the catalog's device.

    Device state: one int32 tensor per referenced relation column,
    uploaded once by the shared DeviceCatalog and reused across queries.
    """

    def __init__(self, relations: Sequence[Relation], *,
                 catalog: DeviceCatalog):
        self.relations = relations
        self.catalog = catalog
        # readbacks = device-to-host copies (counts, flags, sums)
        self.counters = {"queries": 0, "readbacks": 0}

    def _col(self, rel_id: int, col: int) -> torch.Tensor:
        return self.catalog.col(rel_id, col)

    def _all_rows(self, rel_id: int) -> _Live:
        n = self.relations[rel_id].num_tuples
        return _Live(self.catalog.iota(self.catalog.bucket(n)), n)

    def _read(self, t: torch.Tensor) -> int:
        self.counters["readbacks"] += 1
        return int(t)

    def _probe(self, lvals, lcount, rvals, rcount):
        """Pair indices of a sort join, or None when it has no pairs."""
        order, lo, off, cum, total = probe_count(lvals, lcount, rvals,
                                                 rcount)
        total = self._read(total)
        if total < 0:
            raise JoinCapacityError("join exceeds 2**31-1 output pairs")
        if total == 0:
            return None
        li, ri = expand_pairs(order, lo, off, cum,
                              self.catalog.bucket(total))
        return li, ri, total

    def execute(self, q: Query) -> Optional[List[int]]:
        """Projection sums, or None for an all-NULL line (matches
        oracle.py)."""
        self.counters["queries"] += 1
        g = gather_clamped
        nslots = len(q.slots)

        # 1. filters (Query.cpp:81-158)
        live: List[_Live] = [self._all_rows(q.slots[s])
                             for s in range(nslots)]
        for f in q.filters:
            col = self._col(q.slots[f.slot], f.col)
            lv = live[f.slot]
            opc, const = self.catalog.encode_filter(f.op, f.value)
            rows, cnt = filter_live(lv.rows, lv.count, col, const, opc)
            cnt = self._read(cnt)
            if cnt == 0:
                return None
            live[f.slot] = _Live(rows, cnt)

        # 2. ordered join pipeline with intermediate chaining
        inter: Dict[int, torch.Tensor] = {}   # slot -> padded rowid column
        icount = 0                             # shared live row count

        for j in q.joins:
            s1, c1, s2, c2 = j.slot1, j.col1, j.slot2, j.col2
            colA = self._col(q.slots[s1], c1)
            colB = self._col(q.slots[s2], c2)

            if s1 == s2:
                # same-slot predicate; never triggers NULL
                # (Query.cpp:168-170)
                if s1 not in inter:
                    # fresh slot: singleton intermediate; wipes any other
                    # component like case 1
                    lv = live[s1]
                    m = _eq_mask(g(colA, lv.rows), g(colB, lv.rows),
                                 lv.count)
                    pos, cnt = compact_mask_positions(m)
                    inter = {s1: compact(lv.rows, pos)}
                else:
                    m = _eq_mask(g(colA, inter[s1]), g(colB, inter[s2]),
                                 icount)
                    pos, cnt = compact_mask_positions(m)
                    inter = {s: compact(v, pos) for s, v in inter.items()}
                icount = self._read(cnt)
                continue

            j1, j2 = s1 in inter, s2 in inter
            if not j1 and not j2:
                # case 1: both fresh — all matching pairs between the live
                # sets; any other slot's data is discarded
                l, r = live[s1], live[s2]
                got = self._probe(g(colA, l.rows), l.count,
                                  g(colB, r.rows), r.count)
                if got is None:
                    return None
                li, ri, icount = got
                inter = {s1: g(l.rows, li), s2: g(r.rows, ri)}
            elif j1 and j2:
                # case 3: both joined — row filter; NULL iff the join's
                # PAIR SET is empty (Query.cpp:188-191), which can differ
                # from the filtered row count
                v1 = g(colA, inter[s1])
                v2 = g(colB, inter[s2])
                self.counters["readbacks"] += 1
                if not bool(any_common(v1, v2, icount)):
                    return None
                pos, cnt = compact_mask_positions(_eq_mask(v1, v2, icount))
                inter = {s: compact(v, pos) for s, v in inter.items()}
                icount = self._read(cnt)
            else:
                # case 2: one fresh — replicate each intermediate row once
                # per matching fresh rowid
                if j1:
                    full_vals = g(colA, inter[s1])
                    fresh, fresh_vals, fresh_slot = (
                        live[s2], g(colB, live[s2].rows), s2)
                else:
                    full_vals = g(colB, inter[s2])
                    fresh, fresh_vals, fresh_slot = (
                        live[s1], g(colA, live[s1].rows), s1)
                got = self._probe(full_vals, icount, fresh_vals,
                                  fresh.count)
                if got is None:
                    return None
                li, ri, icount = got
                inter = {s: g(v, li) for s, v in inter.items()}
                inter[fresh_slot] = g(fresh.rows, ri)

        # 3. SUM projections with multiplicity, exact u64 (Query.cpp:66-74):
        # one int64 fold per projection plane
        sums: List[int] = []
        for p in q.projections:
            rows = inter.get(p.slot)
            if rows is None or icount == 0:
                sums.append(0)
                continue
            parts = []
            for plane, shift in self.catalog.int32_planes(q.slots[p.slot],
                                                         p.col):
                self.counters["readbacks"] += 1
                parts.append((sum_column_over_rows(plane, rows, icount),
                              shift))
            sums.append(combine_planes(parts))
        return sums
