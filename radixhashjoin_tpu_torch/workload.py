"""Workload parsing: init streams and query batches (counterpart:
radixhashjoin_tpu/workload.py).

The stream contracts are the reference binary's (join.cpp:18-40 and
Query.cpp:10-63 of the C++ engine):

* init stream: one relation path per line, ended by a literal ``Done``
  line; relation ids are load order;
* work stream: one query per line, ``tables|predicates|projections``;
  batches end with a line ``F`` (parse-level only: every batch runs
  alike);
* predicates: join ``s1.c1=s2.c2`` (any comparator char, always equi),
  filter ``s.cOPk`` with OP in {=,<,>} (strict); projection ``s.c``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, TextIO, Tuple


@dataclasses.dataclass(frozen=True)
class JoinPred:
    """Equi-join ``slot1.col1 = slot2.col2`` (reference: join_info, Query.h:8-14)."""
    slot1: int
    col1: int
    slot2: int
    col2: int


@dataclasses.dataclass(frozen=True)
class FilterPred:
    """Filter ``slot.col OP value``, OP in {=,<,>} strict (reference: filter_info, Query.h:16-24)."""
    slot: int
    col: int
    op: str
    value: int


@dataclasses.dataclass(frozen=True)
class Projection:
    """SUM projection ``slot.col`` (reference: proj_info, Query.h:26-32)."""
    slot: int
    col: int


@dataclasses.dataclass
class Query:
    """One parsed query (reference: Query, Query.h:34-41).

    ``slots[i]`` is the relation id bound to query-local slot ``i``; the
    same relation may appear in several slots.
    """
    slots: List[int]
    joins: List[JoinPred]
    filters: List[FilterPred]
    projections: List[Projection]
    text: str = ""


def _parse_ref(tok: str) -> Tuple[int, int]:
    s, c = tok.split(".")
    return int(s), int(c)


def parse_query(line: str) -> Query:
    """Parse ``tables|predicates|projections`` (reference: Query::Query, Query.cpp:237-242)."""
    tables_s, preds_s, projs_s = line.rstrip("\n").split("|")
    slots = [int(t) for t in tables_s.split()]
    joins: List[JoinPred] = []
    filters: List[FilterPred] = []
    if preds_s.strip():
        for pred in preds_s.split("&"):
            # the comparator: first of = < > after the left reference
            op_pos = min(pred.index(ch) for ch in "=<>" if ch in pred)
            op = pred[op_pos]
            lhs, rhs = pred[:op_pos], pred[op_pos + 1:]
            s1, c1 = _parse_ref(lhs)
            if "." in rhs:
                # join: the comparator char is discarded, always equi
                # (Query.cpp:46-48)
                s2, c2 = _parse_ref(rhs)
                joins.append(JoinPred(s1, c1, s2, c2))
            else:
                filters.append(FilterPred(s1, c1, op, int(rhs)))
    projections = [Projection(*_parse_ref(t)) for t in projs_s.split()]
    return Query(slots, joins, filters, projections, text=line.rstrip("\n"))


def parse_work_stream(stream: Iterable[str]) -> List[List[Query]]:
    """Parse a work stream into batches (a list of lists of queries)."""
    batches: List[List[Query]] = []
    cur: List[Query] = []
    for line in stream:
        line = line.rstrip("\n")
        if not line:
            continue
        if line == "F":
            if cur:
                batches.append(cur)
                cur = []
            continue
        cur.append(parse_query(line))
    if cur:
        batches.append(cur)
    return batches


def parse_init_stream(stream: TextIO) -> List[str]:
    """Read relation paths until the literal ``Done`` line (join.cpp:18-22)."""
    paths: List[str] = []
    for line in stream:
        line = line.rstrip("\n")
        if line == "Done":
            break
        if line:
            paths.append(line)
    return paths
