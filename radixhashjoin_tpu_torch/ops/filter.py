"""Selection filter: strict <, >, = over a slot's live rowids
(counterpart: radixhashjoin_tpu/ops/filter.py).

The opcodes serve the factorized wave too, where a filter is a boolean
mask built inside the wave (ops/factorized.py). The per-op paths narrow
compacted rowid sets instead: `filter_conj` evaluates a slot's
conjunctive filters and compacts the survivors stably. On a CUDA tensor
that is one pass of the hand-written select kernel (csrc/select.cu,
kernels.select_cuda) per SELECT_MAX_PREDS predicates, with no fallback;
its plain version, which the CPU runs, is the chain of one-predicate
filters (a gather, a compare, a stable compaction each). A stable
compaction of the conjunction keeps the same rows in the same order as
the chain, so both give the same rowids and count. `filter_full` and
`filter_live` are its one-predicate calls. A NULL early exit is the
caller reading back a zero count.

Filter constants are mapped onto the device code space by
DeviceCatalog.encode_filter (identity narrowing, or order-preserving
dictionary translation for wide catalogs).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import kernels
from ..utils import profiling
from .compact import compact, compact_mask_positions

OP_EQ, OP_LT, OP_GT = 0, 1, 2
OP_CODE = {"=": OP_EQ, "<": OP_LT, ">": OP_GT}


def _compare(vals: torch.Tensor, value, op: int) -> torch.Tensor:
    if op == OP_EQ:
        return vals == value
    if op == OP_LT:
        return vals < value
    return vals > value


def gather_clamped(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] with out-of-range indices clamped to the ends, the
    reference's gather semantics under jit (padding lanes read garbage
    that the live count masks); an empty arr gives zeros."""
    if arr.shape[0] == 0:
        return torch.zeros(idx.shape[0], dtype=arr.dtype, device=arr.device)
    return arr.index_select(0, idx.clamp(0, arr.shape[0] - 1))


def _filter_live_torch(rowids: torch.Tensor, count, col: torch.Tensor,
                       value, op: int) -> Tuple[torch.Tensor, torch.Tensor]:
    n = rowids.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=rowids.device)
    m = _compare(gather_clamped(col, rowids), value, op) & (idx < count)
    pos, new_count = compact_mask_positions(m)
    return compact(rowids, pos), new_count


def _filter_full_torch(col: torch.Tensor, count, value, op: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = col.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=col.device)
    m = _compare(col, value, op) & (idx < count)
    pos, new_count = compact_mask_positions(m)
    return compact(idx, pos), new_count


def filter_conj_torch(rows: Optional[torch.Tensor], count, preds, pad: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `filter_conj`: one full-width filter per
    predicate, each narrowing the last one's survivors."""
    (col, op, value), rest = preds[0], preds[1:]
    if rows is None:
        rows, count = _filter_full_torch(col, count, value, op)
    else:
        rows, count = _filter_live_torch(rows, count, col, value, op)
    for col, op, value in rest:
        rows, count = _filter_live_torch(rows, count, col, value, op)
    n = rows.shape[0]
    if pad > n:
        return torch.nn.functional.pad(rows, (0, pad - n)), count
    return rows[:pad], count


def filter_conj(rows: Optional[torch.Tensor], count,
                preds: Sequence[Tuple[torch.Tensor, int, int]], pad: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Narrow a slot's live set to the rows that satisfy every predicate.

    rows: padded int32 rowids, or None for a pristine slot (the identity
    over the columns' length: each column is scanned directly); count:
    live prefix length (int or 0-d tensor); preds: (full device column
    int32, opcode, int32-range constant), all of the slot's relation.
    Returns (the survivors' rowids in order, then zeros, padded or cut to
    `pad`; the number of survivors, 0-d int32). One pass per
    SELECT_MAX_PREDS predicates, each later pass on the earlier one's
    rows: the select kernel on a CUDA tensor, filter_conj_torch on the
    CPU. Counted (while a capture records) as `filter.passes` and
    `filter.predicates`."""
    preds = list(preds)
    if not preds:
        raise ValueError("filter_conj: no predicate")
    step = kernels.SELECT_MAX_PREDS
    profiling.count("filter.passes", -(-len(preds) // step))
    profiling.count("filter.predicates", len(preds))
    select = (kernels.select_cuda if preds[0][0].device.type == "cuda"
              else filter_conj_torch)
    for i in range(0, len(preds), step):
        last = i + step >= len(preds)
        # an earlier pass keeps every survivor: only the last one cuts
        width = pad if last else (preds[0][0].shape[0] if rows is None
                                  else rows.shape[0])
        rows, count = select(rows, count, preds[i:i + step], width)
    return rows, count


def filter_live(rowids: torch.Tensor, count, col: torch.Tensor, value,
                op: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Narrow live rowids to those whose `col` value satisfies (op, value).

    rowids: padded int32 rowid array; count: live prefix length (int or
    0-d tensor); col: full device column (int32); value: int32-range
    constant. Returns (new rowids, same padded length; new count, 0-d).
    """
    return filter_conj(rowids, count, [(col, op, value)], rowids.shape[0])


def filter_full(col: torch.Tensor, count, value, op: int, pad: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First filter on a pristine slot: scan the column directly (the
    live set is still the identity). Returns (rowids padded or cut to
    `pad`, new count)."""
    return filter_conj(None, count, [(col, op, value)], pad)
