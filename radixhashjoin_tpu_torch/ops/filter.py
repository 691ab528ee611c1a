"""Selection filter: strict <, >, = over a slot's live rowids
(counterpart: radixhashjoin_tpu/ops/filter.py).

The opcodes serve the factorized wave too, where a filter is a boolean
mask built inside the wave (ops/factorized.py). The per-query executor
(models/executor.py) narrows compacted rowid sets instead: one gather,
one compare, one stable compaction; a NULL early exit is the caller
reading back a zero count.

Filter constants are mapped onto the device code space by
DeviceCatalog.encode_filter (identity narrowing, or order-preserving
dictionary translation for wide catalogs).
"""

from __future__ import annotations

from typing import Tuple

import torch

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


def filter_live(rowids: torch.Tensor, count, col: torch.Tensor, value,
                op: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Narrow live rowids to those whose `col` value satisfies (op, value).

    rowids: padded int32 rowid array; count: live prefix length (int or
    0-d tensor); col: full device column (int32); value: int32-range
    constant. Returns (new rowids, same padded length; new count, 0-d).
    """
    n = rowids.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=rowids.device)
    m = _compare(gather_clamped(col, rowids), value, op) & (idx < count)
    pos, new_count = compact_mask_positions(m)
    return compact(rowids, pos), new_count


def filter_full(col: torch.Tensor, count, value, op: int, pad: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First filter on a pristine slot: scan the column directly (the
    live set is still the identity). Returns (rowids padded or cut to
    `pad`, new count)."""
    n = col.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=col.device)
    m = _compare(col, value, op) & (idx < count)
    pos, new_count = compact_mask_positions(m)
    rows = compact(idx, pos)
    if pad > n:
        rows = torch.nn.functional.pad(rows, (0, pad - n))
    else:
        rows = rows[:pad]
    return rows, new_count
