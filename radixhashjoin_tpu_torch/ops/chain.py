"""Row-filter operators over the 2-D intermediate matrix (counterpart:
radixhashjoin_tpu/ops/chain.py:25-48).

The wave-batched path's intermediate is one int32 (k, P) matrix: row j
holds the rowid column of the j-th joined slot, columns past the live
count are padding. The pure row-filter cases:

  case 3 / joined same-slot — eq_filter_matrix: stable compaction of all
      matrix rows by a column-equality predicate
  fresh same-slot — eq_filter_rows: live rowids where the two columns
      are equal
"""

from __future__ import annotations

import torch

from .compact import compact, compact_mask_positions
from .filter import gather_clamped


def eq_filter_matrix(colA: torch.Tensor, colB: torch.Tensor,
                     inter_mat: torch.Tensor, i1: int, i2: int, count):
    """Keep intermediate columns where the two gathered values are equal.
    Returns (new_mat, new_count)."""
    n = inter_mat.shape[1]
    idx = torch.arange(n, dtype=torch.int32, device=inter_mat.device)
    m = ((gather_clamped(colA, inter_mat[i1])
          == gather_clamped(colB, inter_mat[i2])) & (idx < count))
    pos, cnt = compact_mask_positions(m)
    return compact(inter_mat, pos), cnt


def eq_filter_rows(colA: torch.Tensor, colB: torch.Tensor,
                   rows: torch.Tensor, count):
    """Fresh same-slot predicate: live rowids where colA == colB."""
    n = rows.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=rows.device)
    m = ((gather_clamped(colA, rows) == gather_clamped(colB, rows))
         & (idx < count))
    pos, cnt = compact_mask_positions(m)
    return compact(rows, pos), cnt
