"""SUM projection over materialized rows (counterpart:
radixhashjoin_tpu/ops/aggregate.py:19-41).

The reference splits every value into 16-bit limbs because TPU lanes
are 32-bit (aggregate.py:19-28). The port folds in int64, as the
factorized path does (utils/limbs.py): planes are < 2**31 and a single
query's rows are < 2**31, so the int64 sum is exact; the host reads it
back as the u64 it is, and utils/limbs.combine_planes applies the plane
shifts mod 2**64.
"""

from __future__ import annotations

import torch

from .filter import gather_clamped


def _gather_partials(col: torch.Tensor, rows: torch.Tensor, count
                     ) -> torch.Tensor:
    """int64[1]: sum of col[rows[:count]], on the device."""
    idx = torch.arange(rows.shape[0], dtype=torch.int32, device=rows.device)
    vals = torch.where(idx < count, gather_clamped(col, rows), 0)
    return vals.sum(dtype=torch.int64).reshape(1)


def gather_partials_matrix(col: torch.Tensor, mat: torch.Tensor,
                           row_idx: int, count) -> torch.Tensor:
    """_gather_partials with the rows taken from an intermediate-matrix
    row (the wave-batched path's non-terminal projection)."""
    return _gather_partials(col, mat[row_idx], count)
