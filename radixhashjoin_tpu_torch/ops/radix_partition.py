"""Stable digit partition of aligned payloads (counterpart:
radixhashjoin_tpu/ops/radix_partition.py:28 partition_by_digit,
:43 radix_partition).

The distributed layer bins every exchange, gather and pair set by a
small digit (the destination rank) with `partition_by_digit`: one stable
reordering of the payloads by digit, the digit histogram, and each
digit's start. Dead lanes carry digit == n_bins and sort last, outside
the histogram.

On a CUDA tensor the reordering is ops/partition.py `partition_order`:
the rank kernel (csrc/radix.cu `rhj_rank_hist`) plus the table lookup
of csrc/tables.cu, which returns the histogram as well. On a CPU tensor
it is the plain version, a stable torch.sort plus a bincount. Both give
the permutation of JAX's `argsort(digit, stable=True)` exactly for
digits in [0, n_bins], the only digits the distributed layer makes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .partition import partition_order


def partition_order_torch(digit: torch.Tensor, n_bins: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `partition_order` for digits in [0, n_bins]:
    (order int32[n], hist int32[n_bins + 1])."""
    order = torch.sort(digit, stable=True).indices.to(torch.int32)
    hist = torch.bincount(digit.long(), minlength=n_bins + 1)
    return order, hist[:n_bins + 1].to(torch.int32)


def partition_by_digit(digit: torch.Tensor, payloads: Sequence[torch.Tensor],
                       n_bins: int):
    """Stably partition the payloads by an int32 digit vector in
    [0, n_bins] (n_bins = dead lanes, last). Returns (partitioned payloads
    tuple, hist int32[n_bins], offsets int32[n_bins])."""
    if digit.device.type == "cpu":
        order, hist = partition_order_torch(digit, n_bins)
    else:
        order, hist = partition_order(digit, n_bins)
    hist = hist[:n_bins]
    offsets = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    return tuple(p.index_select(0, order) for p in payloads), hist, offsets


def radix_partition(vals: torch.Tensor, rowids: torch.Tensor, count,
                    n_bins: int):
    """Stably partition (vals, rowids) by digit = vals & (n_bins - 1);
    lanes at or past `count` are dead and sort last. Returns (vals_part,
    rowids_part, hist, offsets), as the reference's."""
    idx = torch.arange(vals.shape[0], dtype=torch.int32, device=vals.device)
    digit = torch.where(idx < count, vals & (n_bins - 1), n_bins)
    (vp, rp), hist, offsets = partition_by_digit(digit.to(torch.int32),
                                                 (vals, rowids), n_bins)
    return vp, rp, hist, offsets
