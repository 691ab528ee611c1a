"""Stable stream compaction: keep masked elements, preserve order
(counterpart: radixhashjoin_tpu/ops/compact.py:17,30).

An inclusive scan of the keep mask gives each survivor its destination
and one scatter writes them; the output keeps the input's padded length
and the live count shrinks. Dropped elements aim at position n, a spare
slot past the end that is cut off (a CUDA scatter with an out-of-range
index device-asserts, so nothing may aim outside the buffer). The same
scatter compacts the wave-batched path's (k, P) intermediate matrix
column-wise.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compact_mask_positions(mask: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions int32[n], count 0-d int32) for a stable compaction by
    `mask`: positions[i] = destination if mask[i] else n."""
    n = mask.shape[0]
    inc = torch.cumsum(mask, 0, dtype=torch.int32)
    count = inc[-1] if n else torch.zeros((), dtype=torch.int32,
                                          device=mask.device)
    return torch.where(mask, inc - 1, n), count


def compact(arr: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Scatter arr along its last axis to the positions from
    compact_mask_positions; every other lane of the result is 0, and a
    position outside [0, n) drops its element. A (k, P) intermediate
    matrix compacts all k rows by one mask, like the reference's
    `zeros_like(mat).at[:, pos].set(mat, mode="drop")` (ops/chain.py:36)."""
    n = arr.shape[-1]
    pos = torch.where((pos >= 0) & (pos < n), pos, n)
    out = torch.zeros(*arr.shape[:-1], n + 1, dtype=arr.dtype,
                      device=arr.device)
    out.index_copy_(arr.dim() - 1, pos.long(), arr)
    return out[..., :n]
