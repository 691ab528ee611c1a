"""Exact u64 SUMs in int64 (counterpart: radixhashjoin_tpu/utils/limbs.py:
147-244 weighted_partials_segments, 381-402 combine_weighted_segments).

The reference splits every product into 16-bit limbs and 11-bit pieces
because TPU vector lanes are 32-bit (limbs.py:1-10). Hopper has native
int64, so the port folds each projection plane directly:

    SUM = sum over rows of int64(plane[r]) * int64(weight[r])

Planes are < 2**31 and per-row weights are int32 under the planner's
overflow caps (models/batch.py:_ftree_caps), so every product is < 2**62
and exact. The int64 sum wraps mod 2**64 — exactly the reference's u64
semantics, whose host combine masks with 2**64 - 1 — and the host reads
each sum back as `int(x) & (2**64 - 1)`.

One wave folds all of its projections in one segmented pass (one
multiply, one prefix sum, one boundary gather), not one reduction per
projection.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

U64_MASK = (1 << 64) - 1


def fold_segments(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  device: torch.device) -> torch.Tensor:
    """int64[len(pairs)]: per (plane, weight) pair, sum(plane * weight)
    mod 2**64 (as a two's-complement int64). Segments lie back to back;
    a segment's sum is the difference of the wrapped prefix sums at its
    ends, exact mod 2**64 for any number of rows."""
    if not pairs:
        return torch.zeros(0, dtype=torch.int64, device=device)
    prod = torch.cat([p.to(torch.int64) for p, _w in pairs])
    prod.mul_(torch.cat([w.to(torch.int64) for _p, w in pairs]))
    ends = [0]
    for p, _w in pairs:
        ends.append(ends[-1] + p.shape[0])
    cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                    torch.cumsum(prod, 0)])
    bounds = torch.tensor(ends, dtype=torch.int64, device=device)
    return cs.index_select(0, bounds[1:]) - cs.index_select(0, bounds[:-1])


def combine_planes(parts: Sequence[Tuple[int, int]]) -> int:
    """Exact u64 SUM of a projected column from its planes' folded sums:
    parts = [(int64 sum, plane shift)]; each int64 reads back as the u64
    it encodes (x & (2**64 - 1)), and the shifted planes add mod 2**64."""
    total = 0
    for s, shift in parts:
        total += (int(s) & U64_MASK) << shift
    return total & U64_MASK
