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

The materialized fallback's weights (a match count times the deferred
multiplicities, models/batch.py) are int64 products: where the
reference's int32 product wraps past 2**31, the port's does not. Every
step is a ring operation mod 2**64 (int64 multiply and add wrap in two's
complement), so the folded sum is the exact u64 SUM for any weights.
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
    ends, exact mod 2**64 for any number of rows. The ends are picked as
    views and stacked: no host-to-device copy, so no host sync."""
    if not pairs:
        return torch.zeros(0, dtype=torch.int64, device=device)
    prod = torch.cat([p.to(torch.int64) for p, _w in pairs])
    prod.mul_(torch.cat([w.to(torch.int64) for _p, w in pairs]))
    ends = [0]
    for p, _w in pairs:
        ends.append(ends[-1] + p.shape[0])
    cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                    torch.cumsum(prod, 0)])
    at = torch.stack([cs[e] for e in ends])
    return at[1:] - at[:-1]


def weighted_partials(vals: torch.Tensor, weights: torch.Tensor, count
                      ) -> torch.Tensor:
    """int64[1]: exact u64 sum(vals * weights) over the live prefix
    (counterpart: radixhashjoin_tpu/utils/limbs.py:118, whose (5, 2)
    limb channels this one wrapped int64 replaces)."""
    idx = torch.arange(vals.shape[0], dtype=torch.int32, device=vals.device)
    return fold_segments([(torch.where(idx < count, vals, 0), weights)],
                         vals.device)


def combine_planes(parts: Sequence[Tuple[int, int]]) -> int:
    """Exact u64 SUM of a projected column from its planes' folded sums:
    parts = [(int64 sum, plane shift)]; each int64 reads back as the u64
    it encodes (x & (2**64 - 1)), and the shifted planes add mod 2**64."""
    total = 0
    for s, shift in parts:
        total += (int(s) & U64_MASK) << shift
    return total & U64_MASK


def combine_channels(seg: Sequence[int], channels) -> int:
    """Exact u64 of a fresh-side T-table sum (ops/terminal.py): one
    int64 per channel, each shifted by its channel's bit offset
    (counterpart: combine_fresh_partials / combine_fresh_w_partials)."""
    return combine_planes([(s, shift)
                           for s, (shift, _bits) in zip(seg, channels)])
