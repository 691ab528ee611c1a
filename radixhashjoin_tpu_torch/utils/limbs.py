"""Exact u64 SUMs in int64 (counterpart: radixhashjoin_tpu/utils/limbs.py:
147-244 weighted_partials_segments, 250 weighted_partials_big, 381-402
combine_weighted_segments).

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
projection. A wave past _BIG_WAVE_ROWS rows (ops/factorized.py) folds
each projection in place instead, window by window
(weighted_partials_big): the concatenation would copy every plane.
Planes of huge nodes may be uint16 (models/device_catalog.py); every
fold widens them to int64, which zero-extends.

The materialized fallback's weights (a match count times the deferred
multiplicities, models/batch.py) are int64 products: where the
reference's int32 product wraps past 2**31, the port's does not. Every
step is a ring operation mod 2**64 (int64 multiply and add wrap in two's
complement), so the folded sum is the exact u64 SUM for any weights.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

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


def fold_window(vals: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """0-d int64: sum(vals * weights) mod 2**64 over one window. A uint16
    plane zero-extends in the widening to int64."""
    return torch.sum(vals.to(torch.int64) * weights.to(torch.int64))


# rows per window of weighted_partials_big and of every huge-node loop
# (ops/factorized.py _win_rows); read at call time so that tests can
# shrink it
_BIG_WINDOW_ROWS = 1 << 26


def weighted_partials_big(vals: torch.Tensor, counts=None, *,
                          weight_mask: Optional[torch.Tensor] = None,
                          weight_fn: Optional[Callable] = None,
                          also_any_positive: bool = False):
    """0-d int64: the exact u64 sum(vals * weight) mod 2**64 over a HUGE
    vector, window by window (counterpart: radixhashjoin_tpu/utils/
    limbs.py:250, whose (5, 3) limb fold this one int64 replaces), so that
    no full-length weight or product exists. Weight sources, one of:
      * counts — materialized int32 weights, sliced per window;
      * weight_fn(start, size) -> int32 weights of rows [start,
        start + size) (ops/factorized.py passes a lazy product of table
        lookups here).
    weight_mask (optional bool, same length): rows where it is False
    weigh 0, also per window. also_any_positive: also return
    any(weight > 0), a 0-d bool taken in the same loop (the root NULL
    flag), as (sum, anyp). The last window is a short one: an int64 sum
    needs no chunk alignment, so no row is folded twice. Lengths cap
    below 2**31 - _BIG_WINDOW_ROWS rows, as in the reference (its int32
    window addressing)."""
    if (counts is None) == (weight_fn is None):
        raise ValueError("give exactly one of counts and weight_fn")
    n = vals.shape[0]
    if n >= (1 << 31) - _BIG_WINDOW_ROWS:
        raise ValueError(
            f"weighted_partials_big caps at 2**31 - {_BIG_WINDOW_ROWS} "
            f"rows (int32 window addressing); got {n}")
    total = torch.zeros((), dtype=torch.int64, device=vals.device)
    anyp = torch.zeros((), dtype=torch.bool, device=vals.device)
    for start in range(0, n, _BIG_WINDOW_ROWS):
        size = min(_BIG_WINDOW_ROWS, n - start)
        c = (weight_fn(start, size) if weight_fn is not None
             else counts[start:start + size])
        if weight_mask is not None:
            c = torch.where(weight_mask[start:start + size], c, 0)
        if also_any_positive:
            anyp = anyp | torch.any(c > 0)
        total = total + fold_window(vals[start:start + size], c)
    return (total, anyp) if also_any_positive else total


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
