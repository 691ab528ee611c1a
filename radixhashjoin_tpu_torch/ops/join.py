"""Equi-join as sort + binary search + expansion (counterpart:
radixhashjoin_tpu/ops/join.py:30-139).

The sort backend's join (models/batch.py's per-op path): a stable sort of
the right side and two binary searches of every left value into it give
each left value its first match in the sorted right side and its match
count; the host reads the exact pair total back, picks a padded output
size, and `expand_pairs` materializes (left index, right index) pairs at
that size.

`probe_gather_count` is the batch driver's probe: on a CUDA tensor the
right side's gather, mask and sort stay PyTorch and everything from the
left gather to the total is one launch of the hand-written probe kernel
(csrc/probe.cu, kernels.probe_cuda), with no fallback; on the CPU it is
`probe_count` on the gathered values, the plain version the tests hold
against the JAX package.

The reference sorts the combined [right, left] values once and scatters
the results back to operand order, because on the TPU a search is
itself a sort of both sides. Here a search is a plain binary search (the
probe kernel's on the card, torch.searchsorted on the CPU), and the
joins' right side is a dimension whose sorted values sit in L2: so only
the right side is sorted, the left lanes are only looked up, and nothing
is scattered back. The outputs are the reference's, bit for bit.

Padding sentinels: left values -1 (match nothing, all data >= 0), right
values INT32_MAX (the catalog keeps data <= INT32_MAX - 1).

The sorts are `torch.sort(..., stable=True)`: the reference's
`jnp.argsort(stable=True)` is XLA's comparison sort outside any Pallas
kernel, and PyTorch's CUDA sort is not stable by default (then `order`
differs on ties). Where the reference takes a running max over sorted
data, the port binary-searches the sorted data for the same values:
torch.cummax runs a 1-D tensor as one block on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .filter import gather_clamped

RIGHT_SENTINEL = 2**31 - 1
_INT32_MAX = 2**31 - 1


class JoinCapacityError(RuntimeError):
    """A single join's output exceeds 2**31 - 1 pairs (the int32 offset
    space of the reference, kept in the port). The executor raises this
    diagnostic instead of overflowing."""


def _total_or_overflow(cum64: torch.Tensor) -> torch.Tensor:
    """The pair total as a 0-d int32, or -1 above 2**31 - 1. The prefix
    sums run in int64 here (torch.cumsum promotes), so the overflow test
    is on the true total: the reference detects the same condition as
    its int32 prefix sums wrapping negative."""
    last = cum64[-1]
    return torch.where(last > _INT32_MAX, -1, last).to(torch.int32)


def _counts_to_cum(counts: torch.Tensor):
    """(offsets, cum, total) of int32 per-left counts; offsets and cum
    are int32, and wrap mod 2**32 past 2**31 - 1 exactly as the
    reference's int32 scans do (only `total` is read then)."""
    cum64 = torch.cumsum(counts, 0, dtype=torch.int64)
    return ((cum64 - counts).to(torch.int32), cum64.to(torch.int32),
            _total_or_overflow(cum64))


def probe_count(lvals: torch.Tensor, lcount, rvals: torch.Tensor, rcount):
    """Count matches per left element: one stable sort of the masked
    right values, and a left and a right binary search of every masked
    left value into them.

    Returns (order, lo, offsets, cum, total):
      order   — int32[R] stable argsort of the (sentinel-masked) right values
      lo      — int32[L] first match position of each left value in sorted right
      offsets — int32[L] exclusive cumsum of per-left match counts
      cum     — int32[L] inclusive cumsum (cum[-1] == total)
      total   — 0-d int32: exact number of output pairs, or -1 if the join
                exceeds 2**31 - 1 pairs (callers raise JoinCapacityError)
    """
    li = torch.arange(lvals.shape[0], dtype=torch.int32, device=lvals.device)
    lv = torch.where(li < lcount, lvals, -1)
    order, rs = _sorted_right(rvals, rcount)
    lo = torch.searchsorted(rs, lv, side="left", out_int32=True)
    counts = torch.searchsorted(rs, lv, side="right", out_int32=True) - lo
    offsets, cum, total = _counts_to_cum(counts)
    return order, lo, offsets, cum, total


def _sorted_right(rvals: torch.Tensor, rcount):
    """(order, sorted values) of the right side, lanes past rcount masked
    to RIGHT_SENTINEL: int32 stable argsort and the values it sorts."""
    ri = torch.arange(rvals.shape[0], dtype=torch.int32, device=rvals.device)
    rv = torch.where(ri < rcount, rvals, RIGHT_SENTINEL)
    rs, ridx = torch.sort(rv, stable=True)
    return ridx.to(torch.int32), rs


def probe_gather_count(col_l: torch.Tensor, lrows: torch.Tensor, lcount,
                       col_r: torch.Tensor, rrows: torch.Tensor, rcount):
    """probe_count of the sides' gathered values, `col_l[lrows]` and
    `col_r[rrows]` (clamped gathers): the same (order, lo, offsets, cum,
    total). On a CUDA tensor one launch of the probe kernel reads only
    the live left lanes and replaces the left gather, both searches and
    the scan; on the CPU it is probe_count itself."""
    rvals = gather_clamped(col_r, rrows)
    if col_l.device.type != "cuda":
        return probe_count(gather_clamped(col_l, lrows), lcount, rvals,
                           rcount)
    order, rs = _sorted_right(rvals, rcount)
    return (order, *kernels.probe_cuda(col_l, lrows, lcount, rs))


def expand_pairs(order: torch.Tensor, lo: torch.Tensor,
                 offsets: torch.Tensor, cum: torch.Tensor, out_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize pair k in [0, out_size): (left index, right index).

    Lanes past the true total produce clipped garbage — callers mask by
    the live count from probe_count. Ownership (which left element
    produces output k): the reference scatter-maxes each left index with
    matches at its first output position and fills the runs with a
    running max. The same owner is the first left whose inclusive prefix
    sum exceeds k, one binary search in the non-decreasing `cum`; a lane
    past the total gets the last owner, as the running max gives it."""
    dev = lo.device
    k = torch.arange(out_size, dtype=torch.int32, device=dev)
    last = (cum[-1] - 1).clamp_min(-1)
    left_of = torch.searchsorted(cum, torch.minimum(k, last), side="right")
    left_of = left_of.to(torch.int32)
    within = k - offsets.index_select(0, left_of)
    rpos = lo.index_select(0, left_of) + within
    rr = order.index_select(0, rpos.clamp(0, order.shape[0] - 1))
    return left_of, rr


def any_common(avals: torch.Tensor, bvals: torch.Tensor, count
               ) -> torch.Tensor:
    """0-d bool: True iff the live prefixes of a and b share any value —
    the reference's NULL rule for a both-joined step: the join's pair
    set must be non-empty even though the step only filters rows
    (Query.cpp:188-191)."""
    n = avals.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=avals.device)
    live = idx < count
    av = torch.where(live, avals, -1)
    bs = torch.sort(torch.where(live, bvals, RIGHT_SENTINEL)).values
    lo = torch.searchsorted(bs, av, side="left")
    hi = torch.searchsorted(bs, av, side="right")
    return ((hi > lo) & live).any()
