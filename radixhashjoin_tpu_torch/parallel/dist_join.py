"""Distributed equi-join: the level-0 radix exchange over the ranks
(counterpart: radixhashjoin_tpu/parallel/dist_join.py:38-210).

Level 0 routes every row to the rank that owns its key digit
(value mod world size) with one all_to_all of fixed per-destination
capacity; level 1 is each rank's local sort + searchsorted join over its
digit class. Both sides route by the same digit, so every match is
rank-local after the exchange.

Each function runs on every rank with that rank's shard: values (padded)
and a live count, which may differ by rank (a rank may hold no live row).
Capacity discipline: a destination bin holds `capacity` rows; rows past
it are dropped and counted, and the overflow (global, the largest over
the ranks) tells the caller to take the skew path or retry. The bins are
fixed-size on purpose: all_to_all_single's uneven split sizes must be
host ints, which would add a host sync to every exchange.

Sums are int64 and all_reduce'd, wrapping mod 2**64 (utils/limbs.py),
where the reference psums split 16-bit limbs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.join import RIGHT_SENTINEL
# int32 iotas as a broadcast add (torch.arange of 2^24 int32 takes
# 0.16 ms on an H100)
from ..ops.partition import _iota
from ..ops.radix_partition import partition_by_digit
from .mesh import Mesh

LEFT_SENTINEL = -1




def _bin_by_digit(vals: torch.Tensor, count, n_dest: int, capacity: int,
                  sentinel: int) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Scatter live rows into per-destination bins (n_dest, capacity),
    stable within a destination. Returns (bins, per-destination counts,
    per-destination overflow); lanes at or past `count` and lanes already
    holding the sentinel (rows the skew path parked) are dead."""
    n = vals.shape[0]
    live = (_iota(n, vals.device) < count) & (vals != sentinel)
    digit = torch.where(live, vals % n_dest, n_dest).to(torch.int32)
    (vp,), hist, offs = partition_by_digit(digit, (vals,), n_dest)
    j = _iota(capacity, vals.device)[None, :]
    src = (offs[:, None] + j).clamp(0, max(n - 1, 0))
    counts = torch.minimum(hist, torch.tensor(capacity, dtype=torch.int32,
                                              device=vals.device))
    bins = torch.where(j < counts[:, None], vp[src.long()], sentinel)
    overflow = (hist - capacity).clamp_min(0)
    return bins, counts, overflow


def _exchange(mesh: Mesh, bins: torch.Tensor, counts: torch.Tensor):
    """all_to_all: row d of my bins goes to rank d; returns the rows by
    source rank and their live counts, in ONE collective (the counts
    ride as an extra column)."""
    cap = bins.shape[1]
    recv = mesh.all_to_all(torch.cat([bins, counts[:, None]], 1))
    return recv[:, :cap], recv[:, cap]


def _flatten_valid(recv: torch.Tensor, recv_counts: torch.Tensor,
                   sentinel: int) -> torch.Tensor:
    """(n_src, capacity) -> flat values with dead lanes set to sentinel."""
    col = _iota(recv.shape[1], recv.device)[None, :]
    return torch.where(col < recv_counts[:, None], recv,
                       sentinel).reshape(-1)


def radix_exchange(mesh: Mesh, lvals, lcount, rvals, rcount, n_dest: int,
                   capacity: int):
    """Level-0 exchange of both join sides: this rank's flat values after
    the exchange (dead lanes sentineled), and the largest per-destination
    overflow of this rank's bins (rank-local; callers reduce it)."""
    lbins, lcnts, lovf = _bin_by_digit(lvals, lcount, n_dest, capacity,
                                       LEFT_SENTINEL)
    rbins, rcnts, rovf = _bin_by_digit(rvals, rcount, n_dest, capacity,
                                       RIGHT_SENTINEL)
    lrecv, lrc = _exchange(mesh, lbins, lcnts)
    rrecv, rrc = _exchange(mesh, rbins, rcnts)
    lflat = _flatten_valid(lrecv, lrc, LEFT_SENTINEL)
    rflat = _flatten_valid(rrecv, rrc, RIGHT_SENTINEL)
    return lflat, rflat, torch.maximum(lovf.max(), rovf.max())


def _local_join_count_sum(lflat: torch.Tensor, rflat: torch.Tensor):
    """Rank-local join over sentineled flat values: (pair count, sum over
    pairs of the left value), both int64 (sort + searchsorted level 1)."""
    rs = torch.sort(rflat).values
    lo = torch.searchsorted(rs, lflat, side="left")
    hi = torch.searchsorted(rs, lflat, side="right")
    counts = hi - lo              # the left sentinel -1 matches nothing
    return counts.sum(), (counts * lflat.clamp_min(0).long()).sum()


def _digit_hist(mesh: Mesh, vals, count, n_dest: int) -> torch.Tensor:
    """Global per-digit histogram: local bincount + all_reduce."""
    live = _iota(vals.shape[0], vals.device) < count
    return mesh.all_reduce(_bincount(torch.where(live, vals % n_dest,
                                                 n_dest), n_dest))


def _bincount(digit: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int32[n_bins] counts of digits in [0, n_bins]; n_bins is dropped.
    index_add_ needs no host sync (torch.bincount reads the max back)."""
    out = torch.zeros(n_bins + 1, dtype=torch.int32, device=digit.device)
    out.index_add_(0, digit.to(torch.int32),
                   torch.ones_like(digit, dtype=torch.int32))
    return out[:n_bins]


def _global(mesh: Mesh, pairs, vsum, ovf):
    """(pairs, sum) summed and the overflow maxed over the ranks, as host
    ints: two collectives, one readback."""
    s = mesh.all_reduce(torch.stack([pairs, vsum]))
    o = mesh.all_reduce(ovf.to(torch.int64).reshape(1), "max")
    pairs, vsum, ovf = torch.cat([s, o]).tolist()
    return pairs, vsum, ovf


def dist_join_skewaware(mesh: Mesh, lvals, lcount, rvals, rcount,
                        capacity: int, heavy_fraction: float = 0.25):
    """Distributed equi-join with heavy-hitter handling: digits whose
    global right-side share exceeds `heavy_fraction` are not exchanged;
    their right rows are broadcast (all_gather) and joined against the
    left rows that stayed home, so each pair counts once, on its left
    row's rank. Light digits take the normal exchange. Returns global
    (pairs, sum of matched left values mod 2**64 as a signed int,
    light-path overflow)."""
    n = mesh.size
    dev = lvals.device
    ghist_r = _digit_hist(mesh, rvals, rcount, n)
    total_r = ghist_r.sum().clamp_min(1)
    # the reference's float32 product (python float x int32 array)
    heavy = ghist_r > (torch.tensor(heavy_fraction, dtype=torch.float32,
                                    device=dev) * total_r).to(torch.int32)
    live_l = _iota(lvals.shape[0], dev) < lcount
    live_r = _iota(rvals.shape[0], dev) < rcount
    heavy_l = heavy[torch.where(live_l, lvals, 0) % n] & live_l
    heavy_r = heavy[torch.where(live_r, rvals, 0) % n] & live_r
    lv_light = torch.where(live_l & ~heavy_l, lvals, LEFT_SENTINEL)
    rv_light = torch.where(live_r & ~heavy_r, rvals, RIGHT_SENTINEL)
    lflat, rflat, ovf = radix_exchange(mesh, lv_light, lcount, rv_light,
                                       rcount, n, capacity)
    pairs_l, sum_l = _local_join_count_sum(lflat, rflat)
    r_all = mesh.all_gather(torch.where(heavy_r, rvals,
                                        RIGHT_SENTINEL)).reshape(-1)
    pairs_h, sum_h = _local_join_count_sum(
        torch.where(heavy_l, lvals, LEFT_SENTINEL), r_all)
    return _global(mesh, pairs_l + pairs_h, sum_l + sum_h, ovf)


def dist_join_count_sum(mesh: Mesh, lvals, lcount, rvals, rcount,
                        capacity: int):
    """Distributed equi-join: global (pair count, sum of matched left
    values mod 2**64 as a signed int, overflow) — bin, all_to_all, local
    join, all_reduce."""
    lflat, rflat, ovf = radix_exchange(mesh, lvals, lcount, rvals, rcount,
                                       mesh.size, capacity)
    pairs, vsum = _local_join_count_sum(lflat, rflat)
    return _global(mesh, pairs, vsum, ovf)
