"""The distributed executor's operators (counterpart:
radixhashjoin_tpu/parallel/dist_ops.py:73-702).

Every function runs on every rank with that rank's data and issues the
same collectives in the same order; none reads a device value back.
Data layout (the reference's, one shard per rank):

  * relation columns and projection planes are ROW-SHARDED
    (DeviceCatalog row sharding): rank r owns global rowids
    [r * cap, (r + 1) * cap) of a relation, cap = shard_cap(rel), so a
    live-set rowid indexes its own rank's shard after subtracting the
    shard base;
  * live rowid sets and the (k, P) intermediate matrix are row-sharded
    too, each with a rank-local live count (a 0-d tensor). Intermediate
    rowids are GLOBAL (the case-1 exchange moves them across ranks), so
    a value gather through the intermediate rides `_dist_gather`, a
    request/response all_to_all pair routing each rowid to its owner.

Join strategy per chaining case:

  case 1 (both sides fresh): skew-aware level-0 exchange. Light digits
      route (value, rowid) pairs to their owner rank by all_to_all; a
      digit holding more than `heavy_frac` of the right rows broadcasts
      its right rows (all_gather) while its left rows stay home. A light
      left value never equals a heavy right value (their digits differ),
      so each pair is produced once, on one rank.
  case 2 (attach a fresh slot): broadcast join: the fresh side's
      (value, rowid) pairs are all_gather'ed in `bchunks` chunks and
      joined locally against the intermediate, which never moves.
  case 3 / same-slot: local row filters; the pair-set NULL rule needs
      the other side's values (all_gather) and a global OR.

Every chunked loop is software-pipelined (the port's form of the
reference's latency-hiding schedule,
radixhashjoin_tpu/parallel/dist_ops.py:115-121 and :386-396):
chunk k+1's collective is issued (Mesh async_op) before chunk k's is
waited for, so it flies while chunk k's consumer computes; never more
than two chunks of one loop are in flight, so chunking still shrinks
the transients to 1/K. Every rank issues the same collectives in the
same order, and nothing is read back between an issue and its wait.

Rank-local values that a host decision will read come back as such
(overflow flags, live counts, pair totals, sums): the executor makes
them global with one collective before any readback. The per-destination
capacities are fixed (a bounded capacity raises an overflow flag and the
caller retries x4), so no exchange needs a host-side split size.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops.chain import eq_filter_rows
from ..ops.compact import compact, compact_mask_positions
from ..ops.factorized import run_ftree_wave
from ..ops.filter import filter_live, gather_clamped
from ..ops.join import RIGHT_SENTINEL, _counts_to_cum, expand_pairs
# int32 iotas as a broadcast add (torch.arange of 2^24 int32 takes
# 0.16 ms on an H100)
from ..ops.partition import _iota
from ..ops.radix_partition import partition_by_digit
from ..utils.limbs import fold_window
from .dist_join import LEFT_SENTINEL, _bincount
from .mesh import Mesh


def _false(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=device)


def _searchsorted(sorted_vals, vals):
    """(lo, hi) int32 positions of vals in a sorted vector."""
    lo = torch.searchsorted(sorted_vals, vals, side="left", out_int32=True)
    hi = torch.searchsorted(sorted_vals, vals, side="right", out_int32=True)
    return lo, hi


def _stable_argsort(v: torch.Tensor) -> torch.Tensor:
    return torch.sort(v, stable=True).indices.to(torch.int32)


# ---- rank-local primitives ----

def _shard_base(mesh: Mesh, col: torch.Tensor) -> int:
    """Global rowid of this rank's first row of a column shard."""
    return mesh.rank * col.shape[0]


def _local_gather(mesh: Mesh, col: torch.Tensor, rows: torch.Tensor):
    """col[rows] for rowids in this rank's range (live sets)."""
    return gather_clamped(col, rows - _shard_base(mesh, col))


def _flat_probe(lv: torch.Tensor, rv: torch.Tensor):
    """Sentinel-aware local probe: lanes are dead iff lv == LEFT_SENTINEL
    / rv == RIGHT_SENTINEL, at any position. Returns (order, lo, offsets,
    cum, total)."""
    order = _stable_argsort(rv)
    lo, hi = _searchsorted(rv.index_select(0, order), lv)
    counts = torch.where(lv >= 0, hi - lo, 0)
    off, cum, total = _counts_to_cum(counts)
    return order, lo, off, cum, total


def _pipelined(issue, k_chunks: int, first=None):
    """Yield issue(k).wait() for k < k_chunks, issuing chunk k+1
    before chunk k is waited for: chunk k+1's collective flies while the
    caller consumes chunk k, and at most two chunks are in flight.
    `first`: chunk 0's Pending, where the caller issued it earlier to
    overlap its own compute."""
    pending = issue(0) if first is None else first
    for k in range(k_chunks):
        nxt = issue(k + 1) if k + 1 < k_chunks else None
        yield pending.wait()
        pending = nxt


def _dist_gather(mesh: Mesh, col, idxs, live, chunks: int = 1, cap: int = 0):
    """Gather a row-sharded column at GLOBAL rowids owned by any rank:
    (values, overflow). Rowid g lives on rank g // len(col). Dead lanes
    return garbage. The overflow is a rank-local bool, False whenever
    cap == 0; on overflow the values are garbage and the caller
    re-dispatches with a larger capacity.

    chunks > 1 splits the requests into K sub-gathers (K a power of two
    dividing the lane count, each >= 4096 lanes), so the request matrix
    shrinks to (ranks, m / K). cap > 0 bounds the per-destination request
    capacity: the matrix becomes (ranks, cap).

    Each sub-gather is a chain: bin by owner and issue the request
    all_to_all; wait, gather locally, issue the response all_to_all;
    wait and scatter. Chunk k+1's request is issued before chunk k's
    lands, so it flies while chunk k gathers, answers and scatters: at
    most two collectives (two chunks) in flight."""
    m = idxs.shape[0]
    k = 1
    while k * 2 <= chunks and m % (k * 2) == 0 and m // (k * 2) >= 4096:
        k *= 2
    c = m // k
    out = torch.empty(m, dtype=col.dtype, device=idxs.device)
    binned, ovfs = [], []

    def request(i):
        sl = slice(i * c, (i + 1) * c)
        pending, state, ovf = _gather_request(mesh, col, idxs[sl],
                                              live[sl], cap)
        binned.append(state)
        ovfs.append(ovf)
        return pending

    for i, req_r in enumerate(_pipelined(request, k)):
        resp = gather_clamped(col, (req_r - _shard_base(mesh, col))
                              .reshape(-1))
        ans = mesh.all_to_all(resp.view(req_r.shape))
        _gather_land(mesh.size, ans, *binned[i], out[i * c:(i + 1) * c])
        binned[i] = None
    ovf = ovfs[0]
    for o in ovfs[1:]:
        ovf = ovf | o
    return out, ovf


def _gather_request(mesh: Mesh, col, idxs, live, cap: int):
    """The first stage of one sub-gather: a stable partition of the
    requests by owner (the rank kernel on a card) and the issued request
    all_to_all. Returns (its Pending, the state _gather_land needs, the
    rank-local overflow)."""
    n = mesh.size
    m = idxs.shape[0]
    dev = idxs.device
    w = m if cap <= 0 or cap >= m else cap       # per-destination capacity
    dest = torch.where(live, idxs // col.shape[0], n).to(torch.int32)
    (ip, pp), hist, offs = partition_by_digit(dest, (idxs, _iota(m, dev)), n)
    src = (offs[:, None] + _iota(w, dev)[None, :]).clamp(0, m - 1)
    pending = mesh.all_to_all(ip[src.long()], async_op=True)  # (n, w) asks
    ovf = (hist > w).any() if w < m else _false(dev)
    return pending, (dest, pp, offs, w), ovf


def _gather_land(n: int, ans, dest, pp, offs, w: int, out):
    """The last stage of one sub-gather: my request to owner d at
    partitioned position k sits at ans[d, k - offs[d]]; scatter it back
    to the request's lane of `out`."""
    m = pp.shape[0]
    db = dest.index_select(0, pp).clamp(0, n - 1).long()
    k = _iota(m, pp.device)
    out[pp.long()] = ans[db, (k - offs[db]).clamp(0, w - 1).long()]


def _bin_pairs(vals, rows, n_dest: int, capacity: int, sentinel: int):
    """Stable per-destination binning of (value, rowid) pairs by digit
    (value mod n_dest); sentinel values are dead. Returns (value bins,
    rowid bins) of (n_dest, capacity) and the rank-local bin overflow
    (False when capacity covers every lane)."""
    n = vals.shape[0]
    live = vals != sentinel
    digit = torch.where(live, vals % n_dest, n_dest).to(torch.int32)
    (vp, rp), hist, offs = partition_by_digit(digit, (vals, rows), n_dest)
    j = _iota(capacity, vals.device)[None, :]
    src = (offs[:, None] + j).clamp(0, n - 1).long()
    valid = j < hist[:, None]
    vbins = torch.where(valid, vp[src], sentinel)
    rbins = torch.where(valid, rp[src], 0)
    ovf = (hist > capacity).any() if capacity < n else _false(vals.device)
    return vbins, rbins, ovf


def _pack_prefix(flags, cap: int, *arrs):
    """Stable-compact the flagged rows into the first `cap` lanes (the
    rest follow in order); returns the packed prefixes and whether more
    than cap rows were flagged."""
    packed, hist, _offs = partition_by_digit((~flags).to(torch.int32),
                                             arrs, 1)
    return tuple(a[:cap] for a in packed) + (hist[0] > cap,)


def _issue_pairs(mesh: Mesh, vals, rows, n_dest: int, capacity: int,
                 sentinel: int):
    """Bin (value, rowid) pairs and issue their all_to_all, ONE
    collective: (its Pending, for _landed_pairs; the rank-local bin
    overflow)."""
    vbins, rbins, ovf = _bin_pairs(vals, rows, n_dest, capacity, sentinel)
    return mesh.all_to_all(torch.stack([vbins, rbins], 1),
                           async_op=True), ovf


def _landed_pairs(rec):
    """This rank's flat (values, rowids) of a received (n, 2, cap)
    exchange, dead lanes sentineled in values."""
    return rec[:, 0].reshape(-1), rec[:, 1].reshape(-1)


def _heavy_digits(mesh: Mesh, rv, n: int, heavy_frac: float):
    """Global right-side digit histogram (all_reduce of local counts) ->
    the heavy-digit mask."""
    digit = torch.where(rv != RIGHT_SENTINEL, rv % n, n)
    ghist = mesh.all_reduce(_bincount(digit, n))
    total = ghist.sum().clamp_min(1)
    # the reference's float32 product (python float x int32 array); a
    # fill, not torch.tensor, whose host-to-device copy synchronizes
    frac = torch.full((), heavy_frac, dtype=torch.float32, device=rv.device)
    return ghist > (frac * total).to(torch.int32)


def _mask_heavy(vals, heavy, n: int, sentinel: int, keep_heavy: bool):
    live = vals != sentinel
    h = heavy[torch.where(live, vals % n, 0).long()] & live
    keep = h if keep_heavy else (live & ~h)
    return torch.where(keep, vals, sentinel)


def _chunk_count(total: int, chunks: int) -> int:
    """Largest power-of-two chunk count <= chunks dividing total."""
    k = max(min(chunks, total), 1)
    while total % k:
        k //= 2
    return k


# ---- the operators ----

def d_seed(mesh: Mesh, nrows: int, cap: int, device):
    """A slot's live set: this rank's rowids [r * cap, (r + 1) * cap) (the
    relation's column shard ranges) and its live count."""
    rows = mesh.rank * cap + _iota(cap, device)
    cnt = min(max(nrows - mesh.rank * cap, 0), cap)
    return rows, torch.tensor(cnt, dtype=torch.int32, device=device)


def d_filter(mesh: Mesh, opc: int, rows, cnt, col, const: int):
    """Local filter of this rank's live set (live rowids are in the rank's
    range). Returns (rows', count'); the query is NULL iff the counts sum
    to 0 over the ranks (the executor's end-of-query reduction)."""
    base = _shard_base(mesh, col)
    r, c = filter_live(rows - base, cnt, col, const, opc)
    return r + base, c


def d_eq_rows(mesh: Mesh, colA, colB, rows, cnt):
    """Fresh same-slot predicate: local row filter -> (1, P) intermediate
    (both columns are shards of the same relation)."""
    base = _shard_base(mesh, colA)
    r, c = eq_filter_rows(colA, colB, rows - base, cnt)
    return (r + base)[None], c


def d_eq_mat(mesh: Mesh, i1: int, i2: int, null_flag: bool, colA, colB,
             mat, icnt, gchunks: int = 1, gcap: int = 0, bchunks: int = 1):
    """Case 3 / joined same-slot: local row filter of the intermediate,
    both value gathers through _dist_gather (intermediate rowids are
    global). Returns (mat', count', overflow) and, with null_flag, a
    rank-local `found` in the middle: the query is NULL iff no rank finds
    a pair (Query.cpp:188-191), tested against every rank's values in
    `bchunks` all_gather chunks."""
    w = mat.shape[1]
    live = _iota(w, mat.device) < icnt
    v1, o1 = _dist_gather(mesh, colA, mat[i1], live, gchunks, gcap)
    v2, o2 = _dist_gather(mesh, colB, mat[i2], live, gchunks, gcap)
    pos, cnt = compact_mask_positions((v1 == v2) & live)
    out = compact(mat, pos)
    if not null_flag:
        return out, cnt, o1 | o2
    v2s = torch.where(live, v2, RIGHT_SENTINEL)
    K = _chunk_count(w, bchunks)
    ck = w // K

    def issue(k):
        return mesh.all_gather(v2s[k * ck:(k + 1) * ck], async_op=True)
    first = issue(0)                    # flies while v1 sorts
    v1sorted = torch.sort(torch.where(live, v1, LEFT_SENTINEL)).values
    found = _false(mat.device)
    for g in _pipelined(issue, K, first):
        v2c = g.reshape(-1)
        lo, hi = _searchsorted(v1sorted, v2c)
        found = found | ((hi > lo) & (v2c != RIGHT_SENTINEL)).any()
    return out, cnt, found, o1 | o2


def d_case1_probe(mesh: Mesh, heavy_frac: float, chunks: int, colA, colB,
                  lrows, lc, rrows, rc, ecap: int = 0):
    """Case-1 probe: skew-aware level-0 exchange of (value, rowid) pairs,
    then the rank-local sentinel probe. Returns (Lrow, Rrow, order, lo,
    off, cum, total, stats) with stats = int64[3] rank-local
    [-total, total, exchange overflow], to be max-reduced: [-min, max,
    any overflow] (min < 0: a rank's pairs exceed 2**31 - 1).

    ecap > 0 bounds every exchange buffer (histogram-sized transients):
    the right light exchange sends at most ecap pairs a destination, the
    heavy broadcast packs each rank's heavy rows into an ecap prefix, and
    each of the K left sub-exchanges bounds at ecap / K; a truncated bin
    raises the overflow. ecap == 0 keeps the worst-case sizes.

    The left side is exchanged in K = `chunks` sub-exchanges, each probed
    against the sorted right side as it lands: chunk 0 flies while the
    right side sorts, chunk k+1 while chunk k probes. The pair multiset
    is the same for every K."""
    n = mesh.size
    dev = lrows.device
    capL, capR = lrows.shape[0], rrows.shape[0]
    lv = torch.where(_iota(capL, dev) < lc, _local_gather(mesh, colA, lrows),
                     LEFT_SENTINEL)
    rv = torch.where(_iota(capR, dev) < rc, _local_gather(mesh, colB, rrows),
                     RIGHT_SENTINEL)
    heavy = _heavy_digits(mesh, rv, n, heavy_frac)

    # right side first: exchange the light digits, broadcast the heavy
    rv_light = _mask_heavy(rv, heavy, n, RIGHT_SENTINEL, False)
    rcap = min(ecap, capR) if ecap else capR
    rx, rovf = _issue_pairs(mesh, rv_light, rrows, n, rcap, RIGHT_SENTINEL)
    rv_heavy = _mask_heavy(rv, heavy, n, RIGHT_SENTINEL, True)
    if ecap and ecap < capR:
        hv, hr, hovf = _pack_prefix(rv_heavy != RIGHT_SENTINEL, ecap,
                                    rv_heavy, rrows)
    else:
        hv, hr, hovf = rv_heavy, rrows, _false(dev)
    hx = mesh.all_gather(torch.stack([hv, hr]), async_op=True)  # (n, 2, h)

    # the left light rows in K sub-exchanges (the heavy left rows stay):
    # chunk 0 is issued before the right side's sort and flies while it
    # runs; chunk k+1 flies while chunk k probes
    lv_light = _mask_heavy(lv, heavy, n, LEFT_SENTINEL, False)
    lv_heavy = _mask_heavy(lv, heavy, n, LEFT_SENTINEL, True)
    K = max(min(chunks, capL), 1)
    while capL % K:
        K //= 2
    ck = capL // K
    lecap = min(max(ecap // K, 1), ck) if ecap else ck
    eovfs = [rovf, hovf]

    def issue(k):
        sl = slice(k * ck, (k + 1) * ck)
        pending, ovf = _issue_pairs(mesh, lv_light[sl], lrows[sl], n, lecap,
                                    LEFT_SENTINEL)
        eovfs.append(ovf)
        return pending
    first = issue(0)

    rfv, rfr = _landed_pairs(rx.wait())
    rg = hx.wait()
    R = torch.cat([rfv, rg[:, 0].reshape(-1)])
    Rrow = torch.cat([rfr, rg[:, 1].reshape(-1)])
    order = _stable_argsort(R)
    rs = R.index_select(0, order)

    lrow_segs, los, cnts = [], [], []

    def probe(lfv, lfr):
        lo_k, hi_k = _searchsorted(rs, lfv)
        lrow_segs.append(lfr)
        los.append(lo_k)
        cnts.append(torch.where(lfv >= 0, hi_k - lo_k, 0))
    for rec in _pipelined(issue, K, first):
        probe(*_landed_pairs(rec))
    probe(lv_heavy, lrows)
    off, cum, total = _counts_to_cum(torch.cat(cnts))
    eovf = torch.stack(eovfs).any().to(torch.int64)
    t64 = total.to(torch.int64)
    stats = torch.stack([-t64, t64, eovf])
    return (torch.cat(lrow_segs), Rrow, order, torch.cat(los), off, cum,
            total, stats)


def d_case1_expand(out_cap: int, Lrow, Rrow, order, lo, off, cum):
    """This rank's pairs as a fresh (2, out_cap) intermediate (lanes past
    the rank's total are garbage, masked by its count downstream)."""
    li, ri = expand_pairs(order, lo, off, cum, out_cap)
    return torch.stack([Lrow.index_select(0, li), Rrow.index_select(0, ri)])


def _fresh_vals(mesh: Mesh, col_fresh, frows, fc):
    """Sentinel-padded fresh-side values (rank-local live rowids)."""
    live = _iota(frows.shape[0], frows.device) < fc
    return torch.where(live, _local_gather(mesh, col_fresh, frows),
                       RIGHT_SENTINEL)


def d_case2_probe(mesh: Mesh, full_row: int, col_full, mat, icnt,
                  col_fresh, frows, fc, gchunks: int = 1, gcap: int = 0,
                  bchunks: int = 1):
    """Case-2 probe: broadcast the (filtered) fresh side in `bchunks`
    all_gather chunks and probe the intermediate locally; only per-lane
    match counts survive the loop (d_case2_expand gathers again). Returns
    (lv, off, cum, total, stats), stats = int64[3] rank-local [-total,
    total, gather overflow] to be max-reduced."""
    w = mat.shape[1]
    live = _iota(w, mat.device) < icnt
    gv, ovf = _dist_gather(mesh, col_full, mat[full_row], live, gchunks, gcap)
    lv = torch.where(live, gv, LEFT_SENTINEL)
    fv = _fresh_vals(mesh, col_fresh, frows, fc)
    capF = frows.shape[0]
    K = _chunk_count(capF, bchunks)
    ck = capF // K
    counts = torch.zeros(w, dtype=torch.int32, device=mat.device)
    for g in _pipelined(lambda k: mesh.all_gather(
            fv[k * ck:(k + 1) * ck], async_op=True), K):
        fs = torch.sort(g.reshape(-1)).values
        lo, hi = _searchsorted(fs, lv)
        counts += torch.where(lv >= 0, hi - lo, 0)
    off, cum, total = _counts_to_cum(counts)
    t64 = total.to(torch.int64)
    return lv, off, cum, total, torch.stack([-t64, t64, ovf.to(torch.int64)])


def d_case2_expand(mesh: Mesh, out_cap: int, mat, lv, col_fresh, frows, fc,
                   off, bchunks: int = 1):
    """Replicate each intermediate column per fresh match and append the
    fresh rowid row. Gathers the fresh side again in d_case2_probe's
    chunks; chunk k's matches of lane L land at [running_k[L],
    running_k[L] + counts_k[L]), running_k = off + the counts of earlier
    chunks: non-overlapping and rising in L, so expand_pairs' owner
    search is exact per chunk and positions outside chunk k's runs are
    masked."""
    fv = _fresh_vals(mesh, col_fresh, frows, fc)
    capF = frows.shape[0]
    K = _chunk_count(capF, bchunks)
    ck = capF // K
    dev = mat.device
    kpos = _iota(out_cap, dev)
    li_f = torch.zeros(out_cap, dtype=torch.int32, device=dev)
    fr_f = torch.zeros(out_cap, dtype=torch.int32, device=dev)
    running = off
    for g in _pipelined(lambda k: mesh.all_gather(torch.stack(
            [fv[k * ck:(k + 1) * ck], frows[k * ck:(k + 1) * ck]]),
            async_op=True), K):
        fv_c, frow_c = g[:, 0].reshape(-1), g[:, 1].reshape(-1)
        order_k = _stable_argsort(fv_c)
        lo_k, hi_k = _searchsorted(fv_c.index_select(0, order_k), lv)
        counts_k = torch.where(lv >= 0, hi_k - lo_k, 0)
        li_k, ri_k = expand_pairs(order_k, lo_k, running, running + counts_k,
                                  out_cap)
        within = kpos - running.index_select(0, li_k)
        valid = (within >= 0) & (within < counts_k.index_select(0, li_k))
        li_f = torch.where(valid, li_k, li_f)
        fr_f = torch.where(valid, frow_c.index_select(0, ri_k), fr_f)
        running = running + counts_k
    return torch.cat([mat.index_select(1, li_f), fr_f[None]])


def d_project(mesh: Mesh, row: int, plane, mat, icnt, gchunks: int = 1,
              gcap: int = 0):
    """This rank's exact sum of plane[mat[row]] over its live prefix, an
    int64 that wraps mod 2**64, and the rank-local gather overflow; the
    executor sums both over the ranks."""
    w = mat.shape[1]
    live = _iota(w, mat.device) < icnt
    gv, ovf = _dist_gather(mesh, plane, mat[row], live, gchunks, gcap)
    return fold_window(torch.where(live, gv, 0), live), ovf


def d_ftree(mesh: Mesh, wspecs, node_rows, node_caps, cols, vals,
            scatter: str = "auto", gather: str = "auto"
            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Whole factorized queries over the row-sharded catalog
    (ops/factorized.py run_ftree_wave with a mesh): node columns arrive as
    this rank's shards, every level's message table becomes global with
    one all_reduce, and every lookup stays local. Returns GLOBAL (flags,
    int64 sums), made global by one all_reduce for the wave.

    node_rows / node_caps: per spec, each node's relation row count and
    shard capacity (DeviceCatalog.shard_cap), for the validity masks."""
    valid = []
    for rows, caps in zip(node_rows, node_caps):
        def valid_rows(i, rows=rows, caps=caps):
            gid = mesh.rank * caps[i] + _iota(caps[i], mesh.device)
            return gid < rows[i]
        valid.append(valid_rows)
    return run_ftree_wave(wspecs, cols, vals, scatter, gather, mesh=mesh,
                          valid=valid)
