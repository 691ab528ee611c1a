"""Message-table build (weighted bincount) and lookup (counterpart:
radixhashjoin_tpu/ops/tables.py).

The factorized wave's two data-sized primitives:

    build:  B = zeros(n_bins); B[idxs] += weights   (out-of-range dropped)
    lookup: g = B[keys]                             (out-of-range -> 0)

The huge-node window loops build window by window into one running table
(`scatter_add_window`: the same build, adding into an accumulator), and
the dense probe looks two tables up with the same keys (`table_gather2`).

Two kinds of function live here:

* The hand-written Hopper kernels (csrc/tables.cu, bound by kernels.py)
  and their plain PyTorch versions (`weighted_bincount_torch`,
  `table_gather_torch`, `table_gather2_torch`). Dispatch follows the
  tensor's device and nothing else: a CPU tensor takes the plain version,
  a CUDA tensor launches the kernel or raises.
* The JAX package's other variants, each by JAX's algorithm in PyTorch
  ops that run on either device: the library scatter and gather
  (`weighted_bincount_xla`, `table_gather_xla`: index_add_ and
  index_select, the counterparts of XLA's fixed-function engines, which
  are also the kernels' plain versions), `weighted_bincount_sorted`,
  `weighted_bincount_mxu`, `weighted_bincount_hier`,
  `table_gather_onehot`, `table_gather_diffcum` and `table_gather_hier`.

`impl` names follow JAX's dispatch (tables.py:314-373, 409-435, 616-626),
including its fall-through to the engine for every name it does not
branch on, except that "auto" and "onehot" run the hand kernels:

    scatter_table       auto, onehot: kernel | mxu | hier | sorted | else xla
    scatter_add_window  auto, onehot: kernel | mxu | hier | hier_presorted
                        | else xla
    table_gather        auto, onehot: kernel | else xla
    table_gather2       auto, onehot: fused kernel | else two xla gathers
    table_gather_pairs  the fused kernel on a table of interleaved pairs

Every variant is exact under the callers' contract (weights >= 0, every
bin's total < 2**31). Where JAX's sums wrap int32, the port sums in int64
and casts a value that is in range, so nothing relies on int32 wrapping.
The one-hot variants never hold a whole one-hot: they walk the rows (or
blocks) in chunks whose one-hot stays near ONEHOT_CHUNK_BYTES. Where JAX
gates a spill pass with lax.cond(any(spill)), the port runs it
unconditionally: reading the flag would synchronize inside a round.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels

# the names that run the hand-written kernels (csrc/tables.cu)
KERNEL_IMPLS = ("auto", "onehot")

# JAX's widths: the one-hot build up to 4096 bins, the one-hot lookup up
# to 8192 entries (radixhashjoin_tpu/ops/tables.py:78-79)
MXU_SCATTER_MAX_BINS = 4096
ONEHOT_GATHER_MAX_BINS = 8192
# JAX's blocked sub-table sizes (:147-152, :467-468), read at call time
HIER_BLOCK_ROWS = 2048
HIER_SUB_WIDTH = 2048
HIER_GATHER_BLOCK_ROWS = 1024
HIER_GATHER_SUB_WIDTH = 1024
# bytes of one-hot a chunk of the one-hot variants holds (read at call
# time): 2^24 rows x 4096 bins would be 64 GiB in int8
ONEHOT_CHUNK_BYTES = 1 << 30


# ---- the hand kernels' plain versions, which are also the library calls ----

def weighted_bincount_torch(idxs: torch.Tensor, weights: torch.Tensor,
                            n_bins: int, out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain version of the build: int32[n_bins] weighted bincount with
    indices outside [0, n_bins) dropped, like the reference's
    `.at[idxs].add(weights, mode="drop")`, added into `out` when the
    caller passes an accumulator. index_add_ has no drop mode (on CUDA an
    out-of-range index device-asserts), so dropped rows land in a spare
    slot past the end."""
    ok = (idxs >= 0) & (idxs < n_bins)
    safe = torch.where(ok, idxs, n_bins)
    table = torch.zeros(n_bins + 1, dtype=torch.int32, device=idxs.device)
    table.index_add_(0, safe, weights.to(torch.int32))
    if out is None:
        return table[:n_bins]
    return out.add_(table[:n_bins])


def table_gather_torch(table: torch.Tensor, keys: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version of the lookup: table[keys], 0 where a key is outside
    [0, len(table))."""
    n_bins = table.shape[0]
    if n_bins == 0:
        return torch.zeros(keys.shape[0], dtype=torch.int32,
                           device=keys.device)
    ok = (keys >= 0) & (keys < n_bins)
    g = table.index_select(0, torch.where(ok, keys, 0))
    return torch.where(ok, g, 0)


def table_gather2_torch(table_a: torch.Tensor, table_b: torch.Tensor,
                        keys: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused double lookup: (table_a[keys],
    table_b[keys]), 0 where a key is outside [0, len(table_a))."""
    return table_gather_torch(table_a, keys), table_gather_torch(table_b,
                                                                 keys)


# JAX's weighted_bincount_xla (:119) and engine gather (:626): the library
# scatter and gather. Negative build indices are dropped where XLA's
# scatter wraps them (a declared divergence, ROADMAP.md §3).
weighted_bincount_xla = weighted_bincount_torch
table_gather_xla = table_gather_torch


# ---- helpers of the one-hot variants ----

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _chunk(n_items: int, item_bytes: int, multiple: int = 1) -> int:
    """Items a chunk holds within ONEHOT_CHUNK_BYTES of one-hot (at least
    one `multiple`)."""
    c = ONEHOT_CHUNK_BYTES // max(item_bytes, 1) // multiple * multiple
    return min(max(c, multiple), _round_up(max(n_items, 1), multiple))


def _pad_to(x: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    if x.shape[0] >= size:
        return x
    return torch.cat([x, x.new_full((size - x.shape[0],), fill)])


def _weight_limbs(w: torch.Tensor) -> torch.Tensor:
    """(..., 5) int32: w's 7-bit limbs, JAX's (w >> 7k) & 0x7F. They lie
    in 0..127, so an int8 or float32 copy holds them exactly."""
    return torch.stack([(w >> (7 * k)) & 0x7F for k in range(5)], dim=-1)


def _join_weight_limbs(bk: torch.Tensor) -> torch.Tensor:
    """int32 sum of bk[..., k] << 7k, summed in int64: every term is part
    of a bin total below 2**31, so the cast is exact."""
    bk = bk.to(torch.int64)
    out = bk[..., 0]
    for k in range(1, 5):
        out = out + (bk[..., k] << (7 * k))
    return out.to(torch.int32)


def _table_bytes(t: torch.Tensor) -> torch.Tensor:
    """(..., 4) int32: t's bytes, low first; the three low ones in 0..255
    and the top one signed (t >> 24, in -128..127), so one byte of a
    one-hot row's single match comes back exactly from any product."""
    return torch.stack([(t >> 0) & 0xFF, (t >> 8) & 0xFF, (t >> 16) & 0xFF,
                        t >> 24], dim=-1)


def _join_bytes(g: torch.Tensor) -> torch.Tensor:
    """int32 value of the bytes g[..., 0:4] (_table_bytes' layout; JAX
    masks each to 8 bits after its int8 matmul, which a byte of 128..255
    comes out of as a negative number): summed in int64, the top byte
    signed, so the result is the table's int32 value and the cast exact."""
    g = g.to(torch.int64)
    out = ((g[..., 0] & 0xFF) + ((g[..., 1] & 0xFF) << 8)
           + ((g[..., 2] & 0xFF) << 16))
    top = g[..., 3] & 0xFF
    return (out + (torch.where(top >= 128, top - 256, top) << 24)).to(
        torch.int32)


def _as_int8(x: torch.Tensor) -> torch.Tensor:
    """int8 copy of values in -128..255, 128..255 sign-wrapped explicitly
    (JAX's astype(int8) wraps them)."""
    return torch.where(x >= 128, x - 256, x).to(torch.int8)


def _int8_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """int32[m, n] = a @ b_t.T for int8 a [m, k] (row-major) and b_t
    [n, k] (row-major, so b_t.T is column-major), int32 accumulation:
    torch._int_mm, which on CUDA takes m > 16 and k and n multiples of 8
    (the callers pad)."""
    return torch._int_mm(a, b_t.t())


# ---- builds ----

def weighted_bincount_sorted(idxs: torch.Tensor, weights: torch.Tensor,
                             n_bins: int) -> torch.Tensor:
    """Scatter-free weighted bincount (JAX :241): one carrying sort (a
    sort of the keys and a gather of the weights), a running sum, ONE
    searchsorted of the n_bins + 1 bin edges, and boundary differences.
    JAX's int32 cumsum wraps and its differences undo the wrap; here the
    sum is int64 (torch.cumsum of int32 is int64 anyway) and each
    difference, a bin total below 2**31, casts exactly. Out-of-range
    keys sort outside the edges and drop."""
    if n_bins == 0:
        return torch.zeros(0, dtype=torch.int32, device=idxs.device)
    sk, order = torch.sort(idxs)
    sw = weights.to(torch.int64).index_select(0, order)
    cum = torch.cat([sw.new_zeros(1), torch.cumsum(sw, 0)])
    edges = torch.arange(n_bins + 1, dtype=sk.dtype, device=sk.device)
    bounds = torch.searchsorted(sk, edges)
    return (cum[bounds[1:]] - cum[bounds[:-1]]).to(torch.int32)


def weighted_bincount_mxu(idxs: torch.Tensor, weights: torch.Tensor,
                          n_bins: int) -> torch.Tensor:
    """One-hot build (JAX :124): B_k = onehot(idx)^T @ 7-bit weight limb
    k, an int8 matmul with int32 accumulation (torch._int_mm), recombined
    with shifts. The rows go in chunks of near ONEHOT_CHUNK_BYTES of
    one-hot, each an [m, c] int8 one-hot (m = bins padded to a multiple
    of 8 and above 16, c rows a multiple of 8) times [c, 8] limbs (5 used,
    3 zero); the chunks accumulate in int32, which is exact because each
    bin's limb sum is at most its total (< 2**31). Out-of-range rows match
    no bin (they are set to -1 first, so the padded bins stay 0)."""
    dev = idxs.device
    n = idxs.shape[0]
    if n == 0 or n_bins == 0:
        return torch.zeros(n_bins, dtype=torch.int32, device=dev)
    m = max(_round_up(n_bins, 8), 24)
    k = _chunk(n, m, 8)
    idxs = torch.where((idxs >= 0) & (idxs < n_bins), idxs, -1)
    bins = torch.arange(m, dtype=idxs.dtype, device=dev)[:, None]
    acc = torch.zeros(m, 8, dtype=torch.int32, device=dev)
    for s in range(0, n, k):
        ic = _pad_to(idxs[s:s + k], k, -1)
        wc = _pad_to(weights[s:s + k].to(torch.int32), k, 0)
        limbs = torch.zeros(8, k, dtype=torch.int8, device=dev)
        limbs[:5] = _weight_limbs(wc).t()
        onehot = (bins == ic[None, :]).view(torch.int8)     # [m, k]
        acc += _int8_mm(onehot, limbs)
    return _join_weight_limbs(acc[:n_bins, :5])


def _blocked_build(local: torch.Tensor, wm: torch.Tensor,
                   sub_width: int) -> torch.Tensor:
    """int32[nb, sub_width]: block b's sub-table, sum of wm[b, r] over
    local[b, r] == j (JAX's batched one-hot limb matmul). Torch has no
    batched int8 GEMM on CUDA, so this is a float32 bmm, which is exact:
    the one-hot is 0/1, the limbs 0..127, and every per-block partial at
    most block_rows * 127 (260096 at 2048 rows) < 2**24 (TF32, were it on,
    holds such inputs exactly too). Blocks go in chunks of near
    ONEHOT_CHUNK_BYTES of float32 one-hot."""
    nb, rows = local.shape
    res = torch.empty(nb, sub_width, dtype=torch.int32, device=local.device)
    cb = _chunk(nb, rows * sub_width * 4)
    bins = torch.arange(sub_width, dtype=local.dtype,
                        device=local.device)[None, :, None]
    for s in range(0, nb, cb):
        onehot = (bins == local[s:s + cb, None, :]).float()   # (cb, sub, R)
        limbs = _weight_limbs(wm[s:s + cb]).float()           # (cb, R, 5)
        res[s:s + cb] = _join_weight_limbs(torch.bmm(onehot, limbs))
    return res


def weighted_bincount_hier(idxs: torch.Tensor, weights: torch.Tensor,
                           n_bins: int, block_rows: Optional[int] = None,
                           sub_width: Optional[int] = None,
                           presorted: bool = False) -> torch.Tensor:
    """Hierarchical build (JAX :155): one carrying sort groups the rows;
    every block of block_rows consecutive sorted rows builds a
    sub_width-wide sub-table anchored at its first key (_blocked_build),
    and the sub-tables add into the output as windows. Rows whose key
    leaves its block's window ("spill": low occupancy, or an imperfect
    order under presorted=True) are masked out of the blocks and added
    by the library scatter. Negative keys become the drop sentinel up
    front. presorted=True skips the sort: the caller promises
    non-decreasing keys (an unsorted input is still exact, through the
    spill). Windows anchored at or past n_bins hold only out-of-range
    rows; they are moved to start at n_bins, inside the pad region that
    is cut off (JAX drops them or lands them there)."""
    block_rows = HIER_BLOCK_ROWS if block_rows is None else block_rows
    sub_width = HIER_SUB_WIDTH if sub_width is None else sub_width
    dev = idxs.device
    n = idxs.shape[0]
    if n == 0 or n_bins == 0:
        return torch.zeros(n_bins, dtype=torch.int32, device=dev)
    idxs = torch.where(idxs < 0, n_bins, idxs)
    weights = weights.to(torch.int32)
    size = _round_up(n, block_rows)
    idxs = _pad_to(idxs, size, n_bins)
    weights = _pad_to(weights, size, 0)
    if presorted:
        sk, sw = idxs, weights
    else:
        sk, order = torch.sort(idxs)
        sw = weights.index_select(0, order)
    nb = size // block_rows
    skb = sk.view(nb, block_rows)
    swb = sw.view(nb, block_rows)
    bases = skb[:, 0]
    local = skb - bases[:, None]
    spill = (local < 0) | (local >= sub_width)
    blockres = _blocked_build(local, torch.where(spill, 0, swb), sub_width)
    lanes = torch.arange(sub_width, dtype=torch.int64, device=dev)
    pos = bases.clamp(max=n_bins).to(torch.int64)[:, None] + lanes
    out = torch.zeros(n_bins + sub_width, dtype=torch.int32, device=dev)
    out.index_add_(0, pos.view(-1), blockres.view(-1))
    out = out[:n_bins]
    return weighted_bincount_xla(torch.where(spill, skb, n_bins).view(-1),
                                 torch.where(spill, swb, 0).view(-1),
                                 n_bins, out=out)


# ---- lookups ----

def table_gather_onehot(table: torch.Tensor, keys: torch.Tensor
                        ) -> torch.Tensor:
    """One-hot lookup (JAX :382): onehot(keys) @ the table's four bytes,
    an int8 matmul with int32 accumulation (torch._int_mm). A one-hot row
    has one nonzero, so each output column is one signed byte, which
    _join_bytes puts back together. Keys go in chunks of near
    ONEHOT_CHUNK_BYTES of one-hot, each [c, k] int8 (k = entries padded to
    a multiple of 8 with zeros; c keys, above 16) times [k, 8] bytes (4
    used). Out-of-range keys match nothing and give 0."""
    dev = keys.device
    n, n_bins = keys.shape[0], table.shape[0]
    if n == 0 or n_bins == 0:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    k = _round_up(n_bins, 8)
    limbs = torch.zeros(8, k, dtype=torch.int8, device=dev)
    limbs[:4, :n_bins] = _as_int8(_table_bytes(table).t())
    c = max(_chunk(n, k, 8), 24)
    cols = torch.arange(k, dtype=keys.dtype, device=dev)[None, :]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    for s in range(0, n, c):
        kc = keys[s:s + c]
        rows = kc.shape[0]
        kc = _pad_to(kc, max(_round_up(rows, 8), 24), -1)
        onehot = (kc[:, None] == cols).view(torch.int8)        # [c, k]
        out[s:s + rows] = _join_bytes(_int8_mm(onehot, limbs)[:rows, :4])
    return out


def table_gather_diffcum(table: torch.Tensor, sk: torch.Tensor
                         ) -> torch.Tensor:
    """table[sk] for SORTED keys with no gather (JAX :437): the table's
    first differences scatter at each bin's first key (ONE searchsorted of
    the n_bins + 2 bin edges), and a running sum puts the values back.
    The differences and the sum are int64 (JAX's wrap in int32), so each
    value casts back exactly. Out-of-range keys (negative ones sort first,
    keys past the end clamp onto a zero entry) give 0."""
    dev = sk.device
    n, n_bins = sk.shape[0], table.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    tpad = torch.cat([table.to(torch.int64),
                      table.new_zeros(1, dtype=torch.int64)])
    skc = sk.clamp(max=n_bins)
    edges = torch.arange(n_bins + 2, dtype=sk.dtype, device=dev)
    bounds = torch.searchsorted(skc, edges)
    delta = tpad - torch.cat([tpad.new_zeros(1), tpad[:-1]])
    acc = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    acc.index_add_(0, bounds[:-1], delta)
    return torch.cumsum(acc[:n], 0).to(torch.int32)


def _blocked_lookup(lm: torch.Tensor, windows: torch.Tensor
                    ) -> torch.Tensor:
    """int32[nb, R]: windows[b, lm[b, r]] where 0 <= lm < sub_width, else
    0, as JAX's batched one-hot matmul of the windows' bytes: a float32
    bmm, exact because a one-hot row has one nonzero and a byte is below
    2**8. Blocks go in chunks of near ONEHOT_CHUNK_BYTES of one-hot."""
    nb, rows = lm.shape
    sub_width = windows.shape[1]
    res = torch.empty(nb, rows, dtype=torch.int32, device=lm.device)
    cb = _chunk(nb, rows * sub_width * 4)
    cols = torch.arange(sub_width, dtype=lm.dtype,
                        device=lm.device)[None, None, :]
    for s in range(0, nb, cb):
        onehot = (lm[s:s + cb, :, None] == cols).float()     # (cb, R, sub)
        limbs = _table_bytes(windows[s:s + cb]).float()      # (cb, sub, 4)
        res[s:s + cb] = _join_bytes(torch.bmm(onehot, limbs))
    return res


def table_gather_hier(table: torch.Tensor, sk: torch.Tensor,
                      block_rows: Optional[int] = None,
                      sub_width: Optional[int] = None) -> torch.Tensor:
    """table[sk] for SORTED keys by blocked one-hot lookups (JAX :478):
    each block of block_rows keys reads the sub_width-wide table window
    anchored at its first key (one contiguous slice a block) and looks
    its keys up with the one-hot matmul of _blocked_lookup. Keys that
    leave their block's window (low occupancy, unsorted input) or lie out
    of range take the library gather (out of range: the zero entry at
    n_bins), picked with torch.where. Exact for any input."""
    block_rows = (HIER_GATHER_BLOCK_ROWS if block_rows is None
                  else block_rows)
    sub_width = (HIER_GATHER_SUB_WIDTH if sub_width is None
                 else sub_width)
    dev = sk.device
    n, n_bins = sk.shape[0], table.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    sent = n_bins + sub_width              # past every window: spills
    sk2 = torch.where((sk < 0) | (sk > n_bins), sent, sk)
    size = _round_up(n, block_rows)
    sk2 = _pad_to(sk2, size, sent)
    nb = size // block_rows
    skb = sk2.view(nb, block_rows)
    bases = skb[:, 0].clamp(max=n_bins)    # sentinel blocks: zero pad
    local = skb - bases[:, None]
    spill = (local < 0) | (local >= sub_width)
    tpad = torch.cat([table.to(torch.int32),
                      table.new_zeros(sub_width + 1, dtype=torch.int32)])
    windows = tpad.unfold(0, sub_width, 1).index_select(0, bases)
    g = _blocked_lookup(torch.where(spill, sub_width, local), windows)
    g = g.view(-1)[:n]
    spill_n = spill.view(-1)[:n]
    safe = torch.where(spill_n, sk2[:n].clamp(max=n_bins), 0)
    return torch.where(spill_n, tpad.index_select(0, safe), g)


# ---- dispatch ----

def scatter_table(idxs: torch.Tensor, weights: torch.Tensor, n_bins: int,
                  impl: str = "auto") -> torch.Tensor:
    """B = zeros(n_bins); B[idxs] += weights, out-of-range dropped."""
    if impl in KERNEL_IMPLS:
        if idxs.device.type == "cpu":
            return weighted_bincount_torch(idxs, weights, n_bins)
        return kernels.weighted_bincount_cuda(idxs, weights, n_bins)
    if impl == "mxu":
        return weighted_bincount_mxu(idxs, weights, n_bins)
    if impl == "hier":
        return weighted_bincount_hier(idxs, weights, n_bins)
    if impl == "sorted":
        return weighted_bincount_sorted(idxs, weights, n_bins)
    return weighted_bincount_xla(idxs, weights, n_bins)


def scatter_add_window(acc: torch.Tensor, idxs: torch.Tensor,
                       weights: torch.Tensor, impl: str = "auto"
                       ) -> torch.Tensor:
    """acc[idxs] += weights, out-of-range dropped, in place: one window of
    a huge-node build (ops/factorized.py's window loops) added into the
    running table. Returns acc. "hier_presorted" is JAX's build for a
    window of a node-sorted column: the hier build without its sort, with
    sub_width = HIER_BLOCK_ROWS."""
    n_bins = acc.shape[0]
    if impl in KERNEL_IMPLS:
        if idxs.device.type == "cpu":
            return weighted_bincount_torch(idxs, weights, n_bins, out=acc)
        return kernels.weighted_bincount_cuda(idxs, weights, n_bins,
                                              out=acc)
    if impl == "mxu":
        return acc.add_(weighted_bincount_mxu(idxs, weights, n_bins))
    if impl == "hier":
        return acc.add_(weighted_bincount_hier(idxs, weights, n_bins))
    if impl == "hier_presorted":
        return acc.add_(weighted_bincount_hier(
            idxs, weights, n_bins, sub_width=HIER_BLOCK_ROWS,
            presorted=True))
    return weighted_bincount_xla(idxs, weights, n_bins, out=acc)


def table_gather(table: torch.Tensor, keys: torch.Tensor,
                 impl: str = "auto") -> torch.Tensor:
    """g = table[keys], out-of-range -> 0 (the wave's keys are in range by
    the planner's width construction; the bound test is free)."""
    if impl in KERNEL_IMPLS:
        if keys.device.type == "cpu":
            return table_gather_torch(table, keys)
        return kernels.table_gather_cuda(table, keys)
    return table_gather_xla(table, keys)


def table_gather_pairs(pairs: torch.Tensor, keys: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pairs[keys, 0], pairs[keys, 1]), out-of-range -> 0: the fused
    double lookup on two tables already interleaved as one int32[n, 2]
    (the dense probe builds its count and offset tables so). A CPU tensor
    takes the plain version, a CUDA tensor the kernel rhj_table_gather2."""
    if keys.device.type == "cpu":
        return table_gather2_torch(pairs[:, 0], pairs[:, 1], keys)
    return kernels.table_gather2_cuda(pairs, keys)


def table_gather2(table_a: torch.Tensor, table_b: torch.Tensor,
                  keys: torch.Tensor, impl: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table_a[keys], table_b[keys]), out-of-range -> 0; the tables have
    one length. "auto" and "onehot" read each key once through the fused
    kernel (rhj_table_gather2; JAX's one-hot matmul of both tables'
    bytes), on the two tables interleaved first; any other name takes two
    library gathers."""
    if impl in KERNEL_IMPLS:
        if keys.device.type == "cpu":
            return table_gather2_torch(table_a, table_b, keys)
        return table_gather_pairs(torch.stack((table_a, table_b), 1), keys)
    return table_gather_xla(table_a, keys), table_gather_xla(table_b, keys)
