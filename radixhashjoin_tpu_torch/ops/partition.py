"""One-pass stable radix partition and LSB-first radix sort (counterpart:
radixhashjoin_tpu/ops/pallas_partition.py:92 rank_and_hist,
:128 partition_order, :152 radix_sort_order).

`rank_and_hist` gives every element its stable rank among the equal
digits of its 2048-element block, plus each block's digit histogram.
The destination of every element then follows from scans:

    dest = bin_offset[digit] + block_base[block, digit] + rank_in_block

(bin_offset = exclusive scan of the global histogram, block_base =
exclusive scan of the block histograms down the block axis; together,
one exclusive scan of the block histograms in digit-major order), and
one scatter with unique indices writes the permutation. Chaining passes
LSB-first, each scattering the order so far and the keys to `dest`,
gives a stable radix sort equal to `torch.sort(keys,
stable=True).indices`.

The rank kernel is hand-written for Hopper (csrc/radix.cu
`rhj_rank_hist`); dispatch follows the tensor's device and nothing else:
a CPU tensor takes `rank_and_hist_torch`, a CUDA tensor launches the
kernel or raises. The scans, the `dest` arithmetic and the scatter are
plain PyTorch on either device, as they are XLA in the reference; the
per-element lookup of `bin_offset + block_base` by block and digit goes
through the table lookup of ops/tables.py, which on a card is the kernel
of csrc/tables.cu.

Digits lie in [0, n_bins]; n_bins itself is the dead-lane bin, ranked
among its equals but left out of the histograms. A digit outside that
range gets rank 0 and is counted nowhere.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .tables import table_gather

BLOCK = kernels.RANK_BLOCK          # 2048, as in the reference: the block
#                                     size is part of rank_and_hist's output


def rank_and_hist_torch(digits: torch.Tensor, n_bins: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the rank kernel: a stable sort on
    block * (n_bins + 2) + digit, each element's sorted position minus
    its group's first position (a binary search in the sorted keys),
    scattered back."""
    n = digits.shape[0]
    dev = digits.device
    n_blocks = -(-n // BLOCK)
    width = n_bins + 2                   # [0, n_bins] plus one for misfits
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    ok = (digits >= 0) & (digits <= n_bins)
    key = (pos // BLOCK) * width + torch.where(ok, digits, n_bins + 1)
    skey, perm = torch.sort(key, stable=True)
    ranks = torch.empty(n, dtype=torch.int32, device=dev)
    ranks[perm] = (pos - torch.searchsorted(skey, skey)).to(torch.int32)
    ranks = torch.where(ok, ranks, 0)
    hists = torch.zeros(n_blocks * width, dtype=torch.int32, device=dev)
    hists.index_add_(0, key, torch.ones(n, dtype=torch.int32, device=dev))
    return ranks, hists.view(n_blocks, width)[:, :n_bins].contiguous()


def rank_and_hist(digits: torch.Tensor, n_bins: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ranks int32[n], block_hists int32[ceil(n / 2048), n_bins]) for an
    int32 digit vector."""
    if digits.device.type == "cpu":
        return rank_and_hist_torch(digits, n_bins)
    return kernels.rank_hist_cuda(digits, n_bins)


def _iota(n: int, dev: torch.device) -> torch.Tensor:
    """int32[n] 0, 1, ..., n - 1 as one broadcast add of a block's iota
    and the blocks' starts."""
    n_blocks = -(-n // BLOCK)
    starts = torch.arange(0, n_blocks * BLOCK, BLOCK, dtype=torch.int32,
                          device=dev)
    lanes = torch.arange(BLOCK, dtype=torch.int32, device=dev)
    return (starts[:, None] + lanes).view(-1)[:n]


def _block_major_keys(digits: torch.Tensor, nb: int) -> torch.Tensor:
    """int32[n]: blk * (nb + 2) + 1 + clamp(d, -1, nb), blk the element's
    2048-block and d its digit: a digit in [0, nb) keeps its own column,
    any other one of the block's two spare columns (0 below the range,
    nb + 1 above it). Two passes over n int32s (a clamp and an add)."""
    n = digits.shape[0]
    width = nb + 2
    n_blocks = -(-n // BLOCK)
    full = n // BLOCK
    rows = torch.arange(1, n_blocks * width + 1, width, dtype=torch.int32,
                        device=digits.device)
    keys = torch.clamp(digits, -1, nb)
    keys[:full * BLOCK].view(full, BLOCK).add_(rows[:full, None])
    if full < n_blocks:
        keys[full * BLOCK:].add_(rows[full])
    return keys


def _destinations(digits: torch.Tensor, n_bins: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dest int32[n], hist int32[n_bins + 1]): where each element goes
    in the stable partition by digit."""
    n = digits.shape[0]
    dev = digits.device
    nb = n_bins + 1                      # digit n_bins = dead/sentinel bin
    ranks, bh = rank_and_hist(digits, nb)
    n_blocks = bh.shape[0]
    # bin_offset[d] + block_base[blk, d] is one exclusive scan of the
    # block histograms in digit-major order
    counts = bh.t().contiguous().view(-1)
    base = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    # the lookup table, block-major so that a block's lookups share a
    # row; the two spare columns, where every digit outside [0, n_bins]
    # looks up, point past the end
    table = torch.empty((n_blocks, nb + 2), dtype=torch.int32, device=dev)
    table[:, 1:nb + 1] = base.view(nb, n_blocks).t()
    table[:, 0] = n
    table[:, nb + 1] = n
    # dest = table[blk, d] + rank is a permutation of [0, k) for the k
    # digits in [0, n_bins]; any other digit has rank 0, or rank < BLOCK
    # as the rank kernel's dead digit nb, so it lands in the BLOCK spare
    # slots past the end, where _scatter drops it
    dest = table_gather(table.view(-1), _block_major_keys(digits, nb))
    dest += ranks
    return dest, bh.sum(0, dtype=torch.int32)


def _scatter(dest: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[dest[i]] = values[i] for the unique destinations of
    _destinations: adding onto zeros writes each value once, and
    index_add_ takes int32 indices as they are."""
    n = values.shape[0]
    out = torch.zeros(n + BLOCK, dtype=values.dtype, device=values.device)
    out.index_add_(0, dest, values)
    return out[:n]


def partition_order(digits: torch.Tensor, n_bins: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-partition permutation: order[j] = source index of the j-th
    element when stably grouped by digit, digits == n_bins (dead lanes)
    last. Returns (order int32[n], hist int32[n_bins + 1]); hist[n_bins]
    counts the dead lanes. Digits outside [0, n_bins] have no place: with
    k digits in range, order[:k] is the stable order of those k and
    order[k:] is 0 (the reference clips such a digit and lets it collide,
    ROADMAP.md §3)."""
    dest, hist = _destinations(digits, n_bins)
    return _scatter(dest, _iota(digits.shape[0], digits.device)), hist


def radix_sort_order(keys: torch.Tensor, bits: int, digit_bits: int = 8
                     ) -> torch.Tensor:
    """Stable ascending sort permutation (int32[n]) of int32 keys in
    [0, 2**bits): LSB-first partition passes of `digit_bits` bits each,
    each moving the order and the keys to their destinations. Equal to
    torch.sort(keys, stable=True).indices."""
    order = _iota(keys.shape[0], keys.device)
    k = keys
    for shift in range(0, bits, digit_bits):
        nb = 1 << min(digit_bits, bits - shift)
        digits = ((k >> shift) if shift else k) & (nb - 1)
        dest, _ = _destinations(digits, nb)
        order = _scatter(dest, order)
        if shift + digit_bits < bits:    # the last pass needs no keys
            k = _scatter(dest, k)
    return order
