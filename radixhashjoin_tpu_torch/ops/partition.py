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
LSB-first gives a stable radix sort equal to
`torch.sort(keys, stable=True).indices`.

The rank kernel is hand-written for Hopper (csrc/radix.cu
`rhj_rank_hist`); dispatch follows the tensor's device and nothing else:
a CPU tensor takes `rank_and_hist_torch`, a CUDA tensor launches the
kernel or raises. The scans, the `dest` arithmetic and the scatter are
plain PyTorch on either device, as they are XLA in the reference.

Digits lie in [0, n_bins]; n_bins itself is the dead-lane bin, ranked
among its equals but left out of the histograms. A digit outside that
range gets rank 0 and is counted nowhere.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

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


def partition_order(digits: torch.Tensor, n_bins: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-partition permutation: order[j] = source index of the j-th
    element when stably grouped by digit, digits == n_bins (dead lanes)
    last. Returns (order int32[n], hist int32[n_bins + 1]); hist[n_bins]
    counts the dead lanes."""
    n = digits.shape[0]
    dev = digits.device
    nb = n_bins + 1                      # digit n_bins = dead/sentinel bin
    ranks, bh = rank_and_hist(digits, nb)
    n_blocks = bh.shape[0]
    # bin_offset[d] + block_base[blk, d] is one exclusive scan of the
    # block histograms in digit-major order
    groups = bh.t().reshape(-1)
    base = torch.cumsum(groups, 0, dtype=torch.int32) - groups
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    d = digits.clamp(0, nb - 1)
    dest = base.index_select(0, d * n_blocks + idx // BLOCK) + ranks
    # dest is a permutation of [0, n) for digits in range; anything else
    # lands in a spare slot past the end (a CUDA scatter with an
    # out-of-range index device-asserts)
    dest = torch.where((dest >= 0) & (dest < n), dest, n)
    order = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    order.index_copy_(0, dest.long(), idx)
    return order[:n], bh.sum(0, dtype=torch.int32)


def radix_sort_order(keys: torch.Tensor, bits: int, digit_bits: int = 8
                     ) -> torch.Tensor:
    """Stable ascending sort permutation (int32[n]) of int32 keys in
    [0, 2**bits): LSB-first partition passes of `digit_bits` bits each.
    Equal to torch.sort(keys, stable=True).indices."""
    n = keys.shape[0]
    order = torch.arange(n, dtype=torch.int32, device=keys.device)
    k = keys
    for shift in range(0, bits, digit_bits):
        nb = 1 << min(digit_bits, bits - shift)
        digits = (k >> shift) & (nb - 1)
        p, _ = partition_order(digits, nb)
        order = order.index_select(0, p)
        k = k.index_select(0, p)
    return order
