"""Message-table build (weighted bincount) and lookup (counterpart:
radixhashjoin_tpu/ops/tables.py:119,283,314,339,564,616).

The factorized wave's two data-sized primitives:

    build:  B = zeros(n_bins); B[idxs] += weights   (out-of-range dropped)
    lookup: g = B[keys]                             (out-of-range -> 0)

The huge-node window loops build window by window into one running table
(`scatter_add_window`: the same build, adding into an accumulator).

Each has a plain PyTorch version here and a hand-written Hopper kernel
(csrc/tables.cu, bound by kernels.py). Dispatch follows the tensor's
device and nothing else: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.

`impl` keeps the reference's dispatch argument. "auto" and "onehot" both
mean the dispatch above ("onehot" names the Pallas build kernel the CUDA
build replaces). The reference's TPU-shaped variants ("mxu", "hier",
"sorted", "xla") are not ported and raise NotImplementedError, except
that scatter_add_window takes "hier" and "hier_presorted" as the build.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

PORTED_IMPLS = ("auto", "onehot")
# scatter_add_window also takes the reference's sorted-window build names
WINDOW_IMPLS = PORTED_IMPLS + ("hier", "hier_presorted")


def check_impl(impl: str) -> None:
    if impl not in PORTED_IMPLS:
        raise NotImplementedError(
            f"table kernel impl {impl!r} is not ported (ported: "
            f"{PORTED_IMPLS}); the TPU-shaped variants are listed in "
            f"ROADMAP.md under 'TPU kernels to port'")


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


def scatter_table(idxs: torch.Tensor, weights: torch.Tensor, n_bins: int,
                  impl: str = "auto") -> torch.Tensor:
    """B = zeros(n_bins); B[idxs] += weights, out-of-range dropped."""
    check_impl(impl)
    if idxs.device.type == "cpu":
        return weighted_bincount_torch(idxs, weights, n_bins)
    return kernels.weighted_bincount_cuda(idxs, weights, n_bins)


def scatter_add_window(acc: torch.Tensor, idxs: torch.Tensor,
                       weights: torch.Tensor, impl: str = "auto"
                       ) -> torch.Tensor:
    """acc[idxs] += weights, out-of-range dropped, in place: one window of
    a huge-node build (ops/factorized.py's window loops) added into the
    running table. Returns acc. The reference dispatches among TPU builds
    here; the port's one build adds into its output on either device, and
    it takes sorted windows well (its hot-bin cache), so the reference's
    sorted-window names "hier" and "hier_presorted" run it too. "mxu"
    and "xla" raise, as in scatter_table."""
    if impl not in WINDOW_IMPLS:
        check_impl(impl)
    if idxs.device.type == "cpu":
        return weighted_bincount_torch(idxs, weights, acc.shape[0], out=acc)
    return kernels.weighted_bincount_cuda(idxs, weights, acc.shape[0],
                                          out=acc)


def table_gather(table: torch.Tensor, keys: torch.Tensor,
                 impl: str = "auto") -> torch.Tensor:
    """g = table[keys], out-of-range -> 0 (the wave's keys are in range by
    the planner's width construction; the bound test is free)."""
    check_impl(impl)
    if keys.device.type == "cpu":
        return table_gather_torch(table, keys)
    return kernels.table_gather_cuda(table, keys)
