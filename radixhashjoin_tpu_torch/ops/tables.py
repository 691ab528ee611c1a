"""Message-table build (weighted bincount) and lookup (counterpart:
radixhashjoin_tpu/ops/tables.py).

The factorized wave's two data-sized primitives:

    build:  B = zeros(n_bins); B[idxs] += weights   (out-of-range dropped)
    lookup: g = B[keys]                             (out-of-range -> 0)

The huge-node window loops build window by window into one running table
(`scatter_add_window`: the same build, adding into an accumulator), and
the dense probe looks two tables up with the same keys (`table_gather2`,
`table_gather_pairs`).

Each primitive has one implementation per device, and the tensor's
device picks it here and nowhere else: a CUDA tensor launches the
hand-written Hopper kernel (csrc/tables.cu, bound by kernels.py) or
raises; a CPU tensor runs its plain PyTorch version
(`weighted_bincount_torch`, `table_gather_torch`, `table_gather2_torch`).
The plain versions are the library scatter and gather (index_add_,
index_select), which is what JAX's dispatch falls through to off a TPU.
JAX's other table variants (one-hot, blocked and sorted builds and
lookups) lost to the hand kernels on the H100 by 1.5-6400x, and the port
does not carry them: each is held to the port's one dispatch in
tests/test_torch_tables.py.

Every implementation is exact under the callers' contract (weights >= 0,
every bin's total < 2**31). Negative build indices are dropped where
XLA's scatter would wrap them (a declared divergence, ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels


# ---- the hand kernels' plain versions ----

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


# ---- dispatch: the tensor's device decides ----

def scatter_table(idxs: torch.Tensor, weights: torch.Tensor, n_bins: int
                  ) -> torch.Tensor:
    """B = zeros(n_bins); B[idxs] += weights, out-of-range dropped."""
    if idxs.device.type == "cpu":
        return weighted_bincount_torch(idxs, weights, n_bins)
    return kernels.weighted_bincount_cuda(idxs, weights, n_bins)


def scatter_add_window(acc: torch.Tensor, idxs: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """acc[idxs] += weights, out-of-range dropped, in place: one window of
    a huge-node build (ops/factorized.py's window loops) added into the
    running table. Returns acc."""
    n_bins = acc.shape[0]
    if idxs.device.type == "cpu":
        return weighted_bincount_torch(idxs, weights, n_bins, out=acc)
    return kernels.weighted_bincount_cuda(idxs, weights, n_bins, out=acc)


def table_gather(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """g = table[keys], out-of-range -> 0 (the wave's keys are in range by
    the planner's width construction; the bound test is free)."""
    if keys.device.type == "cpu":
        return table_gather_torch(table, keys)
    return kernels.table_gather_cuda(table, keys)


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
                  keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table_a[keys], table_b[keys]), out-of-range -> 0; the tables have
    one length. On a CUDA tensor the two tables are interleaved first and
    each key is read once through the fused kernel (rhj_table_gather2;
    JAX's one-hot matmul of both tables' bytes)."""
    if keys.device.type == "cpu":
        return table_gather2_torch(table_a, table_b, keys)
    return table_gather_pairs(torch.stack((table_a, table_b), 1), keys)
