"""Radix digit histogram (counterpart: radixhashjoin_tpu/ops/pallas_radix.py:
55 radix_histogram, 86 radix_histogram_xla).

    hist[b] = #{i < count : (vals[i] & (n_bins - 1)) == b}

The digit is the value's low bits, as in the reference's
`payload & (2^HASH_LSB - 1)`. Lanes at or past `count` are padding and
are ignored. The hand-written Hopper kernel is csrc/radix.cu
`rhj_radix_histogram`; dispatch follows the tensor's device and nothing
else: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Union

import torch

from .. import kernels


def _check_bins(n_bins: int) -> int:
    n_bins = int(n_bins)
    if n_bins < 128 or n_bins & (n_bins - 1):
        raise ValueError(f"n_bins must be a power of two >= 128, got "
                         f"{n_bins}")
    return n_bins


def radix_histogram_torch(vals: torch.Tensor,
                          count: Union[int, torch.Tensor],
                          n_bins: int) -> torch.Tensor:
    """Plain version: int32[n_bins]. Padding lanes go to a spare bin past
    the end, which is cut off."""
    n = vals.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=vals.device)
    digits = torch.where(idx < count, vals & (n_bins - 1), n_bins)
    out = torch.zeros(n_bins + 1, dtype=torch.int32, device=vals.device)
    out.index_add_(0, digits, torch.ones_like(digits))
    return out[:n_bins]


def radix_histogram(vals: torch.Tensor, count: Union[int, torch.Tensor],
                    n_bins: int = 256) -> torch.Tensor:
    """Histogram of vals[:count] & (n_bins - 1): int32[n_bins]. `vals` is
    int32[n]; `count` an int or a 0-d int tensor; `n_bins` a power of two
    >= 128."""
    n_bins = _check_bins(n_bins)
    if vals.device.type == "cpu":
        return radix_histogram_torch(vals, count, n_bins)
    return kernels.radix_histogram_cuda(vals, count, n_bins)
