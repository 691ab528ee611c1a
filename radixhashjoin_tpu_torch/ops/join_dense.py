"""Dense direct-address equi-join (counterpart:
radixhashjoin_tpu/ops/join_dense.py:49-98).

When the join-key domain is bounded, a value-indexed table replaces the
binary search:

  probe:  T_cnt[v]  = multiplicity of v among live right values (one
                      weighted bincount: the message-table build kernel,
                      csrc/tables.cu, on a CUDA tensor)
          T_lo[v]   = exclusive cumsum of T_cnt = first position of v in
                      the value-sorted right side
          counts[i] = T_cnt[lv[i]], lo[i] = T_lo[lv[i]]   (one fused
                      double lookup, table_gather_pairs: the kernel
                      rhj_table_gather2, csrc/tables.cu, on a CUDA tensor;
                      T_cnt and T_lo are built into the two columns of
                      one int32[domain, 2], the kernel's pairs table)
  expand: the same ownership scan as the sort backend (ops/join.py).

Interface-compatible with ops/join.py: probe returns (order, lo,
offsets, cum, total); expand returns (left index, right index).
"""

from __future__ import annotations

import torch

from .join import _counts_to_cum, expand_pairs
from .tables import scatter_table, table_gather, table_gather_pairs


def dense_probe(lvals: torch.Tensor, lcount, rvals: torch.Tensor, rcount,
                domain: int):
    """Count matches per left element via a dense value table; values
    lie in [0, domain)."""
    L, R = lvals.shape[0], rvals.shape[0]
    dev = lvals.device
    li = torch.arange(L, dtype=torch.int32, device=dev)
    ri = torch.arange(R, dtype=torch.int32, device=dev)
    rv = torch.where(ri < rcount, rvals, domain)            # dead -> drop
    pairs = torch.empty(domain, 2, dtype=torch.int32, device=dev)
    t_cnt, t_lo = pairs[:, 0], pairs[:, 1]
    t_cnt.copy_(scatter_table(rv, torch.ones(R, dtype=torch.int32,
                                             device=dev), domain))
    torch.cumsum(t_cnt, 0, dtype=torch.int32, out=t_lo)
    t_lo.sub_(t_cnt)
    # stable value-sort of the right side; dead lanes (= domain) sort last
    order = torch.sort(rv, stable=True).indices.to(torch.int32)
    lv = torch.where(li < lcount, lvals, -1)
    lv_safe = lv.clamp(0, domain - 1)
    cnt_g, lo = table_gather_pairs(pairs, lv_safe)
    counts = torch.where(lv >= 0, cnt_g, 0)
    offsets, cum, total = _counts_to_cum(counts)
    return order, lo, offsets, cum, total


# the reference's dense_expand is the sort backend's expand_pairs line
# for line
dense_expand = expand_pairs


def dense_any_common(avals: torch.Tensor, bvals: torch.Tensor, count,
                     domain: int) -> torch.Tensor:
    """0-d bool: shared-value test via the dense table (the case-3 NULL
    rule)."""
    n = avals.shape[0]
    dev = avals.device
    live = torch.arange(n, dtype=torch.int32, device=dev) < count
    bv = torch.where(live, bvals, domain)
    t = scatter_table(bv, torch.ones(n, dtype=torch.int32, device=dev),
                      domain)
    av = torch.where(live, avals, 0).clamp(0, domain - 1)
    return ((table_gather(t, av) > 0) & live).any()
