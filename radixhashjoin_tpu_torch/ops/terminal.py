"""Factorized terminal-join aggregation, dense backend (counterpart:
radixhashjoin_tpu/ops/terminal.py:36-244).

The LAST join of a query never needs materializing: projections over the
would-be expanded intermediate factor into

  * existing slot s:  sum_e col_s[row_e] * match_count_e   (weighted sum)
  * fresh slot:       sum_e T[key_e],  T[v] = sum of the fresh projection
                      plane over live fresh rows with join key v (a
                      weighted bincount, like the probe's count table)

NULL (an empty pair set) is a device flag, so a terminal join needs no
readback. Every count and T table is a build (ops/tables.py
scatter_table) and every lookup a `table_gather`: on a CUDA tensor they
run the hand-written kernels of csrc/tables.cu.

Sums are int64 (utils/limbs.py): one int64 per existing-side plane, one
per T channel on the fresh side. The channel split (`channel_spec`) is
the reference's: each channel's per-key total stays below 2**31, which
the int32 build kernel needs; the int64 fold then takes any weight.
"""

from __future__ import annotations

from typing import List

import torch

from ..utils.limbs import weighted_partials
from .filter import gather_clamped
from .tables import scatter_table, table_gather


def _dense_counts(lv: torch.Tensor, icount, rv: torch.Tensor, rcount,
                  domain: int):
    """counts[i] = multiplicity of lv[i] among live rv (int32); masked
    lanes 0. Also returns lvm, lv with dead lanes set to -1."""
    L, R = lv.shape[0], rv.shape[0]
    dev = lv.device
    li = torch.arange(L, dtype=torch.int32, device=dev)
    ri = torch.arange(R, dtype=torch.int32, device=dev)
    rvm = torch.where(ri < rcount, rv, domain)
    t_cnt = scatter_table(rvm, torch.ones(R, dtype=torch.int32, device=dev),
                          domain)
    lvm = torch.where(li < icount, lv, -1)
    counts = torch.where(lvm >= 0, table_gather(t_cnt,
                                                lvm.clamp(0, domain - 1)), 0)
    return counts, lvm


def channel_spec(max_mult: int, vmax: int):
    """Static ((shift, bits), ...) channel plan for a fresh-side T table.

    Exactness: per-key channel totals are <= max_mult * (2**bits - 1),
    kept < 2**31 (the int32 build kernel's contract): m * V < 2**31 =>
    one whole-value channel, else ceil(31 - log2(m))-bit slices."""
    m = max(int(max_mult), 1)
    vbits = max(int(vmax).bit_length(), 1)
    if m * int(vmax) < 2**31:
        return ((0, vbits),)
    safe = max(31 - (m - 1).bit_length() - 1, 1)
    return tuple((s, min(safe, vbits - s))
                 for s in range(0, vbits, safe))


def _fresh_tables(col_proj, col_join, fresh_rows, fresh_cnt, lvm, icount,
                  domain: int, channels) -> List[torch.Tensor]:
    """Per-channel gathered T[lvm] vectors (masked, each entry < 2**31).
    Shared by the plain and weighted fresh-side reductions."""
    dev = fresh_rows.device
    ri = torch.arange(fresh_rows.shape[0], dtype=torch.int32, device=dev)
    live_r = ri < fresh_cnt
    key = torch.where(live_r, gather_clamped(col_join, fresh_rows), domain)
    pv = torch.where(live_r, gather_clamped(col_proj, fresh_rows), 0)
    li = torch.arange(lvm.shape[0], dtype=torch.int32, device=dev)
    live_l = (li < icount) & (lvm >= 0)
    lv_safe = lvm.clamp(0, domain - 1)
    gs = []
    for shift, bits in channels:
        limb = (pv if (shift == 0 and bits >= 31)
                else (pv >> shift) & ((1 << bits) - 1))
        t = scatter_table(key, limb, domain)
        gs.append(torch.where(live_l, table_gather(t, lv_safe), 0))
    return gs


def _fresh_sum_body(col_proj, col_join, fresh_rows, fresh_cnt, lvm, icount,
                    domain: int, channels) -> torch.Tensor:
    """int64[C]: per T channel, sum over live existing rows e of
    T[lvm[e]]."""
    gs = _fresh_tables(col_proj, col_join, fresh_rows, fresh_cnt, lvm,
                       icount, domain, channels)
    return torch.stack([g.sum(dtype=torch.int64) for g in gs])


def _fresh_sum_weighted(col_proj, col_join, fresh_rows, fresh_cnt, lvm,
                        weights, icount, domain: int, channels
                        ) -> torch.Tensor:
    """int64[C]: per T channel, sum over live existing rows e of
    weights[e] * T[lvm[e]] (weights: a deferred attach's multiplicity,
    int32 or an int64 product)."""
    gs = _fresh_tables(col_proj, col_join, fresh_rows, fresh_cnt, lvm,
                       icount, domain, channels)
    return torch.cat([weighted_partials(g, weights, icount) for g in gs])


def terminal_join_and_project(ex_source, icount, fresh_rows, fresh_cnt,
                              col_full, col_join_fresh, proj_cols, plan,
                              domain: int, mult=None):
    """The whole terminal join: dense count probe + every projection's
    reduction.

    plan: (ex_kind, full_row, proj_specs) where ex_kind is "mat"/"rows",
    full_row indexes the intermediate matrix row holding the full side's
    rowids (ignored for "rows"), and proj_specs is a tuple of
    ("fresh", channels) | ("mat", row) | ("rows",) aligned with proj_cols.

    mult (optional): per-existing-row multiplicity from deferred middle
    attaches (int64). Weighted sums then use counts * mult, an int64
    product where the reference's int32 product wraps (ROADMAP.md §3),
    and fresh sums become mult-weighted.

    Returns (empty, tuple of int64 partials): `empty` (0-d bool) is the
    deferred NULL flag, any(counts > 0) negated; partial lengths follow
    ops/stage.py part_shape."""
    ex_kind, full_row, proj_specs = plan
    rows = ex_source[full_row] if ex_kind == "mat" else ex_source
    counts, lvm = _dense_counts(gather_clamped(col_full, rows), icount,
                                gather_clamped(col_join_fresh, fresh_rows),
                                fresh_cnt, domain)
    empty = ~torch.any(counts > 0)
    weight = counts if mult is None else counts.to(torch.int64) * mult
    outs = []
    for spec, col in zip(proj_specs, proj_cols):
        if spec[0] == "fresh":
            if mult is None:
                outs.append(_fresh_sum_body(col, col_join_fresh, fresh_rows,
                                            fresh_cnt, lvm, icount, domain,
                                            spec[1]))
            else:
                outs.append(_fresh_sum_weighted(
                    col, col_join_fresh, fresh_rows, fresh_cnt, lvm, mult,
                    icount, domain, spec[1]))
        elif spec[0] == "mat":
            outs.append(weighted_partials(
                gather_clamped(col, ex_source[spec[1]]), weight, icount))
        else:  # "rows"
            outs.append(weighted_partials(gather_clamped(col, ex_source),
                                          weight, icount))
    return empty, tuple(outs)
