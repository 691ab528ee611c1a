"""Fused stage runner (counterpart: radixhashjoin_tpu/ops/stage.py:90-353).

The batch executor compiles queries into STAGES, maximal runs of
operators between readbacks (only a non-terminal join's expansion size
needs the host), and runs one round's stages for many queries at once:

  round 0: every query's filters + joins up to its first exact probe
  sync    : one readback of all pending probe totals
  round k: expansions + next joins ... until no probes remain
  sweep   : one readback of every NULL flag, spec flag and SUM

Everything the host needs from a round comes back in ONE int64 vector
`[flags | spec ok-flags | probe totals | partials]`; partial lengths
follow `part_shape`.

Op descriptors (all fields static; slot indices are GLOBAL across the
round's concatenated live arrays; `mi` indexes the round's mats; `pi`
indexes the probes consumed by expansions):
  ("ffull", slot, opcode, bucket)        first filter on a pristine slot
  ("flive", slot, opcode)                subsequent filter
  ("eqrows", mi, slot)                   fresh same-slot predicate (wipes)
  ("eqmat", mi, r1, r2, null_flag)       case 3 / joined same-slot filter
  ("probe1", s1, s2)                     case-1 probe (emits a probe)
  ("probe2", mi, full_row, fresh)        case-2 probe (emits a probe)
  ("expand_pair", pi, mi, s1, s2, out)   case-1 expansion into mats[mi]
  ("expand_attach", pi, mi, fresh, out)  case-2 expansion of mats[mi]
  ("spec_pair", mi, s1, s2, out)         speculative case-1 probe+expand
      at a stats-estimated size in the SAME stage (no readback); emits
      a NULL flag (total == 0) and a spec ok-flag (total fits `out`)
  ("spec_attach", mi, full_row, fresh, out)  speculative case-2 ditto
  ("terminal", mi, ex_kind, (fresh_slot, rows_slot), full_row,
   proj_specs, n_cols, mult_rows)        fused terminal join + SUMs;
      mult_rows (tuple | None) multiply into the weights when middle
      attaches were deferred
  ("project", mi, row)                   non-terminal projection
  ("defer_attach", mi, fresh, src)       deferred middle attach: no
      expansion; rows gain a `mult` row (match counts) and an `lv` row
      (full-side values), zero-mult rows compact away. src is
      ("mat", full_row) | ("rows", slot).
  ("project_defer", mi, full_row, tf_slot, lv_row, d_slot, excl, ch)
      deferred-slot projection at a terminal: T-table sum weighted by
      terminal counts x the OTHER deferred multiplicities (excl rows)
  ("project_defer_nt", mi, lv_row, d_slot, excl, ch)
      deferred-slot projection with no terminal join
  ("project_w", mi, row, mult_rows)      projection weighted by deferred
      multiplicities (pipeline ended on a row-filter join)
  ("ftree", spec, n_cols, n_vals)        one factorized query
      (ops/factorized.py run_ftree; EngineConfig(ftree_wave=False))
  ("ftree_wave", wspecs, n_cols, n_vals) every factorized query of the
      round in one level-batched wave (ops/factorized.py); its flags and
      sums arrive in the order the per-query ops would emit them

Column operands arrive in `cols` in plan order; filter constants in
`vals`.

Differences from the reference, all of representation: the packed
vector is int64; a multiplicity product (`_mult_of`) and a count times
it are int64, where the reference's int32 products wrap (ROADMAP.md
§3); a kept probe keeps its device total, so the expansion's live count
needs no upload.
"""

from __future__ import annotations

import torch

from ..utils.limbs import weighted_partials
from .aggregate import _gather_partials
from .backend import (_expand_attach, _expand_pair, _probe_matrix_dense,
                      _probe_rows_dense)
from .chain import eq_filter_matrix, eq_filter_rows
from .compact import compact, compact_mask_positions
from .factorized import run_ftree, run_ftree_wave
from .filter import filter_full, filter_live, gather_clamped
from .join_dense import dense_any_common
from .terminal import (_dense_counts, _fresh_sum_weighted,
                       terminal_join_and_project)


def touched_state(plan):
    """Static analysis of a plan: (slots written, mat indices written)."""
    slots = sorted({op[1] for op in plan if op[0] in ("ffull", "flive")})
    mats = sorted({op[1] for op in plan
                   if op[0] in ("eqrows", "eqmat", "defer_attach",
                                "spec_pair", "spec_attach")} |
                  {op[2] for op in plan
                   if op[0] in ("expand_pair", "expand_attach")})
    return tuple(slots), tuple(mats)


def part_shape(kind) -> int:
    """Number of int64 entries of one packed partial, by sum_map kind:
    ONE PER PLANE for the existing-side kinds ("limb": a plain sum,
    "weighted": a weighted sum, "weighted_seg": a factorized wave's
    fold), ONE PER T CHANNEL for the fresh-side kinds (("fresh", ch),
    ("fresh_w", ch)). utils/limbs.combine_channels combines a channel
    vector, `int(x) & (2**64 - 1)` a plane."""
    if isinstance(kind, str):
        return 1
    return len(kind[1])


def run_stage(live_rows, live_cnt, mats, icounts, probes, cols, vals, plan,
              domain: int, keep_slots=(), keep_mats=(), keep_probes=()):
    """Execute one fused stage for a round of queries.

    Returns (packed, kept live_rows, kept live_cnt, kept mats, kept
    icounts, kept probe states). `packed` is ONE flat int64 vector
    [flags | spec ok-flags | probe totals | partials]; keep_* are the
    planner's keep sets (only a query that emitted a probe continues
    next round). Nothing here reads the device: counts stay 0-d device
    tensors, sizes are static."""
    lr = list(live_rows)
    lc = list(live_cnt)
    mats = list(mats)
    ic = list(icounts)
    device = (mats or cols)[0].device
    ci = vi = 0
    flags, partials, probes_out, specs = [], [], [], []

    def _mult_of(mi, rows):
        m = mats[mi][rows[0]].to(torch.int64)
        for r in rows[1:]:
            m = m * mats[mi][r]
        return m

    for op in plan:
        k = op[0]
        if k == "ffull":
            _, slot, opc, bucket = op
            rows, cnt = filter_full(cols[ci], lc[slot], vals[vi], opc, bucket)
            ci += 1
            vi += 1
            lr[slot], lc[slot] = rows, cnt
            flags.append(cnt == 0)
        elif k == "flive":
            _, slot, opc = op
            rows, cnt = filter_live(lr[slot], lc[slot], cols[ci], vals[vi],
                                    opc)
            ci += 1
            vi += 1
            lr[slot], lc[slot] = rows, cnt
            flags.append(cnt == 0)
        elif k == "eqrows":
            _, mi, slot = op
            rows, cnt = eq_filter_rows(cols[ci], cols[ci + 1], lr[slot],
                                       lc[slot])
            ci += 2
            mats[mi], ic[mi] = rows[None], cnt
        elif k == "eqmat":
            _, mi, r1, r2, null_flag = op
            colA, colB = cols[ci], cols[ci + 1]
            ci += 2
            if null_flag:
                flags.append(~dense_any_common(
                    gather_clamped(colA, mats[mi][r1]),
                    gather_clamped(colB, mats[mi][r2]), ic[mi], domain))
            mats[mi], ic[mi] = eq_filter_matrix(colA, colB, mats[mi], r1, r2,
                                                ic[mi])
        elif k == "probe1":
            _, s1, s2 = op
            probes_out.append(_probe_rows_dense(cols[ci], lr[s1], lc[s1],
                                                cols[ci + 1], lr[s2], lc[s2],
                                                domain))
            ci += 2
        elif k == "probe2":
            _, mi, full_row, fresh = op
            probes_out.append(_probe_matrix_dense(
                cols[ci], mats[mi], full_row, ic[mi], cols[ci + 1],
                lr[fresh], lc[fresh], domain))
            ci += 2
        elif k == "expand_pair":
            _, pi, mi, s1, s2, out = op
            mats[mi] = _expand_pair(*probes[pi][:4], lr[s1], lr[s2], out)
            ic[mi] = probes[pi][4]
        elif k == "expand_attach":
            _, pi, mi, fresh, out = op
            mats[mi] = _expand_attach(*probes[pi][:4], mats[mi], lr[fresh],
                                      out)
            ic[mi] = probes[pi][4]
        elif k == "spec_pair":
            # speculative case-1 expansion: probe + expand at a stats-
            # estimated size inside the SAME stage; the ok-flag verifies
            _, mi, s1, s2, out = op
            pr = _probe_rows_dense(cols[ci], lr[s1], lc[s1], cols[ci + 1],
                                   lr[s2], lc[s2], domain)
            ci += 2
            total = pr[4]
            mats[mi] = _expand_pair(*pr[:4], lr[s1], lr[s2], out)
            ic[mi] = total
            flags.append(total == 0)
            specs.append((total >= 0) & (total <= out))
        elif k == "spec_attach":
            _, mi, full_row, fresh, out = op
            pr = _probe_matrix_dense(cols[ci], mats[mi], full_row, ic[mi],
                                     cols[ci + 1], lr[fresh], lc[fresh],
                                     domain)
            ci += 2
            total = pr[4]
            mats[mi] = _expand_attach(*pr[:4], mats[mi], lr[fresh], out)
            ic[mi] = total
            flags.append(total == 0)
            specs.append((total >= 0) & (total <= out))
        elif k == "terminal":
            (_, mi, ex_kind, ex_slots, full_row, proj_specs, n_cols,
             mult_rows) = op
            col_full, col_fresh_join = cols[ci], cols[ci + 1]
            fresh_slot, rows_slot = ex_slots
            src = mats[mi] if ex_kind == "mat" else lr[rows_slot]
            cnt = ic[mi] if ex_kind == "mat" else lc[rows_slot]
            pc = tuple(cols[ci + 2:ci + 2 + n_cols])
            ci += 2 + n_cols
            mult = _mult_of(mi, mult_rows) if mult_rows else None
            empty, outs = terminal_join_and_project(
                src, cnt, lr[fresh_slot], lc[fresh_slot], col_full,
                col_fresh_join, pc, (ex_kind, full_row, proj_specs), domain,
                mult=mult)
            flags.append(empty)
            partials.extend(outs)
        elif k == "defer_attach":
            _, mi, fresh, src = op
            col_full, col_fresh_join = cols[ci], cols[ci + 1]
            ci += 2
            if src[0] == "mat":
                base = mats[mi]
                lv = gather_clamped(col_full, base[src[1]])
                cnt = ic[mi]
            else:
                base = lr[src[1]][None]
                lv = gather_clamped(col_full, lr[src[1]])
                cnt = lc[src[1]]
            counts, lvm = _dense_counts(
                lv, cnt, gather_clamped(col_fresh_join, lr[fresh]),
                lc[fresh], domain)
            # empty pair set -> NULL (the deferred pair count may pass
            # 2**31, so any(counts > 0), not sum(counts) == 0)
            flags.append(~torch.any(counts > 0))
            idx = torch.arange(counts.shape[0], dtype=torch.int32,
                               device=counts.device)
            pos, ncnt = compact_mask_positions((idx < cnt) & (counts > 0))
            mats[mi] = compact(torch.cat([base, counts[None], lvm[None]]),
                               pos)
            ic[mi] = ncnt
        elif k == "project_defer":
            _, mi, full_row, tf_slot, lv_row, d_slot, excl, ch = op
            col_full_t, col_join_tf = cols[ci], cols[ci + 1]
            col_join_d, col_proj = cols[ci + 2], cols[ci + 3]
            ci += 4
            counts_t, _ = _dense_counts(
                gather_clamped(col_full_t, mats[mi][full_row]), ic[mi],
                gather_clamped(col_join_tf, lr[tf_slot]), lc[tf_slot],
                domain)
            w = counts_t * _mult_of(mi, excl) if excl else counts_t
            partials.append(_fresh_sum_weighted(
                col_proj, col_join_d, lr[d_slot], lc[d_slot],
                mats[mi][lv_row], w, ic[mi], domain, ch))
        elif k == "project_defer_nt":
            # deferred-slot projection with NO terminal join: weights are
            # the product of the OTHER deferred multiplicities (ones if
            # this is the only deferral)
            _, mi, lv_row, d_slot, excl, ch = op
            col_join_d, col_proj = cols[ci], cols[ci + 1]
            ci += 2
            w = (_mult_of(mi, excl) if excl
                 else torch.ones(mats[mi].shape[1], dtype=torch.int32,
                                 device=mats[mi].device))
            partials.append(_fresh_sum_weighted(
                col_proj, col_join_d, lr[d_slot], lc[d_slot],
                mats[mi][lv_row], w, ic[mi], domain, ch))
        elif k == "project_w":
            _, mi, row, mult_rows = op
            partials.append(weighted_partials(
                gather_clamped(cols[ci], mats[mi][row]),
                _mult_of(mi, mult_rows), ic[mi]))
            ci += 1
        elif k == "project":
            _, mi, row = op
            partials.append(_gather_partials(cols[ci], mats[mi][row],
                                             ic[mi]))
            ci += 1
        elif k == "ftree":
            # one factorized query: its NULL flags, then one int64 SUM
            # per projection plane
            _, spec, n_cols, n_vals = op
            fflags, sums = run_ftree(spec, cols[ci:ci + n_cols],
                                     vals[vi:vi + n_vals])
            ci += n_cols
            vi += n_vals
            flags.extend(fflags)
            partials.append(sums)
        elif k == "ftree_wave":
            # every factorized query of the round, level-batched; flags
            # and sums arrive in per-query order
            _, wspecs, n_cols, n_vals = op
            fflags, sums = run_ftree_wave(wspecs, cols[ci:ci + n_cols],
                                          vals[vi:vi + n_vals])
            ci += n_cols
            vi += n_vals
            flags.extend(fflags)
            partials.append(sums)
        else:
            raise ValueError(f"unknown stage op {op!r}")
    segs = []
    if flags:
        segs.append(torch.stack(flags).to(torch.int64))
    if specs:
        segs.append(torch.stack(specs).to(torch.int64))
    if probes_out:
        segs.append(torch.stack([p[4] for p in probes_out]).to(torch.int64))
    segs += partials
    packed = (torch.cat(segs) if segs
              else torch.zeros(0, dtype=torch.int64, device=device))
    return (packed,
            tuple(lr[s] for s in keep_slots),
            tuple(lc[s] for s in keep_slots),
            tuple(mats[m] for m in keep_mats),
            tuple(ic[m] for m in keep_mats),
            tuple(probes_out[p] for p in keep_probes))
