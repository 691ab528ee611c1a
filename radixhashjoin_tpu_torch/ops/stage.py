"""Fused stage runner (counterpart: radixhashjoin_tpu/ops/stage.py:107,
288-318).

Runs one round's plan and packs everything the host needs into ONE
int64 vector, so a round costs one device-to-host readback:

    packed = [flags (0/1) ... | int64 sums ...]

Ported op kind: "ftree_wave" (every factorized query of the round,
level-batched; one query is a one-spec wave). The reference's per-query
"ftree" op and its materializing op kinds (filters, probes, expansions,
terminal joins, deferred attaches) are not ported: they raise.
"""

from __future__ import annotations

import torch

from .factorized import run_ftree_wave


def run_stage(cols, vals, plan, device: torch.device,
              ftree_scatter="auto", ftree_gather="auto") -> torch.Tensor:
    """Execute one round's plan; returns the packed int64 vector."""
    ci = vi = 0
    flags, sums = [], []
    for op in plan:
        kind = op[0]
        if kind == "ftree_wave":
            _, wspecs, n_cols, n_vals = op
            f, s = run_ftree_wave(wspecs, cols[ci:ci + n_cols],
                                  vals[vi:vi + n_vals],
                                  scatter=ftree_scatter, gather=ftree_gather)
        else:
            raise NotImplementedError(
                f"stage op {kind!r} is not ported; the port runs every "
                f"factorized query in one ftree_wave op and has no "
                f"materialized fallback yet (ROADMAP.md, 'Modules to port' "
                f"item 7b)")
        ci += n_cols
        vi += n_vals
        flags.extend(f)
        sums.append(s)
    segs = []
    if flags:
        segs.append(torch.stack(flags).to(torch.int64))
    segs.extend(sums)
    if not segs:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.cat(segs)
