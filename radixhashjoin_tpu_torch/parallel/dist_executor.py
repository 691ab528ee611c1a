"""Distributed query execution over the ranks of a torch.distributed world
(counterpart: radixhashjoin_tpu/parallel/dist_executor.py:42-348).

Full query semantics (filters, every chaining case, the NULL rules,
exact u64 SUMs) with the catalog, the live sets and the intermediate
row-sharded over the ranks, and the operators of parallel/dist_ops.py
doing the collectives. Every rank runs this same host program on its own
shard, so every value it reads back to decide a branch is made global
first (all_reduce): the probe stats (pair totals and the capacity
overflow), the gather overflows, the NULL flags and the sums. A branch
on a rank-local value would send the ranks down different collective
sequences and deadlock the group.

Readbacks per query, as in the reference's structure: one stats readback
per case-1 / case-2 join, one overflow readback per bounded gather of a
case-3 join, and ONE at the end for the NULL flags and every SUM (the
reference reads each projection back separately). Tree-shaped queries
skip the exchange machinery: a batch's factorized queries run as ONE
d_ftree wave, with one all_reduce per tree level and one readback.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..config import DEFAULT, EngineConfig
from ..models.batch import BatchExecutor
from ..models.device_catalog import DeviceCatalog
from ..oracle import format_result
from ..ops.join import JoinCapacityError
from ..storage import Relation
from ..utils.limbs import U64_MASK
from ..workload import Query
from .dist_ops import (d_case1_expand, d_case1_probe, d_case2_expand,
                       d_case2_probe, d_eq_mat, d_eq_rows, d_filter, d_ftree,
                       d_project, d_seed)
from .mesh import make_mesh


class DistExecutor:
    """Distributed executor: this rank's part of an n-rank run."""

    def __init__(self, relations: Sequence[Relation],
                 config: EngineConfig = DEFAULT, mesh=None,
                 n_devices: Optional[int] = None):
        self.mesh = mesh if mesh is not None else make_mesh(n_devices)
        if n_devices is not None and n_devices != self.mesh.size:
            raise ValueError(f"a {n_devices}-rank executor on a mesh of "
                             f"{self.mesh.size} ranks")
        self.n = self.mesh.size
        self.device = self.mesh.device
        self.config = config
        # columns and planes row-sharded over the ranks; scalars and
        # domain-sized tables whole on every rank
        self.catalog = DeviceCatalog(relations, config, mesh=self.mesh)
        self.relations = relations
        # the factorized-tree planner over the sharded catalog
        self._planner = BatchExecutor(relations, config, device=self.device,
                                      catalog=self.catalog)
        self.counters = {"ftree_queries": 0, "exchange_queries": 0,
                         "ftree_waves": 0, "gather_retries": 0,
                         "readbacks": 0}

    def _read(self, t: torch.Tensor) -> list:
        """A GLOBAL value to the host (one device-to-host copy)."""
        self.counters["readbacks"] += 1
        return t.cpu().tolist()

    def _probe_stats(self, stats) -> tuple:
        """(min, max) of the ranks' pair totals from the max-reduced
        [-min, max, overflow]."""
        mn, mx = -stats[0], stats[1]
        if mn < 0:
            raise JoinCapacityError(
                "a rank's join exceeds 2**31-1 output pairs")
        return mn, mx

    def _gather_cap(self, m: int) -> int:
        """Initial per-destination request capacity of a gather or
        exchange over m lanes: ~2x the uniform share m/n (a power of two,
        >= 4096), or 0 (the worst case, which cannot overflow) where that
        bound would shrink nothing."""
        if not self.config.gather_capacity:
            return 0
        c = 4096
        share = -(-2 * m // self.n)
        while c < share:
            c *= 2
        return 0 if 2 * c >= m else c

    def _overflowed(self, ovf) -> bool:
        """A dispatch's overflow: a host bool already global (from a
        max-reduced stats vector), or a rank-local device flag, max-reduced
        and read back here."""
        if isinstance(ovf, torch.Tensor):
            ovf = self.mesh.all_reduce(ovf.to(torch.int32).reshape(1), "max")
            return bool(self._read(ovf)[0])
        return bool(ovf)

    def _gather_retry(self, m: int, dispatch, cap: Optional[int] = None):
        """Verify-and-retry around a capacity-bounded dispatch:
        dispatch(cap) returns (result, overflow); an overflow quadruples
        the capacity (the worst case, 0, once that reaches m / 8) until
        nothing drops. cap == 0 cannot overflow and reads nothing back."""
        if cap is None:
            cap = self._gather_cap(m)
        while True:
            res, ovf = dispatch(cap)
            if cap == 0 or not self._overflowed(ovf):
                return res
            self.counters["gather_retries"] += 1
            cap = 0 if 8 * cap >= m else 4 * cap

    # ---- the factorized wave ----

    def _execute_ftree_wave(self, items) -> List[Optional[List[int]]]:
        """MANY factorized queries in ONE d_ftree wave: one all_reduce per
        tree level, one for the flags and sums, one readback."""
        self.counters["ftree_waves"] += 1
        wspecs, node_rows, node_caps = [], [], []
        cols, vals = [], []
        for q, cached in items:
            fplan, fcols, fvals, _fsum, _fnf, fnodes = cached
            for op, nd in zip(fplan, fnodes):
                wspecs.append((op[1], op[2], op[3]))
                node_rows.append(tuple(
                    self.relations[q.slots[s]].num_tuples for s in nd))
                node_caps.append(tuple(
                    self.catalog.shard_cap(q.slots[s]) for s in nd))
            cols.extend(fcols)
            vals.extend(fvals)
        flags, sums = d_ftree(self.mesh, tuple(wspecs), tuple(node_rows),
                              tuple(node_caps), tuple(cols), tuple(vals))
        host = self._read(torch.cat(
            [torch.stack(flags).to(torch.int64) if flags
             else sums.new_zeros(0), sums]))
        flags_h, sums_h = host[:len(flags)], host[len(flags):]
        out: List[Optional[List[int]]] = []
        fo = so = 0
        for q, cached in items:
            _fp, _fc, _fv, fsum, fnf, _fn = cached
            nulled = any(flags_h[fo:fo + fnf])
            parts = sums_h[so:so + len(fsum)]
            fo += fnf
            so += len(fsum)
            if nulled:
                out.append(None)
                continue
            res = [0] * len(q.projections)
            for (pi, _kind, shift), s in zip(fsum, parts):
                res[pi] = (res[pi] + ((s & U64_MASK) << shift)) & U64_MASK
            out.append(res)
        return out

    # ---- one query through the exchange pipeline ----

    def execute(self, q: Query) -> Optional[List[int]]:
        return self.run_batch_raw([q])[0]

    def _execute_exchange(self, q: Query) -> Optional[List[int]]:
        cat = self.catalog
        mesh = self.mesh
        cfg = self.config
        self.counters["exchange_queries"] += 1

        live = []
        for s in range(len(q.slots)):
            rel = q.slots[s]
            live.append(list(d_seed(mesh, self.relations[rel].num_tuples,
                                    cat.shard_cap(rel), self.device)))
        # rank-local hit counts: the query is NULL iff one sums to 0
        hits: List[torch.Tensor] = []
        for f in q.filters:
            col = cat.col(q.slots[f.slot], f.col)
            opc, const = cat.encode_filter(f.op, f.value)
            rows, cnt = d_filter(mesh, opc, *live[f.slot], col, const)
            live[f.slot] = [rows, cnt]
            hits.append(cnt)

        mat = icnt = None
        slot_row: Dict[int, int] = {}
        gkw = dict(gchunks=cfg.gather_chunks, bchunks=cfg.broadcast_chunks)

        for j in q.joins:
            s1, c1, s2, c2 = j.slot1, j.col1, j.slot2, j.col2
            colA = cat.col(q.slots[s1], c1)
            colB = cat.col(q.slots[s2], c2)
            # gathers through the intermediate size their capacity by the
            # global width, as the reference does
            width = self.n * mat.shape[1] if mat is not None else 0

            if s1 == s2:
                if s1 not in slot_row:
                    mat, icnt = d_eq_rows(mesh, colA, colB, *live[s1])
                    slot_row = {s1: 0}
                else:
                    mat, icnt = self._gather_retry(
                        width, lambda cap: (lambda o: (o[:2], o[2]))(
                            d_eq_mat(mesh, slot_row[s1], slot_row[s2],
                                     False, colA, colB, mat, icnt,
                                     gcap=cap, **gkw)))
                continue

            j1, j2 = s1 in slot_row, s2 in slot_row
            if j1 and j2:
                mat, icnt, found = self._gather_retry(
                    width, lambda cap: (lambda o: (o[:3], o[3]))(
                        d_eq_mat(mesh, slot_row[s1], slot_row[s2], True,
                                 colA, colB, mat, icnt, gcap=cap, **gkw)))
                hits.append(found)
                continue

            if not j1 and not j2:
                # case 1: the skew-aware exchange (wipes other slots),
                # its capacity sized by the per-rank live width
                def disp1(cap):
                    out = d_case1_probe(
                        mesh, cfg.skew_heavy_fraction, cfg.exchange_chunks,
                        colA, colB, *live[s1], *live[s2], ecap=cap)
                    st = self._read(mesh.all_reduce(out[7], "max"))
                    return (out, st), st[2] > 0
                ((Lrow, Rrow, order, lo, off, cum, total, _st),
                 stats) = self._gather_retry(
                    max(live[s1][0].shape[0], live[s2][0].shape[0]), disp1)
                _, mx = self._probe_stats(stats)
                if mx == 0:
                    return None
                mat = d_case1_expand(cat.bucket(mx), Lrow, Rrow, order, lo,
                                     off, cum)
                icnt = total
                slot_row = {s1: 0, s2: 1}
            else:
                # case 2: broadcast the fresh side, expand locally
                if j1:
                    full, fresh, colF, colG = s1, s2, colA, colB
                else:
                    full, fresh, colF, colG = s2, s1, colB, colA

                def disp2(cap, full=full, colF=colF, colG=colG,
                          fresh=fresh):
                    out = d_case2_probe(mesh, slot_row[full], colF, mat,
                                        icnt, colG, *live[fresh], gcap=cap,
                                        **gkw)
                    st = self._read(mesh.all_reduce(out[4], "max"))
                    return (out, st), st[2] > 0
                (lv, off, _cum, total, _st), stats = self._gather_retry(
                    width, disp2)
                _, mx = self._probe_stats(stats)
                if mx == 0:
                    return None
                mat = d_case2_expand(mesh, cat.bucket(mx), mat, lv, colG,
                                     *live[fresh], off,
                                     bchunks=cfg.broadcast_chunks)
                icnt = total
                slot_row[fresh] = mat.shape[0] - 1
        return self._finish_query(q, mat, icnt, slot_row, hits)

    def _finish_query(self, q: Query, mat, icnt, slot_row, hits):
        """The projections' sums and the NULL flags in ONE all_reduce and
        one readback; a plane whose bounded gather overflowed on some rank
        is gathered again up the capacity ladder."""
        cat = self.catalog
        planes = []                     # (projection index, plane, shift)
        for pi, p in enumerate(q.projections):
            if p.slot in slot_row:
                planes.extend((pi, plane, sh) for plane, sh in
                              cat.int32_planes(q.slots[p.slot], p.col))
        width = self.n * mat.shape[1] if mat is not None else 0
        cap0 = self._gather_cap(width) if planes else 0

        def project(cap, pi, plane):
            return d_project(self.mesh, slot_row[q.projections[pi].slot],
                             plane, mat, icnt, self.config.gather_chunks,
                             cap)
        firsts = [project(cap0, pi, plane) for pi, plane, _sh in planes]
        dev = self.device
        packed = torch.cat(
            [torch.stack(hits).to(torch.int64).reshape(-1) if hits
             else torch.zeros(0, dtype=torch.int64, device=dev)]
            + [torch.stack([s, o.to(torch.int64)]) for s, o in firsts])
        host = (self._read(self.mesh.all_reduce(packed)) if packed.numel()
                else [])
        nh = len(hits)
        sums = [0] * len(q.projections)
        for k, (pi, plane, sh) in enumerate(planes):
            s, ovf = host[nh + 2 * k], host[nh + 2 * k + 1]
            if cap0 and ovf:
                self.counters["gather_retries"] += 1
                nxt = 0 if 8 * cap0 >= width else 4 * cap0
                local = self._gather_retry(
                    width, lambda cap, pi=pi, plane=plane:
                    project(cap, pi, plane), nxt)
                s = self._read(self.mesh.all_reduce(local.reshape(1)))[0]
            sums[pi] = (sums[pi] + ((s & U64_MASK) << sh)) & U64_MASK
        if any(h == 0 for h in host[:nh]):
            return None
        return sums

    # ---- batches ----

    def run_batch_raw(self, batch: Sequence[Query]
                      ) -> List[Optional[List[int]]]:
        """One batch: every factorizable query in ONE d_ftree wave, the
        rest through the exchange pipeline one by one; with
        ftree_wave=False each factorizable query runs as its own wave, in
        batch order. Per-query sums (None = NULL line)."""
        results: List[Optional[List[int]]] = [None] * len(batch)
        wave = []
        for i, q in enumerate(batch):
            cached = None
            if self.config.factorized and q.joins:
                cached = self._planner._ftree_plan_for(q)
            if cached is None:
                results[i] = self._execute_exchange(q)
                continue
            self.counters["ftree_queries"] += 1
            if self.config.ftree_wave:
                wave.append((i, q, cached))
            else:
                results[i] = self._execute_ftree_wave([(q, cached)])[0]
        if wave:
            sums = self._execute_ftree_wave([(q, c) for _, q, c in wave])
            for (i, _, _), s in zip(wave, sums):
                results[i] = s
        return results

    def run_batch(self, batch: Sequence[Query]) -> List[str]:
        return [format_result(r, len(q.projections))
                for r, q in zip(self.run_batch_raw(batch), batch)]

    def run_workload(self, batches) -> List[str]:
        out: List[str] = []
        for batch in batches:
            out.extend(self.run_batch(batch))
        return out
