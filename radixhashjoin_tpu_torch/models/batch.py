"""Wave-batched query executor: the port's main path (counterpart:
radixhashjoin_tpu/models/batch.py).

Every query of a batch plans on the host as a factorized join tree
(`_extract_tree`, `_ftree_caps`, `_plan_ftree`, `_ftree_plan_for`,
copied from the reference line for line: host code, no device work),
the planned queries of the batch merge into ONE "ftree_wave" op
(ops/stage.py -> ops/factorized.py), and the batch's flags and int64
sums come back in one packed vector. The final sweep reads it with ONE
device-to-host copy and combines the exact u64 sums on the host.

Ported: the factorized path only. A query that does not factorize (a
cycle the planner cannot rewrite, over-cap multiplicities, no joins)
and a catalog whose domain exceeds max_dense_domain need the
wave-batched materialized fallback, which is not ported yet: they raise
NotImplementedError (the per-query executor, batch_execution=False,
answers them). There is no quiet route to the oracle or the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..config import DEFAULT, EngineConfig
from ..ops.stage import run_stage
from ..ops.tables import check_impl
from ..storage import Relation
from ..utils.limbs import combine_planes
from ..workload import Query
from .device_catalog import DeviceCatalog

_UNPLANNED = object()

_ROADMAP_FALLBACK = ("the materialized fallback is not ported yet "
                     "(ROADMAP.md, 'Modules to port' item 7b)")


class BatchExecutor:
    def __init__(self, relations: Sequence[Relation],
                 config: EngineConfig = DEFAULT, *,
                 device: torch.device,
                 catalog: Optional[DeviceCatalog] = None):
        self.catalog = catalog or DeviceCatalog(relations, config,
                                                device=device)
        self.config = config
        self.device = self.catalog.device
        # dispatches = stage runs; readbacks = device-to-host copies
        self.counters = {"dispatches": 0, "readbacks": 0,
                         "ftree_queries": 0}
        # query-signature -> planned ftree (or None = doesn't factorize)
        self._ftree_plans: Dict[tuple, object] = {}
        check_impl(config.ftree_scatter)
        check_impl(config.ftree_gather)
        kind = config.join_backend
        if kind == "auto":
            kind = ("dense" if self.catalog.domain <= config.max_dense_domain
                    else "sort")
        if kind != "dense":
            raise NotImplementedError(
                f"join backend {kind!r} (catalog domain "
                f"{self.catalog.domain}, max_dense_domain "
                f"{config.max_dense_domain}): {_ROADMAP_FALLBACK}")

    # ---- factorized tree planner (ops/factorized.py) ----

    def _extract_tree(self, q: Query):
        """Walk the join sequence with the oracle's exact case semantics
        (SURVEY.md §9). Returns (final_comp, wiped_comps) when the query
        factorizes — every join attaches a fresh slot, OR re-joins
        already-joined slots (case 3) in a way a union-find over
        (slot, col) value-equivalence classes can rewrite away — else
        None.

        Case-3 rewriting (both slots already in the comp): the edge keeps
        rows where col1[r1] == col2[r2]; every prior edge/selection forces
        value equality within its class on all surviving rows, so
          * both cols in one class -> the edge is an identity filter:
            drop it (exact: rows are non-empty here unless the query is
            already NULL, and each surviving row's pair is in the pair
            set, so the join's NULL test cannot fire either);
          * one col's class holds a column of the OTHER col's slot ->
            the condition collapses to a SAME-SLOT selection, recorded
            with born_of_join=True (its pair-set-empty NULL rule differs
            from a native selection's only when trailing — see below);
          * the two slots are joined by an EXISTING DIRECT tree edge
            (a parallel edge over distinct columns) -> FUSE into that
            edge as a composite key (DeviceCatalog.edge_key pair
            dictionary): the fused edge enforces both equalities, and
            predicate order cannot change the final multiset (pure
            conjunction) or the NULL outcome (any step emptying ==
            final multiset empty) — EXCEPT when no join follows the
            fusing predicate, where the reference's trailing rule
            (sums-0-not-NULL iff the step's own pair set is non-empty,
            oracle.py:121-142) differs from root emptiness: that case
            falls back (checked after the walk);
          * otherwise (slots connected only transitively): fall back.

        A comp is {"nodes": slots in attach order (nodes[0] = root),
        "set", "edges": [(p_slot, p_cols, c_slot, c_cols)] in attach
        order with TUPLE column keys (len > 1 == composite/fused edge),
        "sels": [(slot, c1, c2, n_edges_at_append, born_of_join)],
        "trail": None | (slot, c1, c2, born_of_join) — at most one
        selection sitting AFTER the last edge; ops/factorized.py excludes
        it from the NULL flags (a trailing selection may empty the final
        multiset without NULLing, oracle.py:121-124,133-142) and gates
        NULL from the pre-selection rows instead}. Case-1 and fresh
        same-slot predicates WIPE the previous comp (§8.5/§8.2) and reset
        the equivalence classes; wiped comps with joins still gate NULL
        and come back flag-only."""
        comp = None
        wiped = []
        parent: dict = {}            # union-find over (slot, col)
        members: dict = {}           # root -> set of (slot, col)

        def find(x):
            parent.setdefault(x, x)
            r = x
            while parent[r] != r:
                r = parent[r]
            while parent[x] != r:
                parent[x], x = r, parent[x]
            return r

        def union(x, y):
            rx, ry = find(x), find(y)
            if rx == ry:
                return
            parent[ry] = rx
            mx = members.setdefault(rx, {rx})
            mx |= members.pop(ry, {ry})

        def new_comp(s):
            parent.clear()
            members.clear()
            return {"nodes": [s], "set": {s}, "edges": [], "sels": []}

        for j in q.joins:
            s1, c1, s2, c2 = j.slot1, j.col1, j.slot2, j.col2
            if s1 == s2:
                if comp is not None and s1 in comp["set"]:
                    comp["sels"].append((s1, c1, c2,
                                         len(comp["edges"]), False))
                else:
                    if comp is not None and comp["edges"]:
                        wiped.append(comp)
                    comp = new_comp(s1)
                    comp["sels"].append((s1, c1, c2, 0, False))
                union((s1, c1), (s1, c2))
                continue
            j1 = comp is not None and s1 in comp["set"]
            j2 = comp is not None and s2 in comp["set"]
            if j1 and j2:
                # case 3: rewrite via the value-equivalence classes
                a, b = (s1, c1), (s2, c2)
                ra, rb = find(a), find(b)
                at = len(comp["edges"])
                if ra == rb:
                    # identity — but a selection pending at this exact
                    # position could empty the rows first, and then the
                    # join's pair set IS empty (NULL) while the dropped
                    # edge would never notice: fall back in that case
                    if any(s[3] == at for s in comp["sels"]):
                        return None
                    continue
                # path rewriting through the equivalence classes: every
                # prior edge/selection forces value equality within its
                # class on all surviving (pre-this-predicate) rows, so
                # the predicate a==b may be restated between ANY member
                # of a's class and ANY member of b's class — pick a
                # pairing that lands on one slot (-> same-slot
                # selection) or on a DIRECT tree edge (-> composite-key
                # fusion). This closes the transitive-cycle class the
                # old planner fell back on whenever such a pairing
                # exists; a genuinely cyclic residue (no pairing works,
                # e.g. a triangle over fresh columns) still falls back.
                ma = sorted(members.get(ra, {ra}))
                mb = sorted(members.get(rb, {rb}))
                sel = None
                for (sa, ca) in ma:
                    for (sb, cb) in mb:
                        if sa == sb:
                            sel = (sa, ca, cb)
                            break
                    if sel is not None:
                        break
                if sel is not None:
                    comp["sels"].append((*sel, at, True))
                    union(a, b)
                    continue
                fused = False
                fused_i = -1
                for i, (p, pcs, c, ccs) in enumerate(comp["edges"]):
                    pa = next((cc for (s, cc) in ma if s == p), None)
                    cb = next((cc for (s, cc) in mb if s == c), None)
                    if pa is None or cb is None:
                        # the mirrored orientation: b's class on the
                        # parent, a's class on the child
                        pa = next((cc for (s, cc) in mb if s == p), None)
                        cb = next((cc for (s, cc) in ma if s == c), None)
                    if pa is not None and cb is not None:
                        comp["edges"][i] = (p, pcs + (pa,),
                                            c, ccs + (cb,))
                        fused = True
                        fused_i = i
                        break
                if not fused:
                    return None      # irreducible cycle
                comp.setdefault("fused_at", []).append((at, fused_i))
                union(a, b)
                continue
            if not j1 and not j2:
                if comp is not None and comp["edges"]:
                    wiped.append(comp)
                comp = new_comp(s1)
                comp["nodes"].append(s2)
                comp["set"].add(s2)
                comp["edges"].append((s1, (c1,), s2, (c2,)))
            else:
                p, pc, ch, cc = (s1, c1, s2, c2) if j1 else (s2, c2, s1, c1)
                comp["nodes"].append(ch)
                comp["set"].add(ch)
                comp["edges"].append((p, (pc,), ch, (cc,)))
            union((s1, c1), (s2, c2))
        if comp is None or not comp["edges"]:
            return None
        # selections AFTER the last join make the final multiset differ
        # from the last join's output; ops/factorized.py handles ONE via
        # the trailing-selection machinery (pre-selection NULL gating).
        # MULTIPLE trailing selections ride as pure msg_mask entries
        # (comp["tsels"]) on a root-flag-suppressed sums spec, with a
        # trailing-free boolean companion spec carrying the NULL gate
        # (_ftree_plan_for "masked"/"pregate"). A join-born trailing
        # selection carries the reference's step-pair-set NULL rule,
        # which evaluates on the state BEFORE any later trailing entry —
        # sound only when it is FIRST among them (companion part test =
        # pre-trailing state): any other arrangement falls back.
        ne = len(comp["edges"])
        # a TRAILING fusion (no edge appended after it) carries the
        # reference's step-pair-set NULL rule, which differs from the
        # fused tree's root emptiness (sums-0-not-NULL): plan a boolean
        # companion spec of the PRE-fusion tree with a cross-node
        # support-intersection gate (ops/factorized.py trail 4-tuple).
        # At most ONE, and nothing else at the same position (the sels
        # list loses the relative order of same-position predicates,
        # which decides the gate's pre-state): else fall back.
        for w in [comp] + wiped:
            tf = [ei for (a, ei) in w.get("fused_at", ())
                  if a == len(w["edges"])]
            if len(tf) > 1:
                return None
            if tf and any(s[3] == len(w["edges"]) for s in w["sels"]):
                return None
            w["trail_fuse"] = tf[0] if tf else None
        trailing = [s for s in comp["sels"] if s[3] == ne]
        if any(s[4] for s in trailing[1:]):
            return None          # join-born entry not first among trailing
        comp["trail"] = ((trailing[0][0], trailing[0][1], trailing[0][2],
                          trailing[0][4]) if trailing else None)
        comp["tsels"] = [(s[0], s[1], s[2]) for s in trailing[1:]]
        comp["sels"] = [s for s in comp["sels"] if s[3] < ne]
        for w in wiped:
            # trailing entries in a WIPED comp: natives cannot NULL and
            # the case-1 wipe discards their rows — drop them; ONE
            # join-born entry (necessarily first, else fall back: its
            # pair set evaluates before any later trailing mask) still
            # carries the step-pair-set NULL test via the flag-only gate
            wne = len(w["edges"])
            wt = [s for s in w["sels"] if s[3] >= wne]
            if any(s[4] for s in wt[1:]):
                return None
            w["trail"] = ((wt[0][0], wt[0][1], wt[0][2], True)
                          if wt and wt[0][4] else None)
            w["tsels"] = []
            w["sels"] = [s for s in w["sels"] if s[3] < wne]
        return comp, wiped

    _CAP = 2**31

    def _ftree_caps(self, q: Query, comp, proj_slots) -> bool:
        """Exact host-side overflow caps: every message-table entry and
        per-row weight the factorized pass computes must stay < 2**31 in
        int32. Derived from load-time max multiplicities (filters and
        selections only shrink them)."""
        cat = self.catalog
        edges = comp["edges"]
        capB = [0] * len(edges)
        capbeta = {}
        for i in range(len(edges) - 1, -1, -1):
            p, pcs, c, ccs = edges[i]
            n_c = max(cat.relations[q.slots[c]].num_tuples, 1)
            mult_c = cat.edge_key_max_mult(q.slots[p], pcs, q.slots[c],
                                           ccs, "c")
            cb = min(mult_c, n_c) * capbeta.get(c, 1)
            if cb >= self._CAP:
                return False
            capB[i] = cb
            capbeta[p] = capbeta.get(p, 1) * cb
            if capbeta[p] >= self._CAP:
                return False
        child_edges = {}
        for i, (p, *_r) in enumerate(edges):
            child_edges.setdefault(p, []).append(i)
        capalpha = {comp["nodes"][0]: 1}
        for i, (p, pcs, c, ccs) in enumerate(edges):
            excl = capalpha[p]
            for j in child_edges[p]:
                if j != i:
                    excl *= capB[j]
            if excl >= self._CAP:
                return False
            n_p = max(cat.relations[q.slots[p]].num_tuples, 1)
            mult_p = cat.edge_key_max_mult(q.slots[p], pcs, q.slots[c],
                                           ccs, "p")
            ca = min(mult_p, n_p) * excl
            if ca >= self._CAP:
                return False
            capalpha[c] = ca
        for s in proj_slots:
            if capalpha.get(s, 1) * capbeta.get(s, 1) >= self._CAP:
                return False
        return True

    def _plan_ftree(self, q: Query, comp, sum_map, with_projs: bool,
                    variant=None):
        """Emit one ("ftree", spec, n_cols, n_vals) op (+ cols/vals) for
        a comp. The final comp (with_projs) also carries every filtered
        slot OUTSIDE the tree as a standalone flag-only node — a filter
        emptying ANY slot NULLs the query (Query.cpp:95-146). Column and
        value order MUST match ops/factorized.py's consumption order.

        variant (comps with a TRAILING fusion, comp["trail_fuse"]):
          "fused": the tree as fused — sums are exact on it, but its
                   root-emptiness flag is SUPPRESSED (a trailing case-3
                   may empty the multiset without NULLing);
          "gate":  the PRE-fusion tree (the trailing pair stripped from
                   the fused edge), flag-only, with a cross-node
                   support-intersection gate deciding NULL via the
                   reference's step pair-set rule (oracle.py:133-142,
                   Query.cpp:188-191 of the C++ reference).

        variant (comps with MULTIPLE trailing selections, comp["tsels"]):
          "masked":  the sums spec — every trailing selection rides as a
                     pure msg_mask entry (spec tsels), root flag
                     SUPPRESSED (trailing masks on other nodes leak into
                     any node's alpha/beta, so no single-node test on
                     this spec can see the pre-trailing state);
          "pregate": the trailing-free boolean companion carrying the
                     NULL gate — the root M flag (all trailing entries
                     native: NULL iff some join emptied == pre-trailing
                     multiset empty) or the join-born pair-set gate
                     (a born entry is required to be FIRST among the
                     trailing entries, so its pre-state IS the
                     pre-trailing state)."""
        cat = self.catalog
        edges_src = comp["edges"]
        gate_pair = None
        if variant == "gate":
            gi = comp["trail_fuse"]
            gp, gpcs, gc, gccs = edges_src[gi]
            edges_src = list(edges_src)
            edges_src[gi] = (gp, gpcs[:-1], gc, gccs[:-1])
            gate_pair = (gp, gpcs[-1], gc, gccs[-1])
        nodes = list(comp["nodes"])
        if with_projs:
            nodes += sorted({f.slot for f in q.filters}
                            - comp["set"])
        idx_of = {s: i for i, s in enumerate(nodes)}
        filts_by = {i: [] for i in range(len(nodes))}
        for f in q.filters:
            if f.slot in idx_of:
                filts_by[idx_of[f.slot]].append(f)
        sels_by = {i: [] for i in range(len(nodes))}
        for (s, c1, c2, _at, _born) in comp["sels"]:
            sels_by[idx_of[s]].append((c1, c2))
        cols, vals = [], []
        filt_ops = []
        for i, s in enumerate(nodes):
            ops = []
            for f in filts_by[i]:
                opc, const = cat.encode_filter(f.op, f.value)
                ops.append(opc)
                cols.append(cat.col(q.slots[s], f.col))
                vals.append(int(const))
            filt_ops.append(tuple(ops))
            for (c1, c2) in sels_by[i]:
                cols.append(cat.col(q.slots[s], c1))
                cols.append(cat.col(q.slots[s], c2))
        def _width(*col_maxes: int) -> int:
            """Smallest power of two spanning every listed code max —
            the edge's message-table width (covers both scatter and
            gather key ranges, so no index can leave the table)."""
            w = 8
            need = max(col_maxes) + 1
            while w < need:
                w *= 2
            return w

        trail = comp.get("trail")
        tsels_use = []
        if variant == "masked":
            tsels_use = ([(trail[0], trail[1], trail[2])] if trail
                         else []) + list(comp.get("tsels") or ())
            trail = None
        elif variant == "pregate":
            trail = trail if (trail is not None and trail[3]) else None
        elif comp.get("tsels"):
            # a comp with multiple trailing selections only ever plans
            # through the masked/pregate pair
            raise AssertionError("tsels comp planned without variant")
        trail_spec = None
        if gate_pair is not None:
            gp, gpc, gc, gcc = gate_pair
            trail_spec = (idx_of[gp], True,
                          _width(cat.code_max(q.slots[gp], gpc),
                                 cat.code_max(q.slots[gc], gcc)),
                          idx_of[gc])
            cols.append(cat.col(q.slots[gp], gpc))
            cols.append(cat.col(q.slots[gc], gcc))
        elif trail is not None:
            ts, tc1, tc2, tborn = trail
            trail_spec = (idx_of[ts], tborn,
                          _width(cat.code_max(q.slots[ts], tc1),
                                 cat.code_max(q.slots[ts], tc2)))
            cols.append(cat.col(q.slots[ts], tc1))
            cols.append(cat.col(q.slots[ts], tc2))
        tsels_spec = []
        for (ts, tc1, tc2) in tsels_use:
            tsels_spec.append(idx_of[ts])
            cols.append(cat.col(q.slots[ts], tc1))
            cols.append(cat.col(q.slots[ts], tc2))
        edges_bu = list(reversed(edges_src))
        # device key columns per edge (composite edges synthesize shared
        # pair-code columns; DeviceCatalog.edge_key)
        edge_keys = [cat.edge_key(q.slots[p], pcs, q.slots[c], ccs)
                     for (p, pcs, c, ccs) in edges_bu]
        proj_nodes = set()
        if with_projs:
            proj_nodes = {idx_of[p.slot] for p in q.projections
                          if p.slot in comp["set"]}
        if trail_spec is not None:
            # the trailing NULL gate needs alpha at the trailing node(s)
            proj_nodes = proj_nodes | {trail_spec[0]}
            if len(trail_spec) == 4:
                proj_nodes = proj_nodes | {trail_spec[3]}
        # needs_down: the child's subtree contains a projection node
        in_subtree = {i: {i} for i in range(len(nodes))}
        for (p, _pcs, c, _ccs) in reversed(edges_src):
            in_subtree[idx_of[p]] |= in_subtree[idx_of[c]]
        has_children = {idx_of[p] for (p, *_r) in edges_src}
        spec_edges = []
        for (p, pcs, c, ccs), (pk, ck, cmax) in zip(edges_bu, edge_keys):
            pi, ci_ = idx_of[p], idx_of[c]
            # a same-slot trailing node can't be pre (its msg_mask rides
            # the scatter); a cross-node gate leaves messages unmasked,
            # so pre stays safe at its nodes
            pre = (ci_ not in has_children and not filts_by[ci_]
                   and not sels_by[ci_] and ci_ not in tsels_spec
                   and (trail_spec is None or len(trail_spec) == 4
                        or ci_ != trail_spec[0]))
            needs_down = bool(in_subtree[ci_] & proj_nodes)
            spec_edges.append((pi, ci_, pre, needs_down, _width(cmax)))
            cols.append(pk)
            cols.append(ck)
        for (p, pcs, c, ccs), (_pi, _ci, pre, _nd, w) in zip(edges_bu,
                                                             spec_edges):
            if pre:
                if len(ccs) == 1:
                    cols.append(cat.bincount_table(q.slots[c], ccs[0]))
                else:
                    cols.append(cat.edge_bincount(q.slots[p], pcs,
                                                  q.slots[c], ccs, w))
        projs = []
        if with_projs:
            for idx, p in enumerate(q.projections):
                if p.slot not in comp["set"]:
                    continue
                planes = cat.proj_planes(q.slots[p.slot], p.col)
                col_max = int(
                    cat.relations[q.slots[p.slot]].stats[p.col].max)
                for (plane, sh) in planes:
                    # static value-bit bound of this plane (load-time
                    # stats), kept in the spec so both packages plan
                    # identical specs; the huge-node pass reads it
                    pm = col_max >> sh
                    if len(planes) > 1:
                        pm = min(pm, 0xFFFF)
                    projs.append((idx_of[p.slot],
                                  max(pm.bit_length(), 1)))
                    cols.append(plane)
                    # one int64 sum per plane (utils/limbs.py)
                    sum_map.append((idx, sh))
        flag_nodes = tuple(i for i in range(len(nodes)) if filt_ops[i])
        root = idx_of[comp["nodes"][0]]
        n_flags = len(flag_nodes) + 1
        if variant in ("fused", "masked"):
            # NULL is decided by the companion gate/pregate spec:
            # suppress the root M-emptiness flag (a trailing entry may
            # empty the multiset without NULLing — sums-0-not-NULL)
            root = -1
            n_flags = len(flag_nodes)
        spec = (tuple(filt_ops),
                tuple(len(sels_by[i]) for i in range(len(nodes))),
                tuple(spec_edges), flag_nodes,
                root, tuple(projs), trail_spec, tuple(tsels_spec))
        return (("ftree", spec, len(cols), len(vals)), cols, vals,
                n_flags, tuple(nodes))

    def _ftree_eligible(self, q: Query) -> bool:
        """The ftree branch opens a query that has joins (here every
        query starts fresh: no prior join state, no pending expansion)."""
        return self.config.factorized and bool(q.joins)

    def _ftree_plan_for(self, q: Query):
        """Cached ftree plan for a query, or None if it does not
        factorize (prepared-statement style: a repeated query skips the
        host planner)."""
        key = (tuple(q.slots), tuple(q.joins), tuple(q.filters),
               tuple(q.projections))
        cached = self._ftree_plans.get(key, _UNPLANNED)
        if cached is _UNPLANNED:
            cached = None
            ft = self._extract_tree(q)
            if ft is not None:
                comp, wiped = ft
                proj_slots = {p.slot for p in q.projections
                              if p.slot in comp["set"]}
                if self._ftree_caps(q, comp, proj_slots):
                    fplan, fcols, fvals, fsum, fnf = [], [], [], [], 0
                    fnodes = []

                    def emit(w, with_projs, variant=None):
                        nonlocal fnf
                        op, c, v, nf, nd = self._plan_ftree(
                            q, w, fsum, with_projs, variant)
                        fplan.append(op)
                        fcols.extend(c)
                        fvals.extend(v)
                        fnf += nf
                        fnodes.append(nd)

                    for w in wiped:
                        emit(w, False, "gate" if w["trail_fuse"]
                             is not None else None)
                    if comp["trail_fuse"] is not None:
                        # fused tree carries the sums (root flag
                        # suppressed); the boolean companion carries the
                        # trailing pair-set NULL gate on the pre-fusion
                        # tree
                        emit(comp, True, "fused")
                        emit(comp, False, "gate")
                    elif comp.get("tsels"):
                        # multiple trailing selections: the sums spec
                        # masks them all (root flag suppressed); the
                        # trailing-free boolean companion decides NULL
                        # from the pre-trailing state
                        emit(comp, True, "masked")
                        emit(comp, False, "pregate")
                    else:
                        emit(comp, True)
                    cached = (fplan, fcols, fvals, fsum, fnf,
                              tuple(fnodes))
            self._ftree_plans[key] = cached
        return cached

    # ---- round runner + final sweep ----

    def _run_round(self, queries: Sequence[Query]):
        """Plan and run ONE stage covering every query of the batch.
        Returns the packed vector (still on the device) and, per query,
        (flag offsets, [(projection, sum offset, shift)])."""
        plan, cols, vals, metas = [], [], [], []
        for q in queries:
            cached = (self._ftree_plan_for(q) if self._ftree_eligible(q)
                      else None)
            if cached is None:
                raise NotImplementedError(
                    f"query {q.text or q!r} does not factorize into a join "
                    f"tree within the exact int32 caps (or has no joins): "
                    f"{_ROADMAP_FALLBACK}")
            fplan, fcols, fvals, fsum, fnf, _fnodes = cached
            plan.extend(fplan)
            cols.extend(fcols)
            vals.extend(fvals)
            metas.append((fnf, fsum))
            self.counters["ftree_queries"] += 1
        # the round's ftree ops run as one wave op: flags and sums come
        # back in identical per-query order
        wave = ("ftree_wave", tuple((op[1], op[2], op[3]) for op in plan),
                sum(op[2] for op in plan), sum(op[3] for op in plan))
        self.counters["dispatches"] += 1
        packed = run_stage(tuple(cols), tuple(vals), (wave,), self.device,
                           self.config.ftree_scatter,
                           self.config.ftree_gather)
        # packed layout: [every query's flags | every query's sums]
        refs = []
        fi, si = 0, sum(m[0] for m in metas)
        for nf, fsum in metas:
            refs.append((range(fi, fi + nf),
                         [(idx, si + j, sh)
                          for j, (idx, sh) in enumerate(fsum)]))
            fi += nf
            si += len(fsum)
        return packed, refs

    def _final_sweep_fused(self, queries: Sequence[Query], packed, refs
                           ) -> List[Optional[List[int]]]:
        """Read the packed vector with ONE device-to-host copy and
        combine the exact u64 sums on the host."""
        self.counters["readbacks"] += 1
        host = packed.cpu().tolist()
        results: List[Optional[List[int]]] = []
        for q, (flag_offs, sum_refs) in zip(queries, refs):
            if any(host[o] != 0 for o in flag_offs):
                results.append(None)
                continue
            planes = [[] for _ in q.projections]
            for idx, o, sh in sum_refs:
                planes[idx].append((host[o], sh))
            results.append([combine_planes(p) for p in planes])
        return results

    def run_batch(self, queries: Sequence[Query]
                  ) -> List[Optional[List[int]]]:
        """Per-query sums (None = NULL line) for one batch: the whole
        batch is one round."""
        if not queries:
            return []
        packed, refs = self._run_round(queries)
        return self._final_sweep_fused(queries, packed, refs)
