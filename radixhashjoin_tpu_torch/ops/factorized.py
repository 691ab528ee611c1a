"""Factorized (message-passing) aggregation over tree-shaped join queries
(counterpart: radixhashjoin_tpu/ops/factorized.py).

Nothing is materialized: SUM projections factor into per-relation count
messages over the join tree,

  up pass    beta[s][r]  = product over child edges e of B_e[key_s(r)]
             B_e[v]      = sum of beta[child] over live child rows with
                           child key == v    (one weighted bincount)
  down pass  alpha[c][r] = A_e[key_c(r)]
             A_e[v]      = sum over live parent rows of alpha[parent] *
                           (product of the OTHER children's contribs)
  SUM(s, col) = sum over live rows r of col[r] * alpha[s][r] * beta[s][r]

Filters and same-slot selections are boolean masks at raw relation
length. A wave runs MANY queries' trees at once: every build at one tree
level, across all trees, is ONE weighted bincount into one concatenated
table (each edge owns a width-sized slice at a running offset), and
every lookup at that level is ONE gather — kernel count O(tree height),
not O(queries x edges). The build and lookup are ops/tables.py, which
runs the hand-written kernels of csrc/tables.cu on CUDA tensors.

NULL semantics, the boolean semiring of flag-only trees, the masked-row
sentinel, the trailing-selection gates and the spec layout are the
reference's, unchanged: its module docstring is the spec (spec =
(filts, n_sels, edges, flag_nodes, root, projs, trail, tsels), and the
column/value consumption order). Sums differ only in representation:
one int64 per projection plane (utils/limbs.py), not a (5, 3) limb fold.

Ported: the non-huge branches. A node of more than _BIG_WAVE_ROWS rows
needs the windowed huge-node pass (_Lazy, _fused_node_pass,
_scatter_add_big), which is not ported yet and raises.
"""

from __future__ import annotations

import torch

from ..utils.limbs import fold_segments
from .filter import OP_EQ, OP_LT
from .tables import scatter_table, table_gather

# nodes above this many rows need the reference's windowed huge-node
# pass (not ported); read at call time so tests can monkeypatch it
_BIG_WAVE_ROWS = 1 << 28


class _Tree:
    """Per-spec state inside a wave."""

    __slots__ = ("spec", "edges", "flag_nodes", "root", "projs",
                 "mask", "msg_mask", "tnode", "tnode_b", "tborn", "twidth",
                 "tsel_a", "tsel_b",
                 "pkey", "ckey", "pre", "children", "boolean",
                 "beta", "contrib", "alpha", "planes",
                 "by_height", "by_depth")


def _node_rows_ok(c: torch.Tensor) -> torch.Tensor:
    if c.shape[0] > _BIG_WAVE_ROWS:
        raise NotImplementedError(
            f"a node of {c.shape[0]} rows exceeds _BIG_WAVE_ROWS="
            f"{_BIG_WAVE_ROWS}: the huge-node windowed pass is not ported "
            f"yet (ROADMAP.md, 'Modules to port' item 6)")
    return c


def _parse_spec(spec, cols, vals):
    """Consume one spec's cols/vals (reference docstring order) into a
    _Tree: masks, key columns, pre tables, and the static height/depth
    schedules of the level-batched passes."""
    filts, n_sels, edges, flag_nodes, root, projs, trail, tsels = spec
    k = len(filts)
    t = _Tree()
    t.spec = spec
    t.edges = edges
    t.flag_nodes = flag_nodes
    t.root = root
    t.projs = projs
    ci = vi = 0

    def node_col():
        nonlocal ci
        c = _node_rows_ok(cols[ci])
        ci += 1
        return c

    def next_col():
        nonlocal ci
        c = cols[ci]
        ci += 1
        return c

    # per-node boolean masks: filters + same-slot selections
    mask = []
    for i in range(k):
        m = None
        for opc in filts[i]:
            c = node_col()
            v = vals[vi]
            vi += 1
            if opc == OP_EQ:
                tt = c == v
            elif opc == OP_LT:
                tt = c < v
            else:
                tt = c > v
            m = tt if m is None else m & tt
        for _ in range(n_sels[i]):
            a = node_col()
            b = node_col()
            tt = a == b
            m = tt if m is None else m & tt
        mask.append(m)           # None == all rows live
    t.mask = mask

    # the trailing selection filters the FINAL multiset: it rides the
    # outgoing messages and sum weights (msg_mask) but stays out of
    # `mask`, which feeds the NULL flags (oracle.py:121-124,133-142)
    t.msg_mask = list(mask)
    t.tnode = t.tnode_b = t.tsel_a = t.tsel_b = t.tborn = t.twidth = None
    if trail is not None and len(trail) == 4:
        # cross-node pair gate (trailing composite-key fusion): this spec
        # only decides NULL, so its messages stay unmasked
        t.tnode, t.tborn, t.twidth, t.tnode_b = trail
        t.tsel_a = node_col()
        t.tsel_b = node_col()
    elif trail is not None:
        t.tnode, t.tborn, t.twidth = trail
        t.tsel_a = node_col()
        t.tsel_b = node_col()
        tsel = t.tsel_a == t.tsel_b
        t.msg_mask[t.tnode] = (tsel if mask[t.tnode] is None
                               else mask[t.tnode] & tsel)

    # additional trailing selections: final-multiset masks only
    for node in tsels:
        a = node_col()
        b = node_col()
        eq = a == b
        t.msg_mask[node] = (eq if t.msg_mask[node] is None
                            else t.msg_mask[node] & eq)

    t.pkey, t.ckey = [], []
    for _e in edges:
        t.pkey.append(node_col())
        t.ckey.append(node_col())
    t.pre = []
    for (_p, _c, pre_flag, _nd, w) in edges:
        # precomputed bincounts are catalog-domain long; the edge spans
        # only its own width (codes <= width - 1, so slicing drops nothing)
        t.pre.append(next_col()[:w] if pre_flag else None)
    t.planes = [node_col() for _proj in projs]

    t.children = {i: [] for i in range(k)}
    for ei, (p, _c, _pre, _nd, _w) in enumerate(edges):
        t.children[p].append(ei)

    # flag-only trees (no projections) run in the BOOLEAN semiring
    t.boolean = not projs
    t.beta = [None] * k
    t.alpha = [None] * k
    t.contrib = [None] * len(edges)

    # static schedules: height(e) = 1 + max height of the child node's
    # incoming edges (bottom-up edge order makes this one sweep)
    node_h = {}
    t.by_height = {}
    for ei, (p, c, _pre, _nd, _w) in enumerate(edges):
        h = node_h.get(c, 0) + 1
        node_h[p] = max(node_h.get(p, 0), h)
        t.by_height.setdefault(h, []).append(ei)
    # depth(e) = distance of the parent node from the root along
    # needs_down edges
    incoming = {c: ei for ei, (_p, c, _pre, _nd, _w) in enumerate(edges)}
    depth = {}
    t.by_depth = {}
    for ei in reversed(range(len(edges))):     # top-down
        p, c, _pre, needs_down, _w = edges[ei]
        if not needs_down:
            continue
        d = depth[incoming[p]] + 1 if p in incoming else 0
        depth[ei] = d
        t.by_depth.setdefault(d, []).append(ei)
    return t


def _concat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _none_anywhere(x: torch.Tensor) -> torch.Tensor:
    """~any(x) as a 0-d bool tensor."""
    return ~torch.any(x)


def _mul(a, b):
    """Product of None | int32 vector weights (None == all ones)."""
    if a is None:
        return b
    if b is None:
        return a
    return a * b


def _masked_scatter_operands(key, off, w, mm, sent):
    """(index, weight) of one edge's rows into its level table: masked
    rows go to the out-of-range sentinel with weight 0 (reference
    factorized.py:966-973, 1068-1076)."""
    if mm is not None:
        return (torch.where(mm, key + off, sent),
                mm.to(torch.int32) if w is None else torch.where(mm, w, 0))
    return (key + off,
            torch.ones(key.shape[0], dtype=torch.int32, device=key.device)
            if w is None else w)


def run_ftree_wave(wspecs, cols, vals, scatter="auto", gather="auto"):
    """Execute MANY factorized trees in one level-batched wave.

    wspecs: tuple of (spec, n_cols, n_vals); cols/vals hold every spec's
    operands back to back. Returns (flags, sums): flags is a list of 0-d
    bool tensors in spec order (within a spec: the flag_nodes flags, then
    the M/trailing flag); sums is an int64 vector with one wrapped u64
    SUM per projection plane, in spec order."""
    trees = []
    ci = vi = 0
    for (spec, nc, nv) in wspecs:
        trees.append(_parse_spec(spec, cols[ci:ci + nc], vals[vi:vi + nv]))
        ci += nc
        vi += nv
    device = cols[0].device       # every spec has key columns

    # ---- up pass, level-batched across trees ----
    # Per level, every scattering edge owns a width-sized slice of ONE
    # concatenated table (offsets = running sums of edge widths); the
    # precomputed bincounts append after. Both key columns' codes fit the
    # edge width by construction, so no index leaves its slice.
    maxh = max((h for t in trees for h in t.by_height), default=0)
    for h in range(1, maxh + 1):
        ups = [(t, ei) for t in trees for ei in t.by_height.get(h, ())]
        if not ups:
            continue
        sc = [(t, ei) for (t, ei) in ups if t.pre[ei] is None]
        pr = [(t, ei) for (t, ei) in ups if t.pre[ei] is not None]
        offs = {}
        total = 0
        for (t, ei) in sc + pr:
            offs[(id(t), ei)] = total
            total += t.edges[ei][4]
        parts = []
        if sc:
            t_sc = sum(t.edges[ei][4] for (t, ei) in sc)
            idxs, ws = [], []
            for (t, ei) in sc:
                c = t.edges[ei][1]
                i_, w_ = _masked_scatter_operands(
                    t.ckey[ei], offs[(id(t), ei)], t.beta[c],
                    t.msg_mask[c], t_sc)
                idxs.append(i_)
                ws.append(w_)
            parts.append(scatter_table(_concat(idxs), _concat(ws), t_sc,
                                       scatter))
        for (t, ei) in pr:
            parts.append(t.pre[ei])
        mega = _concat(parts)
        keys = _concat([t.pkey[ei] + offs[(id(t), ei)]
                        for (t, ei) in sc + pr])
        g = table_gather(mega, keys, gather)
        o = 0
        for (t, ei) in sc + pr:
            n = t.pkey[ei].shape[0]
            cv = g[o:o + n]
            o += n
            if t.boolean:
                cv = (cv > 0).to(torch.int32)
            t.contrib[ei] = cv
            p = t.edges[ei][0]
            t.beta[p] = _mul(t.beta[p], cv)

    # ---- down pass, level-batched (top-down depths) ----
    maxd = max((d for t in trees for d in t.by_depth), default=-1)
    for d in range(0, maxd + 1):
        downs = [(t, ei) for t in trees for ei in t.by_depth.get(d, ())]
        if not downs:
            continue
        offs = {}
        total = 0
        for (t, ei) in downs:
            offs[(id(t), ei)] = total
            total += t.edges[ei][4]
        idxs, ws = [], []
        for (t, ei) in downs:
            p = t.edges[ei][0]
            w = t.alpha[p]
            for ej in t.children[p]:
                if ej != ei:
                    w = _mul(w, t.contrib[ej])
            i_, w_ = _masked_scatter_operands(
                t.pkey[ei], offs[(id(t), ei)], w, t.msg_mask[p], total)
            idxs.append(i_)
            ws.append(w_)
        A = scatter_table(_concat(idxs), _concat(ws), total, scatter)
        keys = _concat([t.ckey[ei] + offs[(id(t), ei)]
                        for (t, ei) in downs])
        g = table_gather(A, keys, gather)
        o = 0
        for (t, ei) in downs:
            n = t.ckey[ei].shape[0]
            t.alpha[t.edges[ei][1]] = g[o:o + n]
            o += n

    # ---- flags + sums per tree, emitted in spec order ----
    flags, outs = [], []
    for t in trees:
        mask, msg_mask = t.mask, t.msg_mask
        for (i, *_b), plane in zip(t.projs, t.planes):
            m = _mul(t.beta[i], t.alpha[i])
            if m is None:
                w = (torch.ones(plane.shape[0], dtype=torch.int32,
                                device=plane.device)
                     if msg_mask[i] is None
                     else msg_mask[i].to(torch.int32))
            else:
                w = (m if msg_mask[i] is None
                     else torch.where(msg_mask[i], m, 0))
            outs.append((plane, w))
        flags.extend(_none_anywhere(mask[i]) for i in t.flag_nodes)
        if t.root >= 0 and t.tnode is None:
            br, mr = t.beta[t.root], mask[t.root]
            if br is None:
                flags.append(torch.zeros((), dtype=torch.bool, device=device)
                             if mr is None else _none_anywhere(mr))
            elif mr is None:
                flags.append(_none_anywhere(br > 0))
            else:
                flags.append(_none_anywhere(mr & (br > 0)))
        elif t.tnode is not None:
            # NULL gate from the PRE-selection rows: part[r] == row r of
            # the trailing node participates in the joined multiset
            # before the trailing selection
            def _participates(node, n_rows):
                p = torch.ones(n_rows, dtype=torch.bool, device=device)
                if mask[node] is not None:
                    p &= mask[node]
                if t.beta[node] is not None:
                    p &= t.beta[node] > 0
                if t.alpha[node] is not None:
                    p &= t.alpha[node] > 0
                return p
            part = _participates(t.tnode, t.tsel_a.shape[0])
            part_b = (part if t.tnode_b is None
                      else _participates(t.tnode_b, t.tsel_b.shape[0]))
            if t.tborn:
                # join-born: NULL iff its PAIR SET is empty
                # (oracle.py:133-142) <=> no participating left value
                # equals any participating right value — one
                # support-intersection table of the gate's width
                W = t.twidth
                supp = torch.zeros(W + 1, dtype=torch.int32, device=device)
                supp.scatter_reduce_(
                    0, torch.where(part, t.tsel_a, W).to(torch.int64),
                    part.to(torch.int32), "amax")
                hit = supp[:W].index_select(0, t.tsel_b) > 0
                flags.append(_none_anywhere(hit & part_b))
            else:
                # native same-slot predicate: never NULLs by itself
                # (Query.cpp:168-170) — NULL iff the pre-selection
                # multiset is empty
                flags.append(_none_anywhere(part))

    # every projection folds in ONE segmented int64 pass
    return flags, fold_segments(outs, device)
