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
column/value consumption order), except that each `projs` entry is
(node, plane_bits) as the planner emits it (plane_bits, the plane's
static value-bit bound, serves only the reference's sorted windows and
is ignored here). Sums differ only in representation: one int64 per
projection plane (utils/limbs.py), not a (5, 3) limb fold.

HUGE NODES (more than _BIG_WAVE_ROWS rows) never get a full-length
message lookup or weight product. A message lookup on a huge node stays
an unevaluated factor (`_Lazy`), and everything that consumes it runs
window by window over the node's rows: the builds of the node's message
tables (adding into one running table per edge, tables.py
`scatter_add_window`), its projection folds and its root NULL flag,
all in ONE window loop per node (`_fused_node_pass`) that evaluates each
shared lookup once per window. The windows run as a host loop whose
bounds come from shapes, with a short last window (int64 sums and
additive builds need no overlap), and nothing in it reads the device.
The reference's sorted windows are not ported: every consumer is a
multiset operation, so they change no result, and on the H100 they
measured 3.0-3.5x slower (ROADMAP.md §2).

DISTRIBUTED MODE (`mesh`, parallel/dist_ops.py d_ftree): every node
column is this rank's row shard, and a per-spec validity mask (pad rows
past the relation's end are dead) seeds every node mask. Each rank
builds its rows into the message tables and ONE all_reduce per level
table makes them global (the reference psums there); lookups, folds and
flags stay local until the end, where one all_reduce of the packed
[flag hits | sums] makes them global. Flags are carried as local
any-hit bits throughout (a flag is NULL iff no rank hits), which is
what lets them ride that one collective.
"""

from __future__ import annotations

import torch

from ..utils import limbs
from ..utils.limbs import fold_segments, fold_window, weighted_partials_big
from .filter import OP_EQ, OP_LT
from .tables import scatter_add_window, scatter_table, table_gather

# nodes and waves past this many rows take the windowed huge-node paths
# (lazy lookups, fused window passes, in-place folds); read at call time
# so that tests can shrink it
_BIG_WAVE_ROWS = 1 << 28


class _Tree:
    """Per-spec state inside a wave."""

    __slots__ = ("spec", "edges", "flag_nodes", "root", "projs",
                 "mask", "msg_mask", "tnode", "tnode_b", "tborn", "twidth",
                 "tsel_a", "tsel_b",
                 "pkey", "ckey", "pre", "children", "boolean",
                 "beta", "contrib", "alpha", "planes",
                 "by_height", "by_depth", "done_folds", "done_flag")


def _parse_spec(spec, cols, vals, valid=None):
    """Consume one spec's cols/vals (reference docstring order) into a
    _Tree: masks, key columns, pre tables, and the static height/depth
    schedules of the level-batched passes.

    valid (distributed mode): valid(node) is the bool mask of the real
    rows of this rank's shard of a node, which seeds the node's mask."""
    filts, n_sels, edges, flag_nodes, root, projs, trail, tsels = spec
    k = len(filts)
    t = _Tree()
    t.spec = spec
    t.edges = edges
    t.flag_nodes = flag_nodes
    t.root = root
    t.projs = projs
    ci = vi = 0

    def next_col():
        nonlocal ci
        c = cols[ci]
        ci += 1
        return c

    # per-node boolean masks: filters + same-slot selections, seeded by
    # the shard's validity mask in distributed mode
    mask = []
    for i in range(k):
        m = None if valid is None else valid(i)
        for opc in filts[i]:
            c = next_col()
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
            a = next_col()
            b = next_col()
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
        t.tsel_a = next_col()
        t.tsel_b = next_col()
    elif trail is not None:
        t.tnode, t.tborn, t.twidth = trail
        t.tsel_a = next_col()
        t.tsel_b = next_col()
        tsel = t.tsel_a == t.tsel_b
        t.msg_mask[t.tnode] = (tsel if mask[t.tnode] is None
                               else mask[t.tnode] & tsel)

    # additional trailing selections: final-multiset masks only
    for node in tsels:
        a = next_col()
        b = next_col()
        eq = a == b
        t.msg_mask[node] = (eq if t.msg_mask[node] is None
                            else t.msg_mask[node] & eq)

    t.pkey, t.ckey = [], []
    for _e in edges:
        t.pkey.append(next_col())
        t.ckey.append(next_col())
    t.pre = []
    for (_p, _c, pre_flag, _nd, w) in edges:
        # precomputed bincounts are catalog-domain long; the edge spans
        # only its own width (codes <= width - 1, so slicing drops nothing)
        t.pre.append(next_col()[:w] if pre_flag else None)
    t.planes = [next_col() for _proj in projs]

    t.children = {i: [] for i in range(k)}
    for ei, (p, _c, _pre, _nd, _w) in enumerate(edges):
        t.children[p].append(ei)

    # flag-only trees (no projections) run in the BOOLEAN semiring
    t.boolean = not projs
    t.beta = [None] * k
    t.alpha = [None] * k
    t.contrib = [None] * len(edges)
    t.done_folds = {}        # projection index -> int64 sum of a fused pass
    t.done_flag = None       # any(weight > 0) from a fused pass

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


def _all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """A rank's message table made global (distributed mode), in place."""
    return t if mesh is None else mesh.all_reduce(t)


def _finish(hits, sums: torch.Tensor, mesh):
    """(flags, sums) of a wave from its local any-hit bits and sums: a
    flag is True (NULL) iff nothing hit. In distributed mode ONE
    all_reduce of [hits | sums] makes both global (hit counts and int64
    sums add; the sums wrap mod 2**64)."""
    if mesh is None:
        return [~h for h in hits], sums
    packed = torch.cat([torch.stack(hits).to(torch.int64) if hits
                        else sums.new_zeros(0), sums])
    mesh.all_reduce(packed)
    return list((packed[:len(hits)] == 0).unbind()), packed[len(hits):]


# ---- the huge-node machinery ----

def _win_rows() -> int:
    """Rows per window of every huge-node loop: limbs._BIG_WINDOW_ROWS,
    the window of weighted_partials_big too, read at call time so that
    tests can shrink it; min() lets them shrink it through _BIG_WAVE_ROWS
    as well."""
    return min(limbs._BIG_WINDOW_ROWS, _BIG_WAVE_ROWS)


def _win_guard(n: int) -> None:
    """The reference's window addressing is int32 and caps a node below
    2**31 - 2**26 rows; the port keeps the same cap and error."""
    if n >= (1 << 31) - (1 << 26):
        raise ValueError(
            f"huge-node window loops cap below 2**31 rows (int32 window "
            f"addressing); got {n}")


def _windows(n: int, w_rows: int):
    """(start, size) of every window over n rows: full windows, then a
    short last one."""
    return [(s, min(w_rows, n - s)) for s in range(0, n, w_rows)]


def _ones(size: int, device) -> torch.Tensor:
    return torch.ones(size, dtype=torch.int32, device=device)


class _Lazy:
    """An unevaluated per-row weight over a HUGE node: the elementwise
    product of window-evaluable factors.

      ("gather", table, keys, off, clamp) — table[keys + off], clamped
          to 0/1 for boolean trees
      ("mat", vec)   — an already-materialized int32 vector
      ("mask", bvec) — boolean; False rows weigh 0

    Every consumer evaluates it window by window: the projection folds
    (weighted_partials_big's weight_fn), the window builds
    (_scatter_add_big, _fused_node_pass) and the emptiness flags
    (_lazy_any_positive), so no full-length lookup or product exists.
    Products stay int32-exact under the planner's overflow caps
    (models/batch.py:_ftree_caps), as on the materialized path."""

    __slots__ = ("n", "factors")

    def __init__(self, n, factors):
        _win_guard(n)
        self.n = n
        self.factors = list(factors)

    @classmethod
    def gather(cls, table, keys, off, clamp):
        return cls(keys.shape[0],
                   [("gather", table, keys, int(off), bool(clamp))])

    def with_mask(self, bvec):
        return (self if bvec is None
                else _Lazy(self.n, self.factors + [("mask", bvec)]))

    @property
    def device(self):
        f = self.factors[0]
        return (f[2] if f[0] == "gather" else f[1]).device

    def _parts(self, start, size, cache=None):
        """(window values, is_bool) per factor; a gather evaluated once
        per window cache is reused by every consumer sharing it."""
        for f in self.factors:
            if f[0] == "gather":
                _tag, table, keys, off, clamp = f
                ck = ("g", id(table), id(keys), off, clamp)
                if cache is not None and ck in cache:
                    yield cache[ck], clamp
                    continue
                k = keys[start:start + size]
                g = table_gather(table, k + off if off else k)
                if clamp:
                    g = g > 0
                if cache is not None:
                    cache[ck] = g
                yield g, clamp
            else:
                yield f[1][start:start + size], f[0] == "mask"

    def window(self, start, size, cache=None):
        """int32 weights of rows [start, start + size). `cache`: the
        per-window store shared by the consumers of one fused pass."""
        w = msk = None
        for g, is_bool in self._parts(start, size, cache):
            if is_bool:
                msk = g if msk is None else msk & g
            else:
                w = g if w is None else w * g
        if w is None:
            return (_ones(size, self.device) if msk is None
                    else msk.to(torch.int32))
        return w if msk is None else torch.where(msk, w, 0)

    def pos_window(self, start, size):
        """bool window: weight > 0 (factors are nonnegative, so the
        product is positive iff every factor is)."""
        p = None
        for g, is_bool in self._parts(start, size):
            t = g if is_bool else g > 0
            p = t if p is None else p & t
        return (torch.ones(size, dtype=torch.bool, device=self.device)
                if p is None else p)


def _mat(x):
    """Materialize full length: the small-node fallback and the trailing
    gate's participation test only."""
    if isinstance(x, _Lazy):
        return x.window(0, x.n)
    return x


def _lazy_mul(a, b):
    """Product of None | int32 vector | _Lazy weights (same length);
    stays lazy if either side is."""
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, _Lazy) or isinstance(b, _Lazy):
        fa = a.factors if isinstance(a, _Lazy) else [("mat", a)]
        fb = b.factors if isinstance(b, _Lazy) else [("mat", b)]
        n = a.n if isinstance(a, _Lazy) else a.shape[0]
        return _Lazy(n, fa + fb)
    return a * b


def _lazy_any_positive(lz: _Lazy, mask) -> torch.Tensor:
    """any(weight > 0 [& mask]) over a huge node, window by window, as a
    0-d bool on the device."""
    acc = torch.zeros((), dtype=torch.bool, device=lz.device)
    for start, size in _windows(lz.n, _win_rows()):
        p = lz.pos_window(start, size)
        if mask is not None:
            p = p & mask[start:start + size]
        acc = acc | torch.any(p)
    return acc


def _scatter_add_big(width, key, off, weight, mask, sent):
    """zeros(width)[key + off (masked -> sent)] += weight for a HUGE key
    vector, window by window into one running table (scatter_add_window),
    so that the masked-key and weight temps stay window-sized. weight:
    None | int32 vector | _Lazy."""
    n = key.shape[0]
    _win_guard(n)
    acc = torch.zeros(width, dtype=torch.int32, device=key.device)
    for start, size in _windows(n, _win_rows()):
        k = key[start:start + size]
        if off:
            k = k + off
        if isinstance(weight, _Lazy):
            w = weight.window(start, size)
        elif weight is None:
            w = _ones(size, key.device)
        else:
            w = weight[start:start + size]
        if mask is not None:
            m = mask[start:start + size]
            k = torch.where(m, k, sent)
            w = torch.where(m, w, 0)
        scatter_add_window(acc, k, w)
    return acc


def _fused_node_pass(n, scatters, folds, flag_idx):
    """ONE window loop over a huge node serving every consumer at once:
    message-table builds (each into its own running table), exact
    projection folds, and the root NULL flag. Each window evaluates
    every shared lazy lookup once (`_Lazy.window(cache=...)`): on a star
    fact node the A build of edge 1 looks up edge 2's message table and
    vice versa, and the projection fold looks up both, so the fused pass
    reads each key column once per window instead of once per consumer.

    scatters: [(width, key, off, weight, mask, sent)], the semantics of
        _scatter_add_big (weight: None | vector | _Lazy).
    folds: [(plane, lazy_weight)]; the lazy weight already carries its
        msg_mask factor.
    flag_idx: the folds index whose any(weight > 0) is also wanted (the
        root emptiness bit), or None.
    Returns ([A_i int32 tables], [fold_i 0-d int64 sums], anyp or None).
    The windows are disjoint, the last one short, and unsorted: the
    reference's sorted windows (its wsort) reorder rows inside a window,
    which no consumer here can see."""
    _win_guard(n)
    device = (scatters[0][1] if scatters else folds[0][0]).device
    acc_a = [torch.zeros(s[0], dtype=torch.int32, device=device)
             for s in scatters]
    sums = [torch.zeros((), dtype=torch.int64, device=device)
            for _ in folds]
    flag = (torch.zeros((), dtype=torch.bool, device=device)
            if flag_idx is not None else None)
    for start, size in _windows(n, _win_rows()):
        cache = {}
        end = start + size
        for acc, (_width, key, off, weight, mask, sent) in zip(acc_a,
                                                              scatters):
            k = key[start:end]
            if off:
                k = k + off
            if isinstance(weight, _Lazy):
                w = weight.window(start, size, cache)
            elif weight is None:
                w = _ones(size, device)
            else:
                w = weight[start:end]
            if mask is not None:
                mk = mask[start:end]
                k = torch.where(mk, k, sent)
                w = torch.where(mk, w, 0)
            scatter_add_window(acc, k, w)
        for fi, (plane, lz) in enumerate(folds):
            c = lz.window(start, size, cache)
            if fi == flag_idx:
                flag = flag | torch.any(c > 0)
            sums[fi] = sums[fi] + fold_window(plane[start:end], c)
    return acc_a, sums, flag


def _masked_scatter_operands(key, off, w, mm, sent):
    """(index, weight) of one edge's rows into its level table: masked
    rows go to the out-of-range sentinel with weight 0 (reference
    factorized.py:966-973, 1068-1076)."""
    if mm is not None:
        return (torch.where(mm, key + off, sent),
                mm.to(torch.int32) if w is None else torch.where(mm, w, 0))
    return (key + off,
            _ones(key.shape[0], key.device) if w is None else w)


def run_ftree_wave(wspecs, cols, vals, mesh=None, valid=None):
    """Execute MANY factorized trees in one level-batched wave.

    wspecs: tuple of (spec, n_cols, n_vals); cols/vals hold every spec's
    operands back to back. Returns (flags, sums): flags is a list of 0-d
    bool tensors in spec order (within a spec: the flag_nodes flags, then
    the M/trailing flag); sums is an int64 vector with one wrapped u64
    SUM per projection plane, in spec order.

    mesh / valid (distributed mode, parallel/dist_ops.py d_ftree): this
    rank's Mesh and per-spec validity masks (_parse_spec); the returned
    flags and sums are then global."""
    trees = []
    ci = vi = 0
    for qi, (spec, nc, nv) in enumerate(wspecs):
        trees.append(_parse_spec(spec, cols[ci:ci + nc], vals[vi:vi + nv],
                                 None if valid is None else valid[qi]))
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
        # edges whose CHILD node is huge build window by window, each
        # into its own slice of the level table; the rest batch into one
        # build as usual
        sc = [(t, ei) for (t, ei) in ups if t.pre[ei] is None
              and t.ckey[ei].shape[0] <= _BIG_WAVE_ROWS]
        bg = [(t, ei) for (t, ei) in ups if t.pre[ei] is None
              and t.ckey[ei].shape[0] > _BIG_WAVE_ROWS]
        pr = [(t, ei) for (t, ei) in ups if t.pre[ei] is not None]
        offs = {}
        total = 0
        for (t, ei) in sc + bg + pr:
            offs[(id(t), ei)] = total
            total += t.edges[ei][4]
        parts = []
        if sc:
            t_sc = sum(t.edges[ei][4] for (t, ei) in sc)
            idxs, ws = [], []
            for (t, ei) in sc:
                c = t.edges[ei][1]
                i_, w_ = _masked_scatter_operands(
                    t.ckey[ei], offs[(id(t), ei)], _mat(t.beta[c]),
                    t.msg_mask[c], t_sc)
                idxs.append(i_)
                ws.append(w_)
            parts.append(_all_reduce(scatter_table(
                _concat(idxs), _concat(ws), t_sc), mesh))
        # huge-CHILD edges group by (tree, child): one fused window pass
        # per node serves every edge's build
        up_groups: dict = {}
        for (t, ei) in bg:
            up_groups.setdefault((id(t), t.edges[ei][1]), (t, []))[1]\
                .append(ei)
        up_part = {}
        for (_tid, c), (t, eis) in up_groups.items():
            scats = []
            for ei in eis:
                w = t.edges[ei][4]
                scats.append((w, t.ckey[ei], 0, t.beta[c], t.msg_mask[c], w))
            b_list, _f, _a = _fused_node_pass(
                t.ckey[eis[0]].shape[0], scats, [], None)
            for ei, bb in zip(eis, b_list):
                up_part[(id(t), ei)] = _all_reduce(bb, mesh)
        parts.extend(up_part[(id(t), ei)] for (t, ei) in bg)
        for (t, ei) in pr:
            parts.append(t.pre[ei])
        mega = _concat(parts)
        gks, meta, resolved = [], [], []
        for (t, ei) in sc + bg + pr:
            off = offs[(id(t), ei)]
            if t.pkey[ei].shape[0] > _BIG_WAVE_ROWS:
                # huge PARENT: the lookup stays lazy; boolean trees clamp
                # per window inside the factor
                resolved.append((t, ei, _Lazy.gather(mega, t.pkey[ei], off,
                                                     t.boolean)))
                continue
            gks.append(t.pkey[ei] + off)
            meta.append((t, ei, t.pkey[ei].shape[0]))
        g = table_gather(mega, _concat(gks)) if gks else None
        o = 0
        for (t, ei, n) in meta:
            cv = g[o:o + n]
            o += n
            if t.boolean:
                cv = (cv > 0).to(torch.int32)
            resolved.append((t, ei, cv))
        for (t, ei, cv) in resolved:
            t.contrib[ei] = cv
            p = t.edges[ei][0]
            t.beta[p] = _lazy_mul(t.beta[p], cv)

    # ---- down pass, level-batched (top-down depths) ----
    maxd = max((d for t in trees for d in t.by_depth), default=-1)
    for d in range(0, maxd + 1):
        downs = [(t, ei) for t in trees for ei in t.by_depth.get(d, ())]
        if not downs:
            continue
        # edges whose PARENT node is huge build their A slice window by
        # window (the weight, alpha[p] times the sibling contribs, is
        # evaluated per window, never materialized)
        sm = [(t, ei) for (t, ei) in downs
              if t.pkey[ei].shape[0] <= _BIG_WAVE_ROWS]
        bg = [(t, ei) for (t, ei) in downs
              if t.pkey[ei].shape[0] > _BIG_WAVE_ROWS]
        offs = {}
        total = 0
        for (t, ei) in sm + bg:
            offs[(id(t), ei)] = total
            total += t.edges[ei][4]

        def down_weight(t, ei):
            p = t.edges[ei][0]
            w = t.alpha[p]
            for ej in t.children[p]:
                if ej != ei:
                    w = _lazy_mul(w, t.contrib[ej])
            return w

        parts = []
        if sm:
            t_sm = sum(t.edges[ei][4] for (t, ei) in sm)
            idxs, ws = [], []
            for (t, ei) in sm:
                p = t.edges[ei][0]
                i_, w_ = _masked_scatter_operands(
                    t.pkey[ei], offs[(id(t), ei)], _mat(down_weight(t, ei)),
                    t.msg_mask[p], t_sm)
                idxs.append(i_)
                ws.append(w_)
            parts.append(_all_reduce(scatter_table(
                _concat(idxs), _concat(ws), t_sm), mesh))
        # huge-parent edges: ONE fused window pass per (tree, parent)
        # builds all of the node's A slices, folds its projections and
        # emits its NULL flag, sharing every per-window lookup
        groups: dict = {}
        for (t, ei) in bg:
            groups.setdefault((id(t), t.edges[ei][0]), (t, []))[1]\
                .append(ei)
        part_of = {}
        for (_tid, p), (t, eis) in groups.items():
            n_node = t.pkey[eis[0]].shape[0]
            scats = []
            for ei in eis:
                w_edge = t.edges[ei][4]
                scats.append((w_edge, t.pkey[ei], 0, down_weight(t, ei),
                              t.msg_mask[p], w_edge))
            folds, fold_pi, flag_idx = [], [], None
            for pi, ((i, *_b), plane) in enumerate(zip(t.projs, t.planes)):
                if i != p or pi in t.done_folds:
                    continue
                m_ = _lazy_mul(t.beta[i], t.alpha[i])
                if not isinstance(m_, _Lazy):
                    continue
                if (i == t.root and t.tnode is None and flag_idx is None
                        and t.msg_mask[i] is t.mask[i]):
                    flag_idx = len(folds)
                folds.append((plane, m_.with_mask(t.msg_mask[i])))
                fold_pi.append(pi)
            a_list, fold_list, anyp = _fused_node_pass(
                n_node, scats, folds, flag_idx)
            for ei, ah in zip(eis, a_list):
                part_of[(id(t), ei)] = _all_reduce(ah, mesh)
            for pi, f in zip(fold_pi, fold_list):
                t.done_folds[pi] = f
            if anyp is not None:
                t.done_flag = anyp
        parts.extend(part_of[(id(t), ei)] for (t, ei) in bg)
        A = _concat(parts)
        gks, meta = [], []
        for (t, ei) in sm + bg:
            off = offs[(id(t), ei)]
            if t.ckey[ei].shape[0] > _BIG_WAVE_ROWS:
                t.alpha[t.edges[ei][1]] = _Lazy.gather(
                    A, t.ckey[ei], off, t.boolean)
                continue
            gks.append(t.ckey[ei] + off)
            meta.append((t, ei, t.ckey[ei].shape[0]))
        g = table_gather(A, _concat(gks)) if gks else None
        o = 0
        for (t, ei, n) in meta:
            t.alpha[t.edges[ei][1]] = g[o:o + n]
            o += n

    # ---- flags + sums per tree, emitted in spec order ----
    hits, outs = [], []
    for t in trees:
        mask, msg_mask = t.mask, t.msg_mask
        # nodes with SEVERAL pending lazy folds (a u64 column's 16-bit
        # planes, or several projected columns of one huge node) fold in
        # one fused window pass sharing the weight lookups
        by_node: dict = {}
        for pi, ((i, *_b), plane) in enumerate(zip(t.projs, t.planes)):
            if pi in t.done_folds:
                continue
            m = _lazy_mul(t.beta[i], t.alpha[i])
            if isinstance(m, _Lazy):
                by_node.setdefault(i, []).append((pi, plane, m))
        for i, lst in by_node.items():
            if len(lst) < 2:
                continue
            flag_idx = (0 if (i == t.root and t.tnode is None
                              and t.done_flag is None
                              and msg_mask[i] is mask[i]) else None)
            _al, fold_list, anyp = _fused_node_pass(
                lst[0][1].shape[0], [],
                [(plane, m.with_mask(msg_mask[i])) for (pi, plane, m) in lst],
                flag_idx)
            for (pi, _plane, _m), f in zip(lst, fold_list):
                t.done_folds[pi] = f
            if anyp is not None:
                t.done_flag = anyp

        tree_outs, root_fold = [], None
        for pi, ((i, *_b), plane) in enumerate(zip(t.projs, t.planes)):
            if pi in t.done_folds:
                # already folded inside a fused window loop
                tree_outs.append(("done", t.done_folds[pi]))
                continue
            m = _lazy_mul(t.beta[i], t.alpha[i])
            if isinstance(m, _Lazy):
                # folds window by window, its mask a lazy factor
                if (i == t.root and t.tnode is None and root_fold is None
                        and msg_mask[i] is mask[i]):
                    root_fold = len(outs) + len(tree_outs)
                tree_outs.append((plane, m.with_mask(msg_mask[i])))
                continue
            if m is None:
                w = (_ones(plane.shape[0], plane.device)
                     if msg_mask[i] is None
                     else msg_mask[i].to(torch.int32))
            else:
                w = (m if msg_mask[i] is None
                     else torch.where(msg_mask[i], m, 0))
            tree_outs.append((plane, w))
        # each flag as its local any-hit bit (NULL iff nothing hits)
        hits.extend(torch.any(mask[i]) for i in t.flag_nodes)
        if t.root >= 0 and t.tnode is None:
            br, mr = t.beta[t.root], mask[t.root]
            if t.done_flag is not None:
                # emitted by a fused window loop
                hits.append(t.done_flag)
            elif isinstance(br, _Lazy):
                if root_fold is not None:
                    # the root projection's fold loop emits
                    # any(weight > 0) for free
                    hits.append(("from_fold", root_fold))
                else:
                    hits.append(_lazy_any_positive(br, mr))
            elif br is None:
                hits.append(torch.ones((), dtype=torch.bool, device=device)
                            if mr is None else torch.any(mr))
            elif mr is None:
                hits.append(torch.any(br > 0))
            else:
                hits.append(torch.any(mr & (br > 0)))
        elif t.tnode is not None:
            # NULL gate from the PRE-selection rows: part[r] == row r of
            # the trailing node participates in the joined multiset
            # before the trailing selection
            def _participates(node, n_rows):
                p = torch.ones(n_rows, dtype=torch.bool, device=device)
                if mask[node] is not None:
                    p &= mask[node]
                if t.beta[node] is not None:
                    p &= _mat(t.beta[node]) > 0
                if t.alpha[node] is not None:
                    p &= _mat(t.alpha[node]) > 0
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
                # a value may participate on one rank and match on another
                supp = _all_reduce(supp, mesh)
                hit = supp[:W].index_select(0, t.tsel_b) > 0
                hits.append(torch.any(hit & part_b))
            else:
                # native same-slot predicate: never NULLs by itself
                # (Query.cpp:168-170) — NULL iff the pre-selection
                # multiset is empty
                hits.append(torch.any(part))
        outs.extend(tree_outs)

    # every projection folds in ONE segmented int64 pass, except in a
    # HUGE wave (> _BIG_WAVE_ROWS rows, or any lazy or fused fold): there
    # each projection folds in place, window by window
    # (weighted_partials_big), and the concatenation never exists
    if outs:
        total = sum(plane.shape[0] for plane, _w in outs
                    if not isinstance(plane, str))
        if (total > _BIG_WAVE_ROWS
                or any(isinstance(w, _Lazy) for _, w in outs)
                or any(isinstance(p, str) for p, _w in outs)):
            want_any = {f[1] for f in hits if isinstance(f, tuple)}
            sums, anyp = [], {}
            for oi, (plane, w) in enumerate(outs):
                if isinstance(plane, str):       # ("done", fused fold)
                    sums.append(w)
                elif not isinstance(w, _Lazy):
                    sums.append(weighted_partials_big(plane, w))
                elif oi in want_any:
                    s, anyp[oi] = weighted_partials_big(
                        plane, weight_fn=w.window, also_any_positive=True)
                    sums.append(s)
                else:
                    sums.append(weighted_partials_big(plane,
                                                      weight_fn=w.window))
            hits = [(anyp[f[1]] if isinstance(f, tuple) else f)
                    for f in hits]
            return _finish(hits, torch.stack(sums), mesh)
    return _finish(hits, fold_segments(outs, device), mesh)


def run_ftree(spec, cols, vals):
    """Execute one factorized tree: a single-spec wave (counterpart:
    radixhashjoin_tpu/ops/factorized.py:1331 run_ftree). Returns (flags,
    sums) as run_ftree_wave does for that one spec: the flag_nodes flags
    then the M/trailing flag, and one int64 SUM per projection plane."""
    return run_ftree_wave(((spec, len(cols), len(vals)),), tuple(cols),
                          tuple(vals))
