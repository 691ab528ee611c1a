"""The port's factorized wave (radixhashjoin_tpu_torch/ops/factorized.py),
its host planner (models/batch.py) and its int64 SUM fold
(utils/limbs.py) against the JAX package on the same inputs.

* planner: both packages emit identical ("ftree", spec, n_cols, n_vals)
  ops, operand arrays and flag counts for the same queries;
* wave: run_ftree_wave's NULL flags equal the JAX flags, and the port's
  int64 sums mod 2**64 equal the JAX (5, 3) partials decoded by
  combine_weighted_segments (the JAX wave runs the Pallas one-hot build
  kernel in interpret mode);
* fold: exact against Python integers and the JAX limb fold past 2**40,
  2**63 and 2**64.
All comparisons are integer and exact (tolerance 0). The port plans from
its own objects: its Relation over the same columns, each query through
its own parser.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixhashjoin_tpu.config import EngineConfig as JaxConfig
from radixhashjoin_tpu.models.batch import BatchExecutor as JaxBatch
from radixhashjoin_tpu.ops import factorized as jax_factorized
from radixhashjoin_tpu.oracle import OracleExecutor
from radixhashjoin_tpu.storage import Relation
from radixhashjoin_tpu.utils.limbs import (combine_weighted_segments,
                                           seg_chunk,
                                           weighted_partials_segments)
from radixhashjoin_tpu.workload import (FilterPred, JoinPred, Projection,
                                        Query)
from radixhashjoin_tpu_torch import storage as tstorage
from radixhashjoin_tpu_torch import workload as tworkload
from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models.batch import BatchExecutor
from radixhashjoin_tpu_torch.ops import factorized
from radixhashjoin_tpu_torch.utils.limbs import (U64_MASK, combine_planes,
                                                 fold_segments)

from test_factorized import _rels, _tree_query

torch.set_num_threads(1)

U64 = np.uint64


def _u64(*cols):
    return Relation([np.array(c, np.uint64) for c in cols])


def _line(q):
    """A query in the work-stream syntax."""
    preds = ([f"{j.slot1}.{j.col1}={j.slot2}.{j.col2}" for j in q.joins]
             + [f"{f.slot}.{f.col}{f.op}{f.value}" for f in q.filters])
    return (f"{' '.join(map(str, q.slots))}|{'&'.join(preds)}|"
            f"{' '.join(f'{p.slot}.{p.col}' for p in q.projections)}")


def _port_executor(rels):
    return BatchExecutor([tstorage.Relation(list(r.values)) for r in rels],
                         EngineConfig(), device="cpu")


def _case_queries():
    """Hand-made shapes: stars, chains, wiped components, trailing and
    mid-sequence case-3 rewrites, composite keys, wide u64 values."""
    rng = np.random.default_rng(11)
    out = []
    rels = _rels(rng, n_rel=5, vmax=16)
    out.append((rels, [
        Query([0, 1, 2, 3], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 2, 0),
                             JoinPred(0, 0, 3, 1)],
              [FilterPred(1, 0, "<", 9)], [Projection(s, 1)
                                           for s in range(4)]),
        Query([0, 1, 2, 3], [JoinPred(0, 0, 1, 0), JoinPred(1, 1, 2, 0),
                             JoinPred(2, 1, 3, 0)],
              [FilterPred(3, 0, ">", 3)],
              [Projection(0, 1), Projection(3, 1)]),
        # wiped component (case-1 join after a first component)
        Query([0, 1, 2, 3], [JoinPred(0, 0, 1, 0), JoinPred(2, 0, 3, 0)],
              [FilterPred(0, 1, "=", 3)], [Projection(2, 0)]),
    ]))
    A = _u64([1, 2, 3, 2], [4, 5, 6, 5], [1, 9, 3, 2])
    B = _u64([1, 2, 9, 2], [4, 5, 7, 8], [1, 2, 3, 4])
    C = _u64([10, 20, 30, 20], [1, 1, 2, 2])
    out.append(([A, B, C], [
        # trailing join-born selection
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(1, 0, 0, 2)],
              [], [Projection(0, 1), Projection(1, 0)]),
        # composite key fused before a later join
        Query([0, 1, 2], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1),
                          JoinPred(1, 0, 2, 0)],
              [], [Projection(0, 0), Projection(1, 1), Projection(2, 0)]),
        # trailing composite fusion: fused sums + cross-node gate
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 1, 1)],
              [], [Projection(0, 0), Projection(1, 1)]),
        # multiple trailing native selections: masked + pregate specs
        Query([0, 1], [JoinPred(0, 0, 1, 0), JoinPred(0, 1, 0, 2),
                       JoinPred(1, 1, 1, 2)],
              [], [Projection(0, 0), Projection(1, 1)]),
    ]))
    big = (rng.integers(0, 50, 200).astype(U64) << U64(40))
    r0 = Relation([big, rng.integers(0, 9, 200).astype(U64)])
    r1 = Relation([big[rng.permutation(200)],
                   rng.integers(0, 50, 200).astype(U64) << U64(35)])
    out.append(([r0, r1], [
        Query([0, 1], [JoinPred(0, 0, 1, 0)], [FilterPred(0, 1, "<", 5)],
              [Projection(0, 0), Projection(1, 1)]),
    ]))
    return out


def _all_cases():
    cases = _case_queries()
    for seed in range(2):
        rng = np.random.default_rng(200 + seed)
        rels = _rels(rng)
        cases.append((rels, [_tree_query(rng, rels) for _ in range(5)]))
    return cases


CASES = _all_cases()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_planner_ops_identical(ci):
    rels, queries = CASES[ci]
    ours = _port_executor(rels)
    ref = JaxBatch(rels, JaxConfig())
    for q in queries:
        a = ours._ftree_plan_for(tworkload.parse_query(_line(q)))
        b = ref._ftree_plan_for(q)
        assert a is not None and b is not None, q
        plan, cols, vals, fsum, nf, nodes = a
        jplan, jcols, jvals, jfsum, jnf, jnodes = b
        assert plan == jplan                  # identical op tuples
        assert (nf, nodes) == (jnf, jnodes)
        assert fsum == jfsum                  # (projection, kind, shift)
        assert len(cols) == len(jcols)
        for c, jc in zip(cols, jcols):
            np.testing.assert_array_equal(_np(c), _np(jc))
        assert vals == [int(_np(v)) for v in jvals]


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_wave_flags_and_sums_match_jax(ci):
    """One wave over every query of the case, both packages."""
    rels, queries = CASES[ci]
    ours = _port_executor(rels)
    ref = JaxBatch(rels, JaxConfig())
    wspecs, cols, vals, jcols, jvals = [], [], [], [], []
    for q in queries:
        plan, c, v, _s, _nf, _n = ours._ftree_plan_for(
            tworkload.parse_query(_line(q)))
        _jp, jc, jv, _js, _jnf, _jn = ref._ftree_plan_for(q)
        wspecs.extend((op[1], op[2], op[3]) for op in plan)
        cols.extend(c)
        vals.extend(v)
        jcols.extend(jc)
        jvals.extend(jv)
    flags, sums = factorized.run_ftree_wave(tuple(wspecs), tuple(cols),
                                            tuple(vals))
    jflags, jparts = jax_factorized.run_ftree_wave(
        tuple(wspecs), tuple(jcols), tuple(jvals), scatter="onehot")
    assert [bool(f) for f in flags] == [bool(f) for f in jflags]
    assert sums.dtype == torch.int64
    want = ([combine_weighted_segments(row) for row in np.asarray(jparts[0])]
            if jparts else [])
    assert [int(s) & U64_MASK for s in sums.tolist()] == want


def test_huge_node_raises(monkeypatch):
    """A node above _BIG_WAVE_ROWS takes the windowed huge-node pass (the
    name is from when it raised): with both packages' thresholds shrunk,
    the port's sums and NULLs equal the JAX engine's and the oracle's
    (tests/test_torch_huge.py holds the pass itself against JAX)."""
    for mod in (factorized, jax_factorized):
        monkeypatch.setattr(mod, "_BIG_WAVE_ROWS", 1024)
    rng = np.random.default_rng(3)
    rels = [Relation([rng.integers(0, 9, 1500).astype(U64),
                      rng.integers(0, 1000, 1500).astype(U64)]),
            Relation([rng.integers(0, 9, 50).astype(U64)])]
    queries = [Query([0, 1], [JoinPred(0, 0, 1, 0)], [],
                     [Projection(1, 0), Projection(0, 1)]),
               Query([0, 1], [JoinPred(0, 0, 1, 0)],
                     [FilterPred(0, 0, "=", 99)], [Projection(0, 1)])]
    got = _port_executor(rels).run_batch(
        [tworkload.parse_query(_line(q)) for q in queries])
    want = [OracleExecutor(rels).execute(q) for q in queries]
    assert got == want == JaxBatch(rels, JaxConfig()).run_batch(queries)
    assert want[1] is None


# ---- the int64 fold ----

def _jax_fold(segs):
    """JAX reference: weighted_partials_segments over chunk-padded
    segments, decoded per row."""
    total = sum(len(v) for v, _w in segs)
    chunk = seg_chunk(total, len(segs))
    vs, ws, ids = [], [], []
    for si, (v, w) in enumerate(segs):
        pad = -len(v) % chunk
        vs.append(np.concatenate([v, np.zeros(pad, np.int32)]))
        ws.append(np.concatenate([w, np.zeros(pad, np.int32)]))
        ids.extend([si] * ((len(v) + pad) // chunk))
    parts = weighted_partials_segments(
        jnp.asarray(np.concatenate(vs)), jnp.asarray(np.concatenate(ws)),
        np.asarray(ids, np.int32), len(segs), chunk=chunk)
    return [combine_weighted_segments(r) for r in np.asarray(parts)]


@pytest.mark.parametrize("label,n,vmax,wmax", [
    ("past 2^40", 5000, 2**20, 2**21),      # ~2^40 .. 2^41 totals
    ("past 2^63", 3, 2**31 - 1, 2**31 - 1),  # 3 * ~2^62 wraps int64 sign
    ("past 2^64", 9, 2**31 - 1, 2**31 - 1),  # wraps u64 twice
    ("empty", 0, 1, 1),
])
def test_fold_exact_mod_2_64(label, n, vmax, wmax):
    rng = np.random.default_rng(n)
    segs = []
    for k in range(3):
        m = n + k
        v = (rng.integers(vmax // 2, vmax, m) if vmax > 1
             else np.zeros(m)).astype(np.int32)
        w = (rng.integers(wmax // 2, wmax, m) if wmax > 1
             else np.zeros(m)).astype(np.int32)
        if label != "empty":
            v[:2] = vmax - 1
            w[:2] = wmax - 1
        segs.append((v, w))
    got = fold_segments([(torch.from_numpy(v), torch.from_numpy(w))
                         for v, w in segs], torch.device("cpu"))
    exact = [sum(int(a) * int(b) for a, b in zip(v, w)) % 2**64
             for v, w in segs]
    assert [int(x) & U64_MASK for x in got.tolist()] == exact
    assert exact == _jax_fold(segs)
    if label == "past 2^64":
        assert all(sum(int(a) * int(b) for a, b in zip(v, w)) > 2**64
                   for v, w in segs)


def test_combine_planes_shifts_mod_2_64():
    # a u64 column as 16-bit planes: sum = sum of plane sums << shift
    parts = [(-1, 0), (2**62, 16), (5, 48)]
    want = ((2**64 - 1) + (2**62 << 16) + (5 << 48)) % 2**64
    assert combine_planes(parts) == want
