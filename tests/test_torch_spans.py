"""The batch driver's spans and counters (utils/profiling.py `span`,
`count`, `span_totals`; their sites in models/batch.py), on a
sort-backend batch that covers every per-op layer: filters (scanning and
point-gathered, one that empties its slot), case-1 and case-2 probes and
expansions, same-slot and case-3 matches, a probe with no pairs, and
projections.

With no torch.profiler capture recording, nothing is recorded and the
shared no-op context is all a span costs. Under a capture, every span
appears in it as `rhj.<name>` as often as SPANS counts it, the readback
span as often as the batch driver's readback counter moves, the probe span
once per case-1/2 join, and the sort join's padded and live right rows
(sorted) and padded left lanes (binary-searched) equal those worked out
by the oracle's own walk of each query. The card's
test (marked `cuda`) holds the stream-timed spans' CUDA-event seconds to
the run's wall time; this file imports nothing of jax:

    python -m pytest tests/test_torch_spans.py -q -m cuda --noconftest
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radixhashjoin_tpu_torch.config import EngineConfig
from radixhashjoin_tpu_torch.models.engine import Engine
from radixhashjoin_tpu_torch.oracle import (OracleExecutor, _expand_match,
                                            format_result)
from radixhashjoin_tpu_torch.storage import Relation
from radixhashjoin_tpu_torch.utils import profiling
from radixhashjoin_tpu_torch.utils.padding import bucket_size
from radixhashjoin_tpu_torch.workload import (FilterPred, JoinPred,
                                              Projection, Query)

CONFIG = EngineConfig(join_backend="sort")
STREAM_TIMED = ("filter", "join.probe", "join.expand", "join.match",
                "aggregate")


def _catalog():
    rng = np.random.default_rng(16)
    shapes = [(3000, 3), (1500, 3), (700, 2)]
    return [Relation([rng.integers(0, 60, n).astype(np.uint64)
                      for _ in range(cols)]) for n, cols in shapes]


def _queries():
    """Each layer of the per-op path at least once; the batch's waves hold
    several probes, so their live counts ride together."""
    J, F, P = JoinPred, FilterPred, Projection
    return [
        # filter (scan, then point-gathered), case 1
        Query([0, 1], [J(0, 0, 1, 0)], [F(0, 1, "<", 30), F(0, 2, ">", 5)],
              [P(0, 1), P(1, 2)]),
        # a chain: case 1 then case 2
        Query([0, 1, 2], [J(0, 0, 1, 1), J(1, 2, 2, 0)],
              [F(2, 1, "<", 20)], [P(0, 2), P(2, 1)]),
        # a cycle: case 1, case 2, case 3
        Query([0, 1, 2], [J(0, 0, 1, 0), J(1, 1, 2, 0), J(2, 1, 0, 1)], [],
              [P(0, 0), P(1, 1), P(2, 1)]),
        # same-slot on a fresh slot, then on the joined slot, then case 2
        Query([1, 2], [J(0, 0, 0, 1), J(0, 1, 0, 2), J(0, 2, 1, 0)], [],
              [P(0, 0), P(1, 1)]),
        # a filter empties its slot: the probe sees no live rows (NULL)
        Query([0, 2], [J(0, 0, 1, 0)], [F(1, 0, ">", 1000)], [P(0, 0)]),
        # the first probe finds pairs, the second none: the walk stops
        Query([0, 1, 2], [J(0, 0, 1, 0), J(1, 1, 2, 1)],
              [F(1, 1, "=", 7), F(2, 1, "=", 8)], [P(0, 0)]),
        # a never-joined slot sums 0
        Query([0, 1, 2], [J(0, 1, 1, 1)], [F(0, 0, "<", 10)],
              [P(0, 0), P(2, 0)]),
    ]


def _want(rels, queries):
    oracle = OracleExecutor(rels)
    return [format_result(oracle.execute(q), len(q.projections))
            for q in queries]


def _probes(rels, q):
    """(padded R, live R, padded L) of each probe the per-op path runs
    for `q`, in join order: the oracle's walk of the query, which runs on past
    an emptied filter (the path keeps it as a device flag) and past an
    empty case-3 pair set, and stops at a probe with no pairs. A slot's
    live rows keep their padded length `bucket(rows)`; an intermediate
    has `bucket(pairs)` columns after an expansion and its slot's length
    after a fresh same-slot match."""
    pad = lambda n: bucket_size(n, CONFIG.min_pad, CONFIG.pad_base)
    col = lambda s, c: rels[q.slots[s]].values[c]
    live = [np.arange(rels[r].num_tuples) for r in q.slots]
    width = [pad(rels[r].num_tuples) for r in q.slots]
    for f in q.filters:
        vals = col(f.slot, f.col)[live[f.slot]]
        k = np.uint64(f.value)
        keep = {"=": vals == k, "<": vals < k, ">": vals > k}[f.op]
        live[f.slot] = live[f.slot][keep]
    inter, inter_width, out = {}, 0, []
    for j in q.joins:
        s1, s2 = j.slot1, j.slot2
        a, b = col(s1, j.col1), col(s2, j.col2)
        if s1 == s2 and s1 not in inter:
            rows = live[s1]
            inter, inter_width = {s1: rows[a[rows] == b[rows]]}, width[s1]
            continue
        if s1 in inter and s2 in inter:
            keep = a[inter[s1]] == b[inter[s2]]
            inter = {s: v[keep] for s, v in inter.items()}
            continue
        if s1 not in inter and s2 not in inter:
            out.append((width[s2], len(live[s2]), width[s1]))
            li, ri = _expand_match(a[live[s1]], b[live[s2]])
            if len(li):
                inter = {s1: live[s1][li], s2: live[s2][ri]}
        else:
            full, fresh, fv, gv = ((s1, s2, a, b) if s1 in inter
                                   else (s2, s1, b, a))
            out.append((width[fresh], len(live[fresh]), inter_width))
            li, ri = _expand_match(fv[inter[full]], gv[live[fresh]])
            if len(li):
                inter = {s: v[li] for s, v in inter.items()}
                inter[fresh] = live[fresh][ri]
        if not len(li):
            break
        inter_width = pad(len(li))
    return out


@pytest.fixture(scope="module")
def traced():
    """One sort-backend batch under a CPU capture: (lines, the oracle's
    lines, span totals, the capture's rhj.* ranges by name, readbacks the
    batch driver counted, the oracle walk's probes)."""
    rels = _catalog()
    queries = _queries()
    eng = Engine(rels, CONFIG, device="cpu")
    bex = eng.batch_executor
    assert bex.join.kind == "sort"
    profiling.reset_spans()
    readbacks = bex.counters["readbacks"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lines = eng.run_batch(queries)
    totals = profiling.span_totals()
    profiling.reset_spans()
    ranges = {e.key[len("rhj."):]: e.count for e in prof.key_averages()
              if e.key.startswith("rhj.")}
    return {"lines": lines, "want": _want(rels, queries), "totals": totals,
            "ranges": ranges,
            "readbacks": bex.counters["readbacks"] - readbacks,
            "probes": [p for q in queries for p in _probes(rels, q)]}


def test_spans_record_nothing_without_a_capture():
    rels = _catalog()
    queries = _queries()
    eng = Engine(rels, CONFIG, device="cpu")
    profiling.reset_spans()
    assert eng.run_batch(queries) == _want(rels, queries)
    assert profiling.SPANS == {}
    assert profiling.span_totals() == {}
    # one shared no-op context: no range, no clock, no event
    assert profiling.span("a") is profiling.span("b", torch.device("cpu"))
    profiling.count("c", 5)
    assert profiling.SPANS == {}


def test_a_capture_changes_no_line(traced):
    assert traced["lines"] == traced["want"]
    assert "NULL" in traced["want"] and "0" in " ".join(traced["want"])


def test_every_span_is_a_capture_range(traced):
    spans = {name: t["calls"] for name, t in traced["totals"].items()
             if t["calls"]}
    assert set(spans) == {"batch.run", "batch.readback", *STREAM_TIMED}
    assert spans == traced["ranges"]
    assert spans["batch.run"] == 1
    # on the CPU no span is stream-timed
    assert all(t["stream_s"] == 0 for t in traced["totals"].values())


def test_readback_span_is_the_readback_counter(traced):
    assert traced["totals"]["batch.readback"]["calls"] == traced["readbacks"]


def test_probe_span_is_a_case_1_or_2_join(traced):
    assert traced["totals"]["join.probe"]["calls"] == len(traced["probes"])
    assert traced["totals"]["join.expand"]["calls"] < len(traced["probes"])


def test_sort_join_row_counts(traced):
    totals = traced["totals"]
    assert totals["join.sorted_rows"]["count"] == sum(
        padded_r for padded_r, _live_r, _padded_l in traced["probes"])
    assert totals["join.live_rows"]["count"] == sum(
        live_r for _padded_r, live_r, _padded_l in traced["probes"])
    assert totals["join.searched_rows"]["count"] == sum(
        padded_l for _padded_r, _live_r, padded_l in traced["probes"])
    assert 0 < totals["join.live_rows"]["count"] < \
        totals["join.sorted_rows"]["count"]
    assert totals["join.sorted_rows"]["calls"] == 0
    assert totals["join.searched_rows"]["calls"] == 0


def test_host_seconds_nest(traced):
    host = {name: t["host_s"] for name, t in traced["totals"].items()}
    assert host["batch.run"] >= host["batch.readback"] > 0
    assert host["batch.run"] >= sum(
        host[n] for n in ("batch.readback", *STREAM_TIMED))


@pytest.mark.cuda
def test_stream_timed_spans_time_the_card():
    """On the card every stream-timed span reads stream seconds, and
    together they fit inside the run's wall time (they do not nest, so
    their event intervals do not overlap); the host-only spans read
    none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    rels = _catalog()
    queries = _queries()
    eng = Engine(rels, CONFIG, device=dev)
    want = _want(rels, queries)
    assert eng.run_batch(queries) == want          # warm: columns, kernels
    torch.cuda.synchronize(dev)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        lines = eng.run_batch(queries)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    totals = profiling.span_totals()
    profiling.reset_spans()
    assert lines == want
    timed = [totals[n]["stream_s"] for n in STREAM_TIMED]
    assert all(s > 0 for s in timed), totals
    assert sum(timed) <= wall
    assert totals["batch.run"]["stream_s"] == 0
    assert totals["batch.readback"]["stream_s"] == 0
