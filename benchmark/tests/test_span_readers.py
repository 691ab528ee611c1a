"""The readers of the program's spans (metrics/_spans.py and the five
metrics that read it) on synthetic span totals: each number from its
spans, and None without a device capture, without queries, without the
spans it reads, and from a program that keeps no spans."""

import os

import pytest

from benchmark.spec import BENCH_DIR, load_module
from radixhashjoin_tpu_torch.utils import profiling

READERS = ("join_stream_ms_per_query", "filter_stream_ms_per_query",
           "aggregate_stream_ms_per_query", "host_dispatch_ms_per_query",
           "join_sort_live_share")


def _reader(name):
    return load_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py")).read


def _span(calls=1, host_s=0.0, stream_s=0.0, count=0):
    return {"calls": calls, "host_s": host_s, "stream_s": stream_s,
            "count": count}


def _rec(queries=20, capture=True):
    return {"queries": queries, "window_s": 2.0, "counters": {},
            "capture": {"busy_s": 1.5, "kernels": 10, "csrc_kernels": 0}
            if capture else None, "capture_complete": capture}


@pytest.fixture
def spans(monkeypatch):
    totals = {}
    monkeypatch.setattr(profiling, "span_totals", lambda: totals)
    return totals


def test_stream_ms_per_query(spans):
    spans.update({"join.probe": _span(20, 0.1, 0.8),
                  "join.expand": _span(20, 0.1, 0.3),
                  "join.match": _span(0),
                  "join.live_rows": _span(0, count=9),
                  "filter": _span(60, 0.2, 0.5),
                  "aggregate": _span(20, 0.1, 0.02)})
    assert _reader("join_stream_ms_per_query")(_rec()) == pytest.approx(55.0)
    assert _reader("filter_stream_ms_per_query")(_rec()) == pytest.approx(25.0)
    assert _reader("aggregate_stream_ms_per_query")(_rec()) == \
        pytest.approx(1.0)


def test_host_dispatch_is_the_run_less_its_readbacks(spans):
    spans.update({"batch.run": _span(20, 1.4, 0.0),
                  "batch.readback": _span(40, 0.6, 0.01)})
    assert _reader("host_dispatch_ms_per_query")(_rec()) == pytest.approx(40.0)
    del spans["batch.readback"]
    assert _reader("host_dispatch_ms_per_query")(_rec()) == pytest.approx(70.0)


def test_live_share(spans):
    spans.update({"join.sorted_rows": _span(0, count=4000),
                  "join.live_rows": _span(0, count=1000)})
    assert _reader("join_sort_live_share")(_rec()) == pytest.approx(25.0)


@pytest.mark.parametrize("name", READERS)
def test_none_without_what_it_reads(spans, name):
    read = _reader(name)
    assert read(_rec()) is None                       # no spans recorded
    spans.update({n: _span(0) for n in ("batch.run", "filter", "aggregate",
                                        "join.probe", "join.sorted_rows")})
    assert read(_rec()) is None                       # none of them ran
    spans.update({n: _span(3, 0.1, 0.1, 5) for n in spans})
    assert read(_rec()) is not None
    assert read(_rec(capture=False)) is None          # a CPU run
    assert read(_rec(queries=0)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_from_a_program_without_spans(monkeypatch, name):
    monkeypatch.delattr(profiling, "span_totals")
    assert _reader(name)(_rec()) is None
