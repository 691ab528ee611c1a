"""Share of the rows the sort join sorts that are live, in %: 100 *
join.live_rows / join.sorted_rows, the batch driver's counters of each
probe's live and padded right (build) rows (ops/join.py `probe_count`
sorts the padded right side and binary-searches the left lanes into
it)."""

from benchmark.metrics._spans import span_totals


def read(rec):
    spans = span_totals(rec)
    if spans is None or not spans.get("join.sorted_rows", {}).get("count"):
        return None
    live = spans.get("join.live_rows", {}).get("count", 0)
    return 100.0 * live / spans["join.sorted_rows"]["count"]
