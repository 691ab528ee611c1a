"""Host milliseconds a query of the batch driver (models/batch.py) not
spent in its readbacks: the host seconds of rhj.batch.run
(`BatchExecutor.run_batch`, whole) less those of rhj.batch.readback
(each device-to-host copy, its wait included), over the traced window's
queries. What is left is planning, dispatch and the host combine."""

from benchmark.metrics._spans import span_totals


def read(rec):
    spans = span_totals(rec)
    if spans is None or not spans.get("batch.run", {}).get("calls"):
        return None
    readback = spans.get("batch.readback", {}).get("host_s", 0.0)
    return (spans["batch.run"]["host_s"] - readback) * 1e3 / rec["queries"]
