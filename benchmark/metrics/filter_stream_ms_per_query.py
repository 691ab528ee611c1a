"""Stream milliseconds a query of the filters and their compaction
(ops/filter.py, ops/compact.py): the batch driver's span rhj.filter,
the time between two CUDA events on the stream (its kernels and the
device's idle between them), over the traced window's queries."""

from benchmark.metrics._spans import stream_ms_per_query


def read(rec):
    return stream_ms_per_query(rec, ("filter",))
