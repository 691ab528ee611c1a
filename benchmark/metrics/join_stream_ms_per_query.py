"""Stream milliseconds a query of the sort join (ops/join.py via
ops/backend.py): the batch driver's spans rhj.join.probe (sort,
searchsorted, scatters), rhj.join.expand and rhj.join.match
(same-slot and case-3 joins), each the time between two CUDA events on
the stream, over the traced window's queries. It holds the device's
idle inside those spans as well as their kernels: not device-busy ms."""

from benchmark.metrics._spans import stream_ms_per_query

JOIN_SPANS = ("join.probe", "join.expand", "join.match")


def read(rec):
    return stream_ms_per_query(rec, JOIN_SPANS)
