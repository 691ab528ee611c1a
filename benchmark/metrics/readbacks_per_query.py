"""Device-to-host readbacks of the batch driver (models/batch.py,
`BatchExecutor.counters["readbacks"]`) over the traced window's queries.
Each one is a host synchronization inside a request."""


def read(rec):
    if "readbacks" not in rec["counters"] or not rec["queries"]:
        return None
    return rec["counters"]["readbacks"] / rec["queries"]
