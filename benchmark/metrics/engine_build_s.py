"""Host seconds of `Engine(...)` in set-up, ending in a synchronize: the
catalog and executors are built (models/device_catalog.py; the columns
themselves upload at first use, in the warm pass)."""


def read(rec):
    return rec["engine_build_s"]
