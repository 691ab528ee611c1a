"""Device kernels in the window's torch.profiler capture over its
queries: the stage ops' and dispatch's launches (ops/stage.py,
ops/join.py, ops/filter.py). Not read when the capture lost some of the
program's own csrc kernel launches (it then holds another number of them
than kernels.LAUNCHES counted)."""


def read(rec):
    cap = rec["capture"]
    if cap is None or not rec["capture_complete"] or not rec["queries"]:
        return None
    return cap["kernels"] / rec["queries"]
