"""The program's span totals after a traced window
(radixhashjoin_tpu_torch/utils/profiling.py `span_totals`: name ->
calls, host_s, stream_s, count, recorded only while the capture ran).
None without a device capture or queries, and from a program that keeps
no spans (then the metrics that read them are left out)."""


def span_totals(rec):
    if rec["capture"] is None or not rec["queries"]:
        return None
    from radixhashjoin_tpu_torch.utils import profiling
    read = getattr(profiling, "span_totals", None)
    spans = read() if read is not None else None
    return spans or None


def stream_ms_per_query(rec, names):
    """Stream ms a query of the spans in `names`, or None when none of
    them ran. Stream time is what lies between a span's two CUDA events:
    its kernels and the device's idle between them, not device-busy
    time alone."""
    spans = span_totals(rec)
    if spans is None:
        return None
    ran = [spans[n] for n in names if n in spans and spans[n]["calls"]]
    if not ran:
        return None
    return sum(t["stream_s"] for t in ran) * 1e3 / rec["queries"]
