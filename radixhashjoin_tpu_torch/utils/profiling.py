"""Per-operator profiling and roofline accounting (counterpart:
radixhashjoin_tpu/utils/profiling.py), and the batch driver's spans.

* OpProfiler: per-operator call counts, wall time (synchronized), bytes
  touched and the share of the card's published memory bandwidth they
  reach (the engine is gather/scatter-bound, so bandwidth is the roofline
  that matters).
* span(name, device) / count(name, n): the layers of the batch driver
  (models/batch.py), armed only while a torch.profiler capture records.
  A span then opens `record_function("rhj." + name)`, so the capture
  holds it on the device activity's clock, and adds its host seconds to
  SPANS; given a CUDA device it also adds its stream seconds: the time
  between two CUDA events on the current stream, its kernels and any
  device idle between them alike. `count` adds to a counter there.
  Unarmed, both cost one read of a module global.

Enable OpProfiler with EngineConfig(profile=True) (the CLI's --profile):
the batch executor then synchronizes after every operator it records
(accurate per-operator times, a slower end-to-end run) and
`engine.batch_executor.profiler.report()` renders the table. With
profile=False `record` returns its argument untouched and synchronizes
nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

# Published HBM bandwidth by CUDA device name. Other cards and the CPU
# report no roofline rather than a wrong one.
_HBM_BY_NAME = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(device: Optional[torch.device] = None
                    ) -> Optional[float]:
    """Published memory bandwidth of `device` (default: the current CUDA
    device), or None on the CPU, without a card, or on an unlisted card."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return _HBM_BY_NAME.get(torch.cuda.get_device_name(device))


@dataclasses.dataclass
class OpStats:
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0
    # the device the operator's tensors lay on (None: none seen)
    device: Optional[torch.device] = None

    @property
    def gb_per_s(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds > 0 else 0.0

    @property
    def roofline_frac(self) -> Optional[float]:
        if self.device is None or self.seconds <= 0:
            return None
        bw = hbm_bytes_per_s(self.device)
        if bw is None:
            return None
        return self.bytes / self.seconds / bw


def _tensors(objs):
    """The tensors among `objs`, walking tuples and lists (the leaves a
    JAX tree walk would give)."""
    for a in objs:
        if isinstance(a, (tuple, list)):
            yield from _tensors(a)
        elif isinstance(a, torch.Tensor):
            yield a


class OpProfiler:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.ops: Dict[str, OpStats] = defaultdict(OpStats)

    def record(self, name: str, result, inputs=()):
        """Wait for `result` to finish on its device and account the wait
        to `name`.

        The window opens when `record` is called, which is after the
        operator was queued: it times the device's remaining work plus
        the synchronization, as the JAX package times its
        block_until_ready. Operators queued before this one and not yet
        recorded finish inside the window too.

        Bytes = nbytes of `inputs` plus of every tensor in the result
        (tuples and lists walked). Callers pass only the tensors the op
        scans in full; a lower bound on memory traffic, so the roofline
        column is a conservative share."""
        if not self.enabled:
            return result
        outs = list(_tensors((result,)))
        device = next((t.device for t in outs if t.device.type == "cuda"),
                      None)
        t0 = time.perf_counter()
        if device is not None:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        s = self.ops[name]
        s.calls += 1
        s.seconds += dt
        s.bytes += arr_bytes(*inputs) + arr_bytes(*outs)
        if s.device is None and outs:
            s.device = outs[0].device
        return result

    def report(self) -> str:
        if not self.ops:
            return "(no ops recorded)"
        lines = [f"{'operator':<24}{'calls':>7}{'total s':>10}"
                 f"{'GB/s':>9}{'% roof':>8}"]
        for name, s in sorted(self.ops.items(), key=lambda kv: -kv[1].seconds):
            rf = s.roofline_frac
            roof = f"{100 * rf:>7.1f}%" if rf is not None else f"{'-':>8}"
            lines.append(f"{name:<24}{s.calls:>7}{s.seconds:>10.4f}"
                         f"{s.gb_per_s:>9.1f}{roof}")
        total = sum(s.seconds for s in self.ops.values())
        lines.append(f"{'TOTAL':<24}{'':>7}{total:>10.4f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.ops.clear()


def arr_bytes(*arrays) -> int:
    """Total nbytes of the tensors among `arrays` (tuples and lists
    walked)."""
    return sum(t.nbytes for t in _tensors(arrays))


# ---- spans: the batch driver's layers, armed by a torch.profiler capture

# name -> {"calls", "host_s", "stream_s", "count"}, accumulated only while
# a capture records (like kernels.LAUNCHES, for the process)
SPANS: Dict[str, Dict[str, float]] = {}
# (name, start event, end event) of stream-timed spans not yet resolved
_PENDING: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
_OFF = contextlib.nullcontext()


def _totals(name: str) -> Dict[str, float]:
    t = SPANS.get(name)
    if t is None:
        t = SPANS[name] = {"calls": 0, "host_s": 0.0, "stream_s": 0.0,
                           "count": 0}
    return t


class _Span:
    __slots__ = ("name", "stream", "range", "start", "t0")

    def __init__(self, name: str, stream):
        self.name = name
        self.stream = stream

    def __enter__(self):
        self.range = torch.profiler.record_function("rhj." + self.name)
        self.range.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            _PENDING.append((self.name, self.start, end))
        self.range.__exit__(*exc)
        t = _totals(self.name)
        t["calls"] += 1
        t["host_s"] += dt / 1e9
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context that, while a torch.profiler capture records, opens
    `record_function("rhj." + name)` and adds its host seconds to
    SPANS[name]. Given a CUDA `device`, two CUDA events on the device's
    current stream also time it, resolved by `span_totals()`: that is
    stream time, the span's kernels and the device's idle between them
    (the host launching slower than the card runs), not device-busy time.
    Stream-timed spans do not nest, so their intervals do not overlap.
    With no capture recording it returns one shared no-op context (one
    global read: no range, no clock, no event)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    stream = (torch.cuda.current_stream(device)
              if device is not None and device.type == "cuda" else None)
    return _Span(name, stream)


def count(name: str, n: int) -> None:
    """Add `n` to SPANS[name]["count"] while a capture records."""
    if _autograd_profiler._is_profiler_enabled:
        _totals(name)["count"] += n


def armed() -> bool:
    """Whether spans and counters record now (a capture is on)."""
    return _autograd_profiler._is_profiler_enabled


def span_totals() -> Dict[str, Dict[str, float]]:
    """A copy of SPANS with every pending stream interval added to its
    span's stream_s: each end event is waited for (after the measured
    window, never inside it) and its elapsed time read."""
    for name, start, end in _PENDING:
        end.synchronize()
        SPANS[name]["stream_s"] += start.elapsed_time(end) / 1e3
    _PENDING.clear()
    return {name: dict(t) for name, t in SPANS.items()}


def reset_spans() -> None:
    """Forget every span, counter and pending stream interval."""
    SPANS.clear()
    _PENDING.clear()
