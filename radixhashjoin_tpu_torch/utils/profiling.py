"""Per-operator profiling and roofline accounting (counterpart:
radixhashjoin_tpu/utils/profiling.py).

* OpProfiler: per-operator call counts, wall time (synchronized), bytes
  touched and the share of the card's published memory bandwidth they
  reach (the engine is gather/scatter-bound, so bandwidth is the roofline
  that matters).
* trace(log_dir): a torch.profiler capture in TensorBoard format.

Enable with EngineConfig(profile=True) (the CLI's --profile): the batch
executor then synchronizes after every operator it records (accurate
per-operator times, a slower end-to-end run) and
`engine.batch_executor.profiler.report()` renders the table. With
profile=False `record` returns its argument untouched and synchronizes
nothing.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

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


def trace(log_dir: str):
    """A torch.profiler capture (host and, with a card, device activity)
    written to `log_dir` in TensorBoard format."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))


def arr_bytes(*arrays) -> int:
    """Total nbytes of the tensors among `arrays` (tuples and lists
    walked)."""
    return sum(t.nbytes for t in _tensors(arrays))
