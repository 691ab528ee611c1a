"""The traced run's reduction: `reduce_capture` reads a torch.profiler
capture of the window: the union of device activity, the device kernels
and the program's own csrc kernels among them, with each csrc kernel's
device seconds over every launch, the device operations that took most
time, and the idle gaps by what the host's main thread was doing then.

A csrc kernel is known by its demangled name, which starts with
`(anonymous namespace)::<name>(` for a plain `__global__` function of
the anonymous namespace; an overload with other parameter types counts
under the same key, a template (`void (anonymous namespace)::<name><`)
under none.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

# the __global__ functions of the program's csrc/ behind each launch
# counter of radixhashjoin_tpu_torch.kernels.LAUNCHES
CSRC_KERNELS = {"bincount": ("bincount_smem_kernel", "bincount_cached_kernel"),
                "gather": ("gather_kernel",),
                "gather2": ("gather2_kernel",),
                "radix_hist": ("radix_hist_kernel",),
                "rank_hist": ("rank_hist_kernel",)}
CSRC_KEY_PREFIXES = {key: tuple(f"(anonymous namespace)::{fn}("
                                 for fn in fns)
                     for key, fns in CSRC_KERNELS.items()}
CSRC_PREFIXES = sum(CSRC_KEY_PREFIXES.values(), ())
TOP = 10
NAME_CHARS = 120


def _union(intervals):
    """Merged [(start, end)] of possibly overlapping intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _host_at(cpu_events, points):
    """The innermost host event of the main thread open at each point
    (sorted points), or None: one sweep with a stack of open events."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(cpu_events) and cpu_events[i][0] <= p:
            while stack and stack[-1][1] <= cpu_events[i][0]:
                stack.pop()
            stack.append(cpu_events[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _annotation(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    return ev.name().startswith("bench.") or bool(flag and flag())


def csrc_seconds(kernels) -> Dict[str, float]:
    """Device seconds of [(start ns, end ns, name)] kernels, summed by
    the key of CSRC_KERNELS whose prefixes start the name (every key,
    0.0 where none ran)."""
    ns = dict.fromkeys(CSRC_KEY_PREFIXES, 0)
    for s, e, n in kernels:
        for key, prefixes in CSRC_KEY_PREFIXES.items():
            if n.startswith(prefixes):
                ns[key] += e - s
                break
    return {key: v / 1e9 for key, v in ns.items()}


def reduce_capture(prof, window_span: str) -> dict:
    """Device activity of a torch.profiler capture inside the host span
    named `window_span`: {"busy_s", "kernels", "csrc_kernels", "csrc_s",
    "device_ops", "idle_gaps"}, seconds as measured; `csrc_s` holds
    `csrc_seconds` of the window's kernels."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == cuda:
            # record_function ranges are mirrored onto the device's
            # timeline as annotations: they are no device activity
            if not _annotation(ev):
                device.append((start, start + dur, ev.name()))
        elif ev.device_type() == cpu:
            if ev.name() == window_span:
                window = (start, start + dur, ev.start_thread_id())
            host.append((start, start + dur, ev.name(),
                         ev.start_thread_id()))
    if window is None:
        raise RuntimeError(f"the capture has no {window_span!r} span")
    w0, w1, main = window
    device = [(max(s, w0), min(e, w1), n) for s, e, n in device
              if e > w0 and s < w1]
    kernels = [d for d in device
               if not d[2].startswith(("Memcpy", "Memset"))]
    merged = _union([(s, e) for s, e, _ in device])
    busy_ns = sum(e - s for s, e in merged)
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in device:
        by_name[n[:NAME_CHARS]] += (e - s) / 1e9
    gaps, prev = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    main_events = sorted((s, e, n) for s, e, n, t in host
                         if t == main and n != window_span)
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    labels = _host_at(main_events, [m for m, _ in mids])
    idle: Dict[str, float] = defaultdict(float)
    for (_, length), label in zip(mids, labels):
        idle[(label or "host outside any op")[:NAME_CHARS]] += length / 1e9
    return {"busy_s": busy_ns / 1e9, "kernels": len(kernels),
            "csrc_kernels": sum(1 for k in kernels
                                if k[2].startswith(CSRC_PREFIXES)),
            "csrc_s": csrc_seconds(kernels),
            "device_ops": sorted(by_name.items(), key=lambda x: -x[1])[:TOP],
            "idle_gaps": sorted(idle.items(), key=lambda x: -x[1])[:TOP]}
