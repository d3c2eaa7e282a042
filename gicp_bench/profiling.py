"""The benchmark's reading of a torch.profiler trace: a frozen copy of the
arithmetic of the repository's ``chip_smoke.py`` (``device_events``,
``api_counts``), with the device's busy time taken as the union of the
device events' intervals.

A torch op's average carries the time of the kernels it launched as well,
so only device events (kernels, copies, memsets) are summed; intervals that
overlap (two streams) count once in the busy time.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


@dataclass
class TraceSummary:
    """What the metric readers take from one traced stretch."""

    window_s: float  # host clock over the traced stretch
    busy_s: float  # union of device-event intervals
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)  # name: (count, s)
    api: Dict[str, int] = field(default_factory=dict)  # launches, copies, memsets, syncs
    device_ops: List[Tuple[str, float]] = field(default_factory=list)  # top by time
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest gaps

    def kernel(self, pattern: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name matches the
        regular expression ``pattern``."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if re.search(pattern, name):
                n += c
                s += t
        return n, s


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not e.is_user_annotation


def api_counts(averages) -> Dict[str, int]:
    """Kernel launches, copies, memsets and host synchronizations issued on
    the host (the CUDA runtime calls the profiler records)."""
    calls = {e.key: e.count for e in averages}
    return {"launches": calls.get("cudaLaunchKernel", 0)
            + calls.get("cuLaunchKernel", 0) + calls.get("cudaLaunchKernelExC", 0),
            "copies": sum(v for k, v in calls.items() if k.startswith("cudaMemcpy")),
            "memsets": sum(v for k, v in calls.items() if k.startswith("cudaMemset")),
            "syncs": sum(v for k, v in calls.items() if k in SYNC_CALLS)}


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (any unit, returned as
    given)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(prof, window_s: float, top: int = 10) -> TraceSummary:
    """Reduce a finished ``torch.profiler.profile`` to a TraceSummary."""
    events = prof.events()
    dev = [e for e in events if _is_device(e)]
    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    busy_us = union_seconds(intervals)
    kernels: Dict[str, Tuple[int, float]] = {}
    for e in dev:
        c, t = kernels.get(e.name, (0, 0.0))
        kernels[e.name] = (c + 1, t + (e.time_range.end - e.time_range.start) / 1e6)
    ops = sorted(((k[:120], t) for k, (_, t) in kernels.items()),
                 key=lambda kv: -kv[1])[:top]
    return TraceSummary(window_s=window_s, busy_s=busy_us / 1e6, kernels=kernels,
                        api=api_counts(prof.key_averages()), device_ops=ops,
                        idle_gaps=idle_gaps(events, dev, top))


def idle_gaps(events, dev, top: int) -> List[Tuple[str, float]]:
    """The ``top`` longest gaps between device events, each named by the
    host op that was running (outermost first) when the gap began."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    gaps = []
    end = None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if not _is_device(e) and not e.name.startswith("cuda")),
                  key=lambda h: h[0])
    out = []
    for g0, g1 in gaps:
        name = "host"
        for h0, h1, n in host:
            if h0 > g0:
                break
            if h1 >= g0:
                name = n
                break
        out.append((name[:120], (g1 - g0) / 1e6))
    return out
