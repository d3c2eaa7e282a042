"""What a run's host and card did during its window, printed on standard
error beside the result, to find where the runs' spread comes from: the
process's CPU time and context switches over the window, the host's steal
time and load, the CPUs the main thread ran on, the window's rate second
by second, the speed of one host core on a fixed loop just after the
window, and the card's clocks and power as the window closed. None of it
is a metric; reading it never touches the window."""

from __future__ import annotations

import os
import resource
import shutil
import subprocess
import time
from typing import Dict, List

GPU_QUERY = ("clocks.sm,clocks.max.sm,clocks.mem,power.draw,power.limit,"
             "temperature.gpu,clocks_throttle_reasons.active")


def _cpu_jiffies() -> List[int]:
    """The host's summed CPU jiffies: user nice system idle iowait irq
    softirq steal."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except OSError:
        return []


def current_cpu() -> int:
    """The CPU the calling thread last ran on (-1 where unknown)."""
    try:
        with open("/proc/thread-self/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        return -1


class Window:
    """Readings around a measured window; ``tick`` is called by the
    window's loop after each unit of work and costs one clock read."""

    def __init__(self):
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)
        self.j0 = _cpu_jiffies()
        self.t0 = time.perf_counter()
        self.next = self.t0 + 1.0
        self.marks: List[tuple] = []  # (t, units done, cpu)

    def tick(self, now: float, units: int) -> None:
        if now >= self.next:
            self.marks.append((now, units, current_cpu()))
            self.next += 1.0

    def close(self, units: int) -> Dict[str, object]:
        t1 = time.perf_counter()
        ru = resource.getrusage(resource.RUSAGE_SELF)
        j1 = _cpu_jiffies()
        wall = t1 - self.t0
        out: Dict[str, object] = {
            "cpu_share": round((ru.ru_utime + ru.ru_stime - self.ru0.ru_utime
                                - self.ru0.ru_stime) / wall, 4),
            "invol_switches": ru.ru_nivcsw - self.ru0.ru_nivcsw,
            "vol_switches": ru.ru_nvcsw - self.ru0.ru_nvcsw,
            "loadavg_1m": round(os.getloadavg()[0], 2),
            "cpus_allowed": len(os.sched_getaffinity(0)),
            "cpus_used": sorted({c for _, _, c in self.marks}),
        }
        if self.j0 and j1:
            d = [b - a for a, b in zip(self.j0, j1)]
            total = max(sum(d), 1)
            out["host_busy_share"] = round(1 - (d[3] + d[4]) / total, 4)
            out["host_steal_share"] = round(d[7] / total, 4)
        rates, (tp, up) = [], (self.t0, 0)
        for t, u, _ in self.marks + [(t1, units, -1)]:
            if t - tp >= 0.5:  # the window's last part second, where it has one
                rates.append(round((u - up) / (t - tp), 2))
            tp, up = t, u
        out["rate_by_second"] = rates
        out["core_mops"] = core_speed()
        return out


def core_speed(n: int = 200_000, repeats: int = 5) -> float:
    """Millions of iterations a second of a fixed pure-Python loop on this
    core, the best of ``repeats`` (a reading of how fast the host runs the
    program's host-bound launch stream, which the window cannot show)."""
    best = float("inf")
    for _ in range(repeats):
        t = time.perf_counter()
        x = 0
        for i in range(n):
            x += i
        best = min(best, time.perf_counter() - t)
    return round(n / best / 1e6, 3)


def gpu() -> Dict[str, str]:
    """The card's clocks, power and throttle reasons now, from nvidia-smi
    (empty where it is absent or fails)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {}
    try:
        line = subprocess.run([exe, f"--query-gpu={GPU_QUERY}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    vals = [v.strip() for v in line.splitlines()[0].split(",")] if line.strip() else []
    return dict(zip(GPU_QUERY.split(","), vals))
