"""Profiling and tracing utilities.

Counterpart of ``small_gicp_tpu/utils/profiling.py``, with the port's own
recorder of spans and counters:

  * ``span(name)``, ``host_read(site)``, ``count(name, n)`` — the program's
    spans and counters at its layers' boundaries. They record while a
    ``torch.profiler`` session records or inside ``tracing()``; otherwise a
    site costs one flag read and hands back one shared no-op object.
    ``collected()`` returns the record, ``reset()`` clears it.
  * ``trace(logdir)`` — ``torch.profiler`` around a block (CPU and, on the
    card, CUDA activity), written as a Chrome trace into ``logdir``, with
    the recorder's record of the block beside it.
  * ``StageTimer`` — named-stage wall-clock timers that wait for the device
    at each stage's end, so stage times are real on the asynchronous card;
    the reference's "mean ± std (median)" report per stage. Each stage is a
    recorder span.
  * ``nan_guard()`` — raises when a torch op produces a NaN while active
    (a dispatch mode that checks every floating output; it synchronizes
    each op, so it is a debugging tool and nothing on the main path uses it).
  * ``host_fingerprint()`` — a short id of this host's CPU capabilities,
    the same string as the JAX package's.
  * ``enable_compilation_cache()`` — the port's compiled artefacts are the
    kernel libraries (``nvcc``) and the native IO library (``g++``); this
    points both build directories at ``cache_dir/<host_fingerprint>``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import platform
import time
from collections import deque
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from small_gicp_tpu_torch.utils.benchmark import Summarizer
from small_gicp_tpu_torch.utils.checkpoint import _flatten_named


def host_fingerprint() -> str:
    """Short stable id of this host's CPU capability set, for namespacing
    build caches (a library built on another host may not run here)."""
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    h = hashlib.sha256((platform.machine() + "|" + feats).encode()).hexdigest()[:12]
    return f"host-{h}"


def enable_compilation_cache(cache_dir: Optional[str] = None,
                             min_compile_secs: float = 0.5) -> None:
    """Keep the built kernel and native libraries under
    ``cache_dir/<host_fingerprint>`` (``kernels/`` and ``native/``), so that
    processes and checkouts on one host share them. With ``cache_dir=None``
    the builds stay in the repository's ``build/``. Call before the first
    kernel launch or scan read. ``min_compile_secs`` is accepted for parity:
    every build is kept."""
    del min_compile_secs
    if cache_dir is None:
        return
    from small_gicp_tpu_torch import _build, native

    root = Path(cache_dir) / host_fingerprint()
    _build.BUILD_DIR = root / "kernels"
    native.BUILD_DIR = root / "native"


# ------------------------------------------------------------ recorder --

RECORDS = 1 << 16  # span records kept, the newest
# A profiler annotation: an op named by the open span path in the trace
# (torch's C++ form; ``record_function``'s Python enter and exit cost about
# six times as much on the host while the profiler records).
_annotate = torch._C._profiler._RecordFunctionFast


class _Recorder:
    """The process's record of spans and counters (one thread: the program
    calls its layers from one).

    A span's times are ``time.perf_counter_ns``; its self time is its
    duration less its children's. While a profiler records, the open span
    path is also a profiler annotation, one at a time: entering a child
    closes the parent's segment and leaving it reopens it, so that every
    instant of the program's host time lies in exactly one segment, named
    by the whole path (``odom.frame/odom.insert``). A trace's idle gap is
    then named by the segment the host was in when the card went idle."""

    def __init__(self):
        self.on = 0  # open ``tracing()`` blocks
        self.stack = []  # open spans: [name, path, start, child ns, id, parent id]
        self.segment = None  # the open profiler annotation
        self.next_id = 0
        self.reset()

    def reset(self):
        self.spans: Dict[str, list] = {}  # name: [count, total ns, self ns]
        self.counters: Dict[str, int] = {}
        self.records = deque(maxlen=RECORDS)  # (id, parent id, name, start, end)
        self.closed = 0

    def _reopen(self, path: Optional[str]):
        if self.segment is not None:
            self.segment.__exit__(None, None, None)
            self.segment = None
        if path is not None and _autograd_profiler._is_profiler_enabled:
            self.segment = _annotate(path)
            self.segment.__enter__()

    def enter(self, name: str):
        parent = self.stack[-1] if self.stack else None
        path = name if parent is None else parent[1] + "/" + name
        self._reopen(path)
        self.stack.append([name, path, time.perf_counter_ns(), 0, self.next_id,
                           -1 if parent is None else parent[4]])
        self.next_id += 1

    def exit(self):
        end = time.perf_counter_ns()
        name, _, start, child, sid, pid = self.stack.pop()
        ns = end - start
        agg = self.spans.setdefault(name, [0, 0, 0])
        agg[0] += 1
        agg[1] += ns
        agg[2] += ns - child
        self.records.append((sid, pid, name, start, end))
        self.closed += 1
        if self.stack:
            self.stack[-1][3] += ns
        self._reopen(self.stack[-1][1] if self.stack else None)


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _REC.enter(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        _REC.exit()
        return None


class _NoSpan:
    """The span every site gets while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_REC = _Recorder()
_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager: the span ``name`` inside whatever span is open."""
    if _REC.on or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _NO_SPAN


def host_read(site: str):
    """A context manager around a place where the host waits for the card
    (a copy to the host, a value read, a synchronize): the span
    ``read.<site>``, counted in ``host_reads``."""
    if _REC.on or _autograd_profiler._is_profiler_enabled:
        _REC.counters["host_reads"] = _REC.counters.get("host_reads", 0) + 1
        return _Span("read." + site)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if _REC.on or _autograd_profiler._is_profiler_enabled:
        _REC.counters[name] = _REC.counters.get(name, 0) + n


@contextlib.contextmanager
def tracing():
    """Record spans and counters inside the block, with no profiler."""
    _REC.on += 1
    try:
        yield
    finally:
        _REC.on -= 1


def collected() -> dict:
    """The record since the last ``reset()``: ``spans`` {name: {count,
    total_s, self_s}}, ``counters`` {name: n}, ``records`` (the newest
    ``RECORDS`` spans as {id, parent (-1: outermost), name, start_ns,
    end_ns}) and ``dropped`` (older spans no longer in ``records``)."""
    return {
        "spans": {k: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9}
                  for k, (c, t, s) in _REC.spans.items()},
        "counters": dict(_REC.counters),
        "records": [{"id": i, "parent": p, "name": n, "start_ns": s, "end_ns": e}
                    for i, p, n, s, e in _REC.records],
        "dropped": _REC.closed - len(_REC.records),
    }


def reset() -> None:
    """Clear the record (spans still open are recorded when they close)."""
    _REC.reset()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` and write a Chrome trace,
    ``<logdir>/trace.json`` (the program's spans in it as annotations), and
    the recorder's record of the block, ``<logdir>/spans.json``. The
    record is reset when the block starts."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(collected(), f)


class _NanGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Raise ``FloatingPointError`` when a torch op produces a NaN inside the
    block (while ``enable``)."""
    if not enable:
        yield
        return
    with _NanGuard():
        yield


class StageTimer:
    """Per-stage timers with device-synchronized ends.

        timer = StageTimer()
        with timer.stage("preprocess") as box:
            box["cloud"] = preprocess(...)   # waited for at the stage's end
        print(timer.report())

    A stage waits for the last tensor it stored in ``box`` (found through
    dicts, sequences and dataclasses such as PointCloud), or for the whole
    card when it stored none. While the recorder records, a stage is the
    span ``name`` and its wait the host read ``read.stage``.
    """

    def __init__(self):
        self.stages: Dict[str, Summarizer] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        box = {}
        with span(name):
            yield box
            tensors = [t for t in _flatten_named(box)[1] if isinstance(t, torch.Tensor)]
            with host_read("stage"):
                if tensors:
                    tensors[-1].cpu()
                elif torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
        self.stages.setdefault(name, Summarizer()).push(
            (time.perf_counter() - t0) * 1e3)

    def report(self) -> str:
        return "\n".join(f"{name}={s} [msec]" for name, s in self.stages.items())
