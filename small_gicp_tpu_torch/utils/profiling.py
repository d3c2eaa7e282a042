"""Profiling and tracing utilities.

Counterpart of ``small_gicp_tpu/utils/profiling.py``:

  * ``trace(logdir)`` — ``torch.profiler`` around a block (CPU and, on the
    card, CUDA activity), written as a Chrome trace into ``logdir``.
  * ``StageTimer`` — named-stage wall-clock timers that wait for the device
    at each stage's end, so stage times are real on the asynchronous card;
    the reference's "mean ± std (median)" report per stage.
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
import os
import platform
import time
from pathlib import Path
from typing import Dict, Optional

import torch
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


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` and write a Chrome trace,
    ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
    card when it stored none.
    """

    def __init__(self):
        self.stages: Dict[str, Summarizer] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        box = {}
        yield box
        tensors = [t for t in _flatten_named(box)[1] if isinstance(t, torch.Tensor)]
        if tensors:
            tensors[-1].cpu()
        elif torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.stages.setdefault(name, Summarizer()).push(
            (time.perf_counter() - t0) * 1e3)

    def report(self) -> str:
        return "\n".join(f"{name}={s} [msec]" for name, s in self.stages.items())
