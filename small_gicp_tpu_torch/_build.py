"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``.
All sources compile in parallel, at first use, into ``build/kernels/`` at
the repository root (listed in ``.gitignore``). A library's file name
carries a hash of its sources and flags, so an edited source rebuilds and
an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of each library: name → argument types. All return int:
# a launch entry returns cudaGetLastError() after its launch, a *_rows
# entry a constant of its kernels that the wrapper repeats, and a *_geometry
# entry 0 after writing such constants (sgt_box_geometry: those of
# csrc/common.cuh).
SIGNATURES = {
    "gicp_fused": {
        "sgt_gicp_linearize": [_P, _P, _P, _P, _I, _P, _F, _F, _I, _I, _P, _P, _P],
        "sgt_gicp_linearize_score": [_P, _P, _P, _P, _I, _P, _F, _F, _I, _I, _P, _P,
                                     _P],
        "sgt_gicp_error_multi": [_P, _P, _P, _I, _P, _I, _F, _I, _P, _P],
        "sgt_gicp_linearize_fleet": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _F,
                                     _F, _I, _I, _P, _P, _P],
        "sgt_gicp_error_multi_fleet": [_P, _P, _I, _P, _I, _I, _P, _I, _F, _I, _P,
                                       _P],
        "sgt_linearize_block_rows": [],
        "sgt_trials_block_rows": [],
    },
    "gicp_fleet": {
        "sgt_fleet_linearize": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P,
                                _F, _F, _I, _I, _P, _P, _P, _P, _P],
        "sgt_fleet_error_multi": [_P, _P, _I, _P, _I, _I, _P, _I, _F, _I, _P, _P, _P,
                                  _P],
        "sgt_fleet_trial_block_rows": [],
        "sgt_box_geometry": [_P],
    },
    "gicp_swept": {
        "sgt_gicp_linearize_swept": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _F, _F,
                                     _I, _I, _I, _P, _P, _P, _P, _P],
        "sgt_gicp_linearize_swept_v1": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _F,
                                        _F, _I, _I, _P, _P, _P],
        "sgt_box_geometry": [_P],
    },
    "gicp_listed": {
        "sgt_gicp_linearize_listed": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _F, _F,
                                      _I, _I, _I, _P, _P, _P, _P, _P, _P],
        "sgt_gicp_linearize_listed_score": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P,
                                            _F, _F, _I, _I, _I, _P, _P, _P, _P, _P,
                                            _P],
        "sgt_box_geometry": [_P],
    },
    "gicp_step": {
        "sgt_gicp_step": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _F, _I, _P, _P, _P, _P],
        "sgt_gicp_step_errors": [_P, _P, _P, _I, _P, _I, _F, _I, _P, _P, _P, _P],
        "sgt_step_geometry": [_P],
    },
    "cov_fused": {
        "sgt_knn_moments": [_P, _P, _P, _I, _P, _I, _I, _P, _P],
        "sgt_knn_normals_covs": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P],
        "sgt_knn_moments_v1": [_P, _P, _I, _I, _P, _P],
        "sgt_knn_moments_geometry": [_P],
        "sgt_knn_topk_idx": [_P, _P, _I, _P, _I, _I, _P, _P, _P],
        "sgt_knn_topk_idx_v1": [_P, _P, _I, _P, _I, _I, _P, _P, _P],
        "sgt_knn_moments_warp": [_P, _P, _P, _I, _P, _I, _I, _P, _P],
        "sgt_knn_moments_warp_v1": [_P, _P, _I, _I, _P, _P],
        "sgt_box_geometry": [_P],
    },
    "knn": {
        "sgt_nn1": [_P, _P, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P],
        "sgt_knn": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                    _P],
        "sgt_nn1_v1": [_P, _P, _I, _P, _I, _I, _P, _I, _P, _P, _P],
        "sgt_knn_v1": [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P],
        "sgt_knn_warp": [_P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
        "sgt_knn_warp_v1": [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P],
        "sgt_knn_warp_geometry": [_P],
        "sgt_knn_pruned": [_P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P,
                           _P],
        "sgt_knn_pruned_v1": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P],
        "sgt_box_geometry": [_P],
        "sgt_knn_split_geometry": [_P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every library that is not built yet, all sources at once.

    Returns {name: seconds} for the libraries compiled in this call. The
    compiler's report (registers, spills) goes to ``<library>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in SIGNATURES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        report, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{report[-4000:]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def build_log(name: str) -> str:
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _target(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


_geometry_checked = set()


def library_with_geometry(name: str, entry: str, expected: tuple) -> ctypes.CDLL:
    """``library(name)``; on the first call the tile constants that the C
    entry ``entry`` writes are held against ``expected``, the values the
    wrapper's prologue and plain version repeat, so that the two cannot
    drift apart unnoticed."""
    lib = library(name)
    if (name, entry) not in _geometry_checked:
        got = (ctypes.c_int * len(expected))()
        getattr(lib, entry)(got)
        if tuple(got) != tuple(expected):
            raise RuntimeError(
                f"csrc/{name}.cu was compiled with tile constants {tuple(got)} "
                f"({entry}); the Python wrapper has {tuple(expected)}")
        _geometry_checked.add((name, entry))
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {rc}")


def require(t, name: str, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (None matches any extent)."""
    import torch

    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}; the CUDA "
                         "kernels run float32 clouds")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
