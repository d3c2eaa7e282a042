"""ctypes bindings of the native host-side IO library.

Counterpart of ``small_gicp_tpu/native``: ``io_native.cpp`` (its own copy)
parses KITTI ``.bin`` and PLY scans and runs a prefetching loader whose
background thread reads scan i+1 while scan i registers on the card. The
library is built with ``g++`` at first use into ``build/native/`` at the
repository root, under a file name hashed on the source and the flags, so
an edited source rebuilds. Every entry point falls back to numpy where no
compiler is found (this is host IO, not a kernel); ``native_available``
says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "io_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def library_path() -> Path:
    """Where the library is (or will be) built: hashed on source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"io_native-{h.hexdigest()[:12]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fp = ctypes.POINTER(ctypes.c_float)
    lib.sgt_read_kitti_bin.restype = ctypes.c_int64
    lib.sgt_read_kitti_bin.argtypes = [ctypes.c_char_p, fp, ctypes.c_int64]
    lib.sgt_read_ply_xyz.restype = ctypes.c_int64
    lib.sgt_read_ply_xyz.argtypes = [ctypes.c_char_p, fp, ctypes.c_int64]
    lib.sgt_loader_create.restype = ctypes.c_void_p
    lib.sgt_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int32, ctypes.c_int64]
    lib.sgt_loader_next.restype = ctypes.c_int64
    lib.sgt_loader_next.argtypes = [ctypes.c_void_p, fp]
    lib.sgt_loader_destroy.restype = None
    lib.sgt_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library; None where it cannot be built."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        out = library_path()
        try:
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True)
                os.replace(tmp, out)
            _lib = _bind(ctypes.CDLL(str(out)))
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
        return _lib


def native_available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _read(entry: str, path: str, max_points: int) -> np.ndarray:
    out = np.empty((max_points, 3), np.float32)
    n = getattr(_lib, entry)(path.encode(), _fptr(out), max_points)
    if n < 0:
        raise IOError(f"failed to read {path}")
    return out[:n].copy()


def read_kitti_bin(path: str, max_points: int = 1 << 21) -> np.ndarray:
    """[N,3] float32 xyz of a KITTI velodyne ``.bin`` (native, else numpy)."""
    if _load() is None:
        from small_gicp_tpu_torch.utils import io as pyio

        return pyio.read_kitti_bin(path)
    return _read("sgt_read_kitti_bin", path, max_points)


def read_ply_xyz(path: str, max_points: int = 1 << 21) -> np.ndarray:
    """[N,3] float32 xyz of a PLY file (native, else numpy)."""
    if _load() is None:
        from small_gicp_tpu_torch.utils import io as pyio

        return pyio.read_ply(path)
    return _read("sgt_read_ply_xyz", path, max_points)


class DatasetLoader:
    """Prefetching scan iterator: the native library's background thread
    parses up to ``prefetch`` scans ahead of the consumer (sequential numpy
    reads where the library is absent). Each scan is [N,3] float32, cut to
    ``max_points`` rows.

    The host half of pipelined odometry: scan i+1 is parsed while scan i
    registers on the card (reference:
    odometry_benchmark_small_gicp_tbb_flow.cpp:56-141).
    """

    def __init__(self, paths: List[str], max_points: int = 1 << 21, prefetch: int = 4):
        self.paths = list(paths)
        self.max_points = max_points
        self.kitti = bool(self.paths) and self.paths[0].endswith(".bin")
        self._lib = _load()
        self._handle = None
        self._i = 0
        if self._lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._paths_keepalive = arr
            self._handle = self._lib.sgt_loader_create(
                arr, len(self.paths), max_points, 1 if self.kitti else 0, prefetch)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is not None:
            out = np.empty((self.max_points, 3), np.float32)
            n = self._lib.sgt_loader_next(self._handle, _fptr(out))
            if n == -2:  # the stream ended; an empty scan reads as 0 rows
                self.close()
                raise StopIteration
            if n < 0:
                raise IOError("scan read failed")
            return out[:n].copy()
        if self._lib is not None or self._i >= len(self.paths):
            # The native stream ended (and was closed), or the last file was read.
            raise StopIteration
        p = self.paths[self._i]
        self._i += 1
        scan = read_kitti_bin(p) if p.endswith(".bin") else read_ply_xyz(p)
        return scan[:self.max_points]

    def close(self):
        if self._handle is not None:
            self._lib.sgt_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
