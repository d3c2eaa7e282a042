"""Point-cloud and pose file IO (host side, numpy).

Counterpart of ``small_gicp_tpu/utils/io.py``: the KITTI float4 ``.bin``
reader and writer, the sorted scan list of a directory, the PLY reader
(ascii and binary, arbitrary scalar vertex properties; xyz and optional
nx/ny/nz) and writer, and the 4x4 pose-matrix reader.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_BYTE_ORDER = {"binary_little_endian": "<", "binary_big_endian": ">"}


def read_kitti_bin(path: str) -> np.ndarray:
    """A KITTI velodyne scan (float32 x, y, z, intensity rows) → [N,3] xyz."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return raw[:, :3].copy()


def write_kitti_bin(path: str, points_xyz: np.ndarray) -> None:
    """[N,3] xyz → a KITTI velodyne scan (float32 x, y, z, intensity 0), the
    inverse of ``read_kitti_bin``."""
    pts = np.asarray(points_xyz, np.float32)
    raw = np.zeros((pts.shape[0], 4), np.float32)
    raw[:, :3] = pts[:, :3]
    raw.tofile(path)


def list_kitti_scans(directory: str):
    """Sorted paths of the ``*.bin`` scans in ``directory``."""
    names = sorted(n for n in os.listdir(directory) if n.endswith(".bin"))
    return [os.path.join(directory, n) for n in names]


def read_pose_matrix(path: str) -> np.ndarray:
    """A whitespace 4x4 (or 3x4) pose matrix file → [4,4] float64."""
    m = np.loadtxt(path)
    if m.shape == (3, 4):
        m = np.vstack([m, [0.0, 0.0, 0.0, 1.0]])
    if m.shape != (4, 4):
        raise ValueError(f"expected 4x4 pose, got {m.shape}")
    return m


def read_ply(path: str, return_normals: bool = False):
    """The vertices of a PLY file → [N,3] float32 xyz, and with
    ``return_normals`` the pair (xyz, [N,3] float32 normals or None)
    (benchmark/read_points.hpp:52-77)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = n_vertex = None
        props = []  # (name, numpy dtype) of the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected end of file in the PLY header")
            tokens = line.decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise ValueError("list properties on the vertex element are "
                                     "not supported")
                props.append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt is None or n_vertex is None:
            raise ValueError("malformed PLY header")
        names = [name for name, _ in props]
        if any(axis not in names for axis in "xyz"):
            raise ValueError(f"{path} has no x/y/z vertex properties")
        if fmt in _BYTE_ORDER:
            dtype = np.dtype([(n, _BYTE_ORDER[fmt] + d) for n, d in props])
            data = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype)
            cols = {n: data[n] for n in names}
        elif fmt == "ascii":
            rows = np.loadtxt(f, max_rows=n_vertex, ndmin=2)
            cols = {n: rows[:, j] for j, n in enumerate(names)}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    def stack(axes):
        return np.stack([cols[a] for a in axes], axis=1).astype(np.float32)

    xyz = stack(("x", "y", "z"))
    if not return_normals:
        return xyz
    return xyz, stack(("nx", "ny", "nz")) if {"nx", "ny", "nz"} <= set(names) else None


def write_ply(path: str, points: np.ndarray, normals: Optional[np.ndarray] = None):
    """A binary_little_endian PLY of xyz (and nx/ny/nz) float32 vertices
    (benchmark/read_points.hpp:80-109)."""
    points = np.asarray(points, dtype=np.float32)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    rec = np.zeros(points.shape[0], dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    with open(path, "wb") as f:
        f.write(b"ply\n")
        f.write(b"format binary_little_endian 1.0\n")
        f.write(f"element vertex {points.shape[0]}\n".encode())
        for name, _ in fields:
            f.write(f"property float {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())
