"""PCL point-type interop: structured dtypes with PCL's binary layouts.

Counterpart of ``small_gicp_tpu/pcl_interop.py``. The reference's PCL point
structs (include/small_gicp/pcl/pcl_point.hpp:13-39: PointCovariance =
PCL_ADD_POINT4D + Eigen::Matrix4f cov; PointNormalCovariance adds
PCL_ADD_NORMAL4D) are numpy structured dtypes here whose bytes match the
structs, so a ``pcl::PointCloud<T>.points`` buffer converts to and from a
:class:`PointCloud` without the ``pcl`` module:

  ``PCL_POINT_XYZ``                16 B  (x y z + 1 pad float)
  ``PCL_POINT_NORMAL``             48 B  (point4, normal4, curvature + 3 pad)
  ``PCL_POINT_COVARIANCE``         80 B  (point4 + 4x4 f32 cov)
  ``PCL_POINT_NORMAL_COVARIANCE``  96 B  (point4, normal4, 4x4 f32 cov)

Eigen stores Matrix4f column-major and the numpy (4,4) subarray is
row-major; the buffers agree because every covariance is symmetric.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from small_gicp_tpu_torch.point_cloud import PointCloud

# PCL_ADD_POINT4D: union { float data[4]; struct { float x, y, z; } }.
# data[3] is 1.0 on real PCL points; we write 1.0 and ignore it on read.
PCL_POINT_XYZ = np.dtype({
    "names": ["x", "y", "z", "data_w"],
    "formats": [np.float32] * 4,
    "offsets": [0, 4, 8, 12],
    "itemsize": 16,
})

# pcl::PointNormal: POINT4D + NORMAL4D + (curvature, 3 pad floats).
PCL_POINT_NORMAL = np.dtype({
    "names": ["x", "y", "z", "data_w",
              "normal_x", "normal_y", "normal_z", "data_n_w",
              "curvature"],
    "formats": [np.float32] * 9,
    "offsets": [0, 4, 8, 12, 16, 20, 24, 28, 32],
    "itemsize": 48,
})

# pcl::PointCovariance (reference pcl_point.hpp:13-24).
PCL_POINT_COVARIANCE = np.dtype({
    "names": ["x", "y", "z", "data_w", "cov"],
    "formats": [np.float32] * 4 + [(np.float32, (4, 4))],
    "offsets": [0, 4, 8, 12, 16],
    "itemsize": 80,
})

# pcl::PointNormalCovariance (reference pcl_point.hpp:27-39).
PCL_POINT_NORMAL_COVARIANCE = np.dtype({
    "names": ["x", "y", "z", "data_w",
              "normal_x", "normal_y", "normal_z", "data_n_w",
              "cov"],
    "formats": [np.float32] * 8 + [(np.float32, (4, 4))],
    "offsets": [0, 4, 8, 12, 16, 20, 24, 28, 32],
    "itemsize": 96,
})

_LAYOUTS = {
    "xyz": PCL_POINT_XYZ,
    "normal": PCL_POINT_NORMAL,
    "covariance": PCL_POINT_COVARIANCE,
    "normal_covariance": PCL_POINT_NORMAL_COVARIANCE,
}


def pcl_dtype(kind: str) -> np.dtype:
    """Structured dtype for a PCL point layout: 'xyz', 'normal',
    'covariance', or 'normal_covariance'."""
    try:
        return _LAYOUTS[kind]
    except KeyError:
        raise ValueError(
            f"unknown PCL layout {kind!r}; have {sorted(_LAYOUTS)}"
        ) from None


def from_pcl(data, kind: Optional[str] = None, capacity: Optional[int] = None, *,
             device=None) -> PointCloud:
    """PCL-layout buffer/array → :class:`PointCloud`.

    ``data`` is either a structured numpy array (fields detected from its
    dtype) or raw ``bytes`` — then ``kind`` selects the layout. Normals
    and covariances present in the layout are carried over; the cov's
    upper-left 3x3 block is kept, matching what the registration math
    reads (reference gicp_factor.hpp:59-60).

    Non-finite points are dropped, their normals and covariances with
    them: PCL buffers with is_dense=false carry NaN rows, which the
    reference's ROS path skips too (ros/ros_impl.hpp:45-120). The cloud goes
    to ``device`` (default: the card).
    """
    if isinstance(data, (bytes, bytearray, memoryview)):
        if kind is None:
            raise ValueError("raw buffers need kind= to pick the layout")
        arr = np.frombuffer(data, dtype=pcl_dtype(kind))
    else:
        arr = np.asarray(data)
        if arr.dtype.names is None:
            raise ValueError(
                "expected a structured array or raw bytes; plain arrays "
                "go through PointCloud.from_points / as_point_cloud"
            )
    names = arr.dtype.names
    for req in ("x", "y", "z"):
        if req not in names:
            raise ValueError(f"layout lacks field {req!r}; have {names}")
    xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=1)
    finite = np.isfinite(xyz).all(axis=1)
    if not finite.all():
        arr = arr[finite]  # keeps normals/covs aligned with xyz
        xyz = xyz[finite]
    cloud = PointCloud.from_points(xyz, capacity=capacity, device=device)
    n, cap = len(arr), cloud.capacity
    dt = np.float64  # converted to the cloud's dtype below
    if {"normal_x", "normal_y", "normal_z"} <= set(names):
        normals = np.zeros((cap, 4), dt)
        for i, f in enumerate(("normal_x", "normal_y", "normal_z")):
            normals[:n, i] = arr[f]
        cloud = cloud.replace(normals=torch.from_numpy(normals).to(cloud.points))
    # Only treat 'cov' as a covariance field when it has the PCL (4,4)
    # subarray shape (or an already-trimmed (3,3)); a structured array
    # that happens to name some other field 'cov' falls back to plain
    # xyz extraction instead of mis-slicing.
    cov_shape = arr.dtype.fields["cov"][0].shape if "cov" in names else None
    if cov_shape in ((4, 4), (3, 3)):
        covs = np.zeros((cap, 3, 3), dt)
        covs[:n] = arr["cov"][:, :3, :3]
        cloud = cloud.replace(covs=torch.from_numpy(covs).to(cloud.points))
    return cloud


def to_pcl(cloud: PointCloud, kind: Optional[str] = None) -> np.ndarray:
    """:class:`PointCloud` → structured array in a PCL binary layout.

    ``kind`` defaults to the richest layout the cloud can fill
    (normals+covs → 'normal_covariance', covs → 'covariance',
    normals → 'normal', else 'xyz'). ``.tobytes()`` of the result is a
    valid ``pcl::PointCloud<T>.points`` buffer for the matching struct.
    """
    if kind is None:
        if cloud.has_normals and cloud.has_covs:
            kind = "normal_covariance"
        elif cloud.has_covs:
            kind = "covariance"
        elif cloud.has_normals:
            kind = "normal"
        else:
            kind = "xyz"
    dt = pcl_dtype(kind)
    n = len(cloud)
    out = np.zeros(n, dt)
    xyz = cloud.points_numpy()[:, :3].astype(np.float32)
    out["x"], out["y"], out["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    out["data_w"] = 1.0  # PCL_ADD_POINT4D keeps data[3] = 1
    if "normal_x" in dt.names:
        if not cloud.has_normals:
            raise ValueError(f"layout {kind!r} needs normals")
        nrm = cloud.normals_numpy()[:, :3].astype(np.float32)
        out["normal_x"], out["normal_y"], out["normal_z"] = (
            nrm[:, 0], nrm[:, 1], nrm[:, 2]
        )
    if "cov" in dt.names:
        if not cloud.has_covs:
            raise ValueError(f"layout {kind!r} needs covariances")
        # 4x4 zero-padded, as the reference stores covs (points/traits.hpp
        # pads for SIMD; only the 3x3 block is ever read back).
        out["cov"][:, :3, :3] = cloud.covs_numpy().astype(np.float32)
    return out
