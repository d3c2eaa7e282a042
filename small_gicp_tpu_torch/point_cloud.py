"""Fixed-capacity point cloud, in torch.

Counterpart of ``small_gicp_tpu/point_cloud.py``. One array schema
serves every stage:

  points  [N, 4] homogeneous (x, y, z, 1); padded rows = (SENTINEL,)*3 + (0,)
  normals [N, 4] (nx, ny, nz, 0)
  covs    [N, 3, 3]
  num_points: 0-d int32 tensor on the cloud's device; valid rows come first,
              except in a voxel map's cloud view, whose live rows (``live_rows``)
              stay at their slots and number ``num_points``.

``num_points`` stays a device tensor so that no stage has to wait for the
device to learn how many rows are valid; the kernels read it in place.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from small_gicp_tpu_torch.utils.profiling import host_read

# Coordinate of padding rows: distances to them are ~1e18, which loses
# every nearest-neighbour race and stays inside float32 range.
PAD_SENTINEL = 1.0e9


def pad_row(dtype, device) -> torch.Tensor:
    """[4] the padding row (sentinel x y z, w = 0), made on ``device`` by a
    kernel: a copy of a host constant would wait for the card."""
    return torch.where(torch.arange(4, device=device) < 3, PAD_SENTINEL, 0.0).to(dtype)


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path"
        )
    return dev


@dataclass
class PointCloud:
    points: torch.Tensor  # [N, 4]
    num_points: torch.Tensor  # 0-d int32
    normals: Optional[torch.Tensor] = None  # [N, 4]
    covs: Optional[torch.Tensor] = None  # [N, 3, 3]

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.points.dtype

    @property
    def device(self) -> torch.device:
        return self.points.device

    def replace(self, **changes) -> "PointCloud":
        return dataclasses.replace(self, **changes)

    def valid_mask(self) -> torch.Tensor:
        """[N] bool — True for real points, False for padding."""
        return torch.arange(self.capacity, device=self.device) < self.num_points

    def xyz(self) -> torch.Tensor:
        """[N, 3] coordinates."""
        return self.points[:, :3]

    @property
    def has_normals(self) -> bool:
        return self.normals is not None

    @property
    def has_covs(self) -> bool:
        return self.covs is not None

    def __repr__(self) -> str:
        return (f"PointCloud(num_points={int(self.num_points)}, "
                f"capacity={self.capacity}, normals={self.normals is not None}, "
                f"covs={self.covs is not None}, "
                f"dtype={str(self.dtype).removeprefix('torch.')})")

    def astype(self, dtype) -> "PointCloud":
        """The cloud with its points, normals and covariances in ``dtype`` (a
        torch dtype, or a numpy dtype or name such as ``np.float64``)."""
        dt = as_torch_dtype(dtype)
        return PointCloud(
            points=self.points.to(dt), num_points=self.num_points,
            normals=None if self.normals is None else self.normals.to(dt),
            covs=None if self.covs is None else self.covs.to(dt))

    # Host views: the first num_points rows as numpy (one host read each).
    def points_numpy(self) -> np.ndarray:
        """[num_points, 4] valid points."""
        return self.points[:len(self)].cpu().numpy()

    def normals_numpy(self) -> np.ndarray:
        return self.normals[:len(self)].cpu().numpy()

    def covs_numpy(self) -> np.ndarray:
        return self.covs[:len(self)].cpu().numpy()

    def __len__(self) -> int:
        return int(self.num_points)

    # The bindings' accessors (pointcloud.cpp: size/empty and point(i),
    # normal(i), cov(i)); rows at or past num_points raise.
    def size(self) -> int:
        return int(self.num_points)

    def empty(self) -> bool:
        return int(self.num_points) == 0

    def _check_index(self, i: int) -> int:
        n, i = int(self.num_points), int(i)
        if not 0 <= i < n:
            raise IndexError(f"index {i} out of range [0, {n})")
        return i

    def point(self, i: int) -> np.ndarray:
        """The i-th point as a homogeneous 4-vector."""
        return self.points[self._check_index(i)].cpu().numpy()

    def normal(self, i: int) -> np.ndarray:
        """The i-th normal as a 4-vector."""
        return self.normals[self._check_index(i)].cpu().numpy()

    def cov(self, i: int) -> np.ndarray:
        """The i-th covariance, 3x3."""
        return self.covs[self._check_index(i)].cpu().numpy()

    @staticmethod
    def from_points(points, capacity: Optional[int] = None, dtype=None, *,
                    device=None) -> "PointCloud":
        """Build from an [M, 3] or [M, 4] array (numpy or torch).

        Floating inputs keep their dtype unless ``dtype`` is given; other
        inputs become float32.
        """
        dev = resolve_device(device)
        pts = torch.as_tensor(np.asarray(points)) if not isinstance(
            points, torch.Tensor) else points
        if pts.ndim != 2 or pts.shape[1] not in (3, 4):
            raise ValueError(f"points must be [N,3] or [N,4], got {tuple(pts.shape)}")
        m = pts.shape[0]
        n = capacity if capacity is not None else m
        if n < m:
            raise ValueError(f"capacity {n} < number of points {m}")
        dt = dtype if dtype is not None else (
            pts.dtype if pts.is_floating_point() else torch.float32
        )
        buf = torch.full((n, 4), PAD_SENTINEL, dtype=dt, device=dev)
        buf[:, 3] = 0.0
        buf[:m, :3] = pts[:, :3].to(device=dev, dtype=dt)
        buf[:m, 3] = 1.0
        with host_read("num_points"):  # a pageable copy to the card waits for it
            num = torch.tensor(m, dtype=torch.int32, device=dev)
        return PointCloud(points=buf, num_points=num)

    def with_capacity(self, capacity: int) -> "PointCloud":
        """Grow or shrink the capacity (keeps the first ``capacity`` rows);
        grown rows are padding."""
        n = self.capacity
        if capacity == n:
            return self

        def pad_or_trim(a, fill):
            if a is None:
                return None
            if capacity <= n:
                return a[:capacity]
            return torch.cat([a, a.new_full((capacity - n,) + a.shape[1:], fill)])

        pts = pad_or_trim(self.points, PAD_SENTINEL)
        if capacity > n:
            pts[n:, 3] = 0.0
        return PointCloud(
            points=pts,
            num_points=torch.clamp(self.num_points, max=capacity).to(torch.int32),
            normals=pad_or_trim(self.normals, 0.0),
            covs=pad_or_trim(self.covs, 0.0),
        )


def stack_clouds(clouds) -> PointCloud:
    """Stack clouds of one capacity into a PointCloud whose tensors carry a
    leading [U] axis (points [U,N,4], num_points [U], ...): the layout of
    ``align_fleet``'s targets and sources. Pad with ``with_capacity`` first.
    """
    clouds = list(clouds)
    if not clouds:
        raise ValueError("stack_clouds needs at least one cloud")
    if len({c.capacity for c in clouds}) != 1:
        raise ValueError("clouds must share one capacity; pad them with "
                         "PointCloud.with_capacity")

    def stack(name):
        parts = [getattr(c, name) for c in clouds]
        if all(p is None for p in parts):
            return None
        if any(p is None for p in parts):
            raise ValueError(f"either every cloud carries {name} or none does")
        return torch.stack(parts)

    return PointCloud(points=stack("points"), num_points=stack("num_points"),
                      normals=stack("normals"), covs=stack("covs"))


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to [N,4] homogeneous points.

    Padding rows have w=0, so the translation is not applied and the
    sentinel stays far away.
    """
    return points @ T.T


def transform_covs(T: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """R C Rᵀ for [N,3,3] covariances (reference: gicp_factor.hpp:59)."""
    R = T[:3, :3].to(covs.dtype)
    return R @ covs @ R.T


def live_rows(points: torch.Tensor, num_points) -> torch.Tensor:
    """[..., N] bool: the rows a search takes part in, the first
    ``num_points`` live rows (counts [...] for stacked clouds). Liveness is
    w > 0.5, as the JAX package's ``compact_cloud`` defines it; rows at the
    padding sentinel are left out too, since they lose every race there. A
    front-packed cloud's are its first ``num_points`` rows; a voxel map's
    cloud view (``ivm_as_cloud``) keeps them at slot positions, with
    ``num_points`` their count. No host read."""
    live = (points[..., 3] > 0.5) & (points[..., 0] < 0.5 * PAD_SENTINEL)
    num = torch.as_tensor(num_points, device=points.device)[..., None]
    return live & (torch.cumsum(live, dim=-1) <= num)


def compact_cloud(cloud: PointCloud, rows: int) -> PointCloud:
    """The cloud's live rows (w > 0.5) packed in order into a cloud of
    ``rows`` rows, normals and covariances carried; live rows beyond the
    first ``rows`` are dropped, and ``num_points`` is min(live, rows). A
    voxel map's cloud view (``ivm_as_cloud``, ``voxelmap_as_cloud``) keeps
    its live rows at slot positions: this shrinks it before a fused
    prepare. Liveness is the JAX package's rule, not ``live_rows``; the two
    agree on the maps' views, whose dead rows have w = 0. One scatter into
    a spare row past the end, no host read."""
    p = cloud.points
    cap = p.shape[0]
    live = p[:, 3] > 0.5
    li = live.to(torch.int64)
    rank = torch.cumsum(li, 0) - li
    dst = torch.where(live & (rank < rows), rank, rows)

    cols = [p]
    if cloud.normals is not None:
        cols.append(cloud.normals)
    if cloud.covs is not None:
        cols.append(cloud.covs.reshape(cap, 9))
    fused = torch.cat(cols, dim=1)
    out = fused.new_zeros((rows + 1, fused.shape[1]))
    out[:, 0:3] = PAD_SENTINEL
    out.index_put_((dst,), fused)
    out = out[:rows]
    off = 4
    normals = covs = None
    if cloud.normals is not None:
        normals, off = out[:, off:off + 4], off + 4
    if cloud.covs is not None:
        covs = out[:, off:off + 9].reshape(rows, 3, 3)
    return PointCloud(points=out[:, 0:4],
                      num_points=torch.clamp(li.sum(), max=rows).to(torch.int32),
                      normals=normals, covs=covs)
