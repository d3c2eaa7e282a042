"""Projective (tree-free) nearest-neighbour search, in torch.

Counterpart of ``small_gicp_tpu/ops/projective_search.py`` and of the
reference's ProjectiveSearch (ann/projective_search.hpp:13-219): the target
points go into an equirectangular (azimuth, elevation) index image, one row
id a pixel, and a query looks only at the (2·window_h+1)×(2·window_v+1)
pixels around its own projection, the column wrapping and the row clamped.
Meant for spinning-LiDAR scans, where one beam is about one image row.

The image is built by one scatter: where several points fall on a pixel the
last one (the highest row id) wins, as in the reference's sequential fill.
``scatter_reduce_(…, "amax")`` gives that on the card and on the CPU alike
(``index_put_`` leaves duplicates undefined on the card); out-of-image rows
go to a spare slot past the image. A query gathers its window's pixels,
takes the distances of the non-empty ones (empty pixels: d² = ``_FAR``) and
keeps the first minimum (NN) or the k smallest by stable sort (kNN), ties
to the lower window position as ``argmin`` and ``lax.top_k`` break them.
The pixel of a point is computed in float64 (the JAX package: the cloud's
dtype), so that the card and the CPU build the same image. Torch ops on
either device, no host read.
"""

from __future__ import annotations

import math
import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from small_gicp_tpu_torch.point_cloud import PointCloud

_FAR = 1.0e18


@dataclass
class ProjectiveSearch:
    """Equirectangular index-image searcher (UnsafeProjectiveSearch +
    EquirectangularProjection, ann/projective_search.hpp:13-148)."""

    points: torch.Tensor  # [N,4] target points (padded)
    index_image: torch.Tensor  # [H,W] int32, -1 = empty pixel
    width: int = 1024
    height: int = 64
    window_h: int = 10
    window_v: int = 5
    vertical_fov: float = 2.0944

    def replace(self, **changes) -> "ProjectiveSearch":
        return dataclasses.replace(self, **changes)

    @staticmethod
    def build(cloud: PointCloud, width: int = 1024, height: int = 64,
              window_h: int = 10, window_v: int = 5,
              vertical_fov: float = 2.0944) -> "ProjectiveSearch":
        """The index image of a cloud's first ``num_points`` rows; the
        default 120° vertical field is projective_search.hpp:20's."""
        uv = _project(cloud.points[:, :3], width, height, vertical_fov)
        n = cloud.capacity
        valid = cloud.valid_mask() & _in_bounds(uv, width, height)
        flat = torch.where(valid, uv[:, 1] * width + uv[:, 0], width * height).long()
        img = torch.full((width * height + 1,), -1, dtype=torch.int32, device=cloud.device)
        img.scatter_reduce_(0, flat, torch.arange(n, dtype=torch.int32, device=cloud.device),
                            "amax")
        return ProjectiveSearch(points=cloud.points,
                                index_image=img[:width * height].reshape(height, width),
                                width=width, height=height, window_h=window_h,
                                window_v=window_v, vertical_fov=vertical_fov)

    def nearest_neighbor_search(self, query_xyz) -> Tuple[torch.Tensor, torch.Tensor,
                                                          torch.Tensor]:
        """[Q,3] → (sq_dists [Q], indices [Q] int32, found [Q] bool)."""
        d2, idx = _window_candidates(self, self._queries(query_xyz))
        best = torch.argmin(d2, dim=-1, keepdim=True)  # the first minimum
        bd = torch.gather(d2, 1, best)[:, 0]
        return bd, torch.gather(idx, 1, best)[:, 0], bd < _FAR

    def knn_search(self, query_xyz, k: int):
        """[Q,3] → (sq_dists [Q,k], indices [Q,k] int32, found [Q,k] bool)."""
        d2, idx = _window_candidates(self, self._queries(query_xyz))
        d_sorted, pos = torch.sort(d2, dim=-1, stable=True)
        d_k = d_sorted[:, :k]
        return d_k, torch.gather(idx, 1, pos[:, :k]), d_k < _FAR

    def _queries(self, query_xyz) -> torch.Tensor:
        return torch.as_tensor(query_xyz, dtype=self.points.dtype,
                               device=self.points.device)[:, :3]


def _project(xyz: torch.Tensor, width: int, height: int, vfov: float) -> torch.Tensor:
    """[N,3] → [N,2] int32 pixel (u, v) of the equirectangular projection
    (projective_search.hpp:16-26), computed in float64: the card's and the
    CPU's atan2 / asin differ in the last float32 ulp, which would move a
    point on a pixel edge to the other side on one of them."""
    x, y, z = xyz[:, 0].double(), xyz[:, 1].double(), xyz[:, 2].double()
    dist = torch.sqrt(x * x + y * y + z * z)
    azimuth = torch.atan2(y, x)
    elevation = torch.asin(z / torch.clamp(dist, min=1e-12))
    u = (azimuth + math.pi) / (2.0 * math.pi) * width
    v = (elevation / vfov + 0.5) * height
    return torch.stack([torch.floor(u), torch.floor(v)], dim=-1).to(torch.int32)


def _in_bounds(uv: torch.Tensor, width: int, height: int) -> torch.Tensor:
    return (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)


def _window_candidates(ps: ProjectiveSearch, query_xyz: torch.Tensor):
    """(d² [Q,WIN], row ids [Q,WIN] int32) of each query's window, rows of
    pixels in order; empty pixels give d² = ``_FAR`` and row 0. The column
    wraps, the row clamps (projective_search.hpp:116-140)."""
    q = query_xyz.shape[0]
    dev = query_xyz.device
    uv = _project(query_xyz, ps.width, ps.height, ps.vertical_fov)
    du = torch.arange(-ps.window_h, ps.window_h + 1, device=dev, dtype=torch.int32)
    dv = torch.arange(-ps.window_v, ps.window_v + 1, device=dev, dtype=torch.int32)
    uu = torch.remainder(uv[:, 0, None] + du[None, :], ps.width)  # [Q,WU]
    vv = torch.clamp(uv[:, 1, None] + dv[None, :], 0, ps.height - 1)  # [Q,WV]
    pix = (vv[:, :, None] * ps.width + uu[:, None, :]).reshape(q, -1)
    cand = ps.index_image.reshape(-1)[pix.long()]
    safe = torch.clamp(cand, min=0)
    diff = ps.points[safe.long(), :3] - query_xyz[:, None, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    return torch.where(cand >= 0, d2, _FAR), safe
