"""Normal and covariance estimation from k nearest neighbours, in torch.

Counterpart of ``small_gicp_tpu/ops/normals.py``, exact mode. The
neighbour moments come from ``knn_moments`` (kernel K3 on the card),
then:
  * fewer than 5 neighbours → invalid: normal 0, covariance I;
  * cov = E[ddᵀ] − E[d]E[d]ᵀ over the query-centred offsets d (biased);
  * normal = smallest-eigenvalue eigenvector, flipped so normal·p ≤ 0;
  * GICP covariance = I − (1 − 1e-3)·v₀v₀ᵀ (plane regularisation).
"""

from __future__ import annotations

from typing import Optional

import torch

from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.ops.cov_fused_cuda import knn_moments
from small_gicp_tpu_torch.ops.eigh3 import smallest_eigvec3x3

_MIN_NEIGHBORS = 5


def _estimate_impl(points: torch.Tensor, num_points: torch.Tensor,
                   num_neighbors: int, need_normals: bool, need_covs: bool):
    n = points.shape[0]
    dt, dev = points.dtype, points.device
    xyz = points[:, :3]

    m1, m2, counts = knn_moments(points, num_points, num_neighbors)
    safe = torch.clamp(counts, min=1.0)
    mean = m1 / safe[:, None]
    cov = m2 / safe[:, None, None] - mean[:, :, None] * mean[:, None, :]
    v0 = smallest_eigvec3x3(cov)

    point_valid = (torch.arange(n, device=dev) < num_points) & (
        counts >= _MIN_NEIGHBORS)

    normals = covs = None
    if need_normals:
        flip = torch.sum(xyz * v0, dim=-1) > 0.0
        normal = torch.where(flip[:, None], -v0, v0)
        normal = torch.where(point_valid[:, None], normal, 0.0)
        normals = torch.cat([normal, normal.new_zeros((n, 1))], dim=-1)
    if need_covs:
        eye = torch.eye(3, dtype=dt, device=dev).expand(n, 3, 3)
        reg = eye - (1.0 - 1e-3) * v0[:, :, None] * v0[:, None, :]
        covs = torch.where(point_valid[:, None, None], reg, eye)
    return normals, covs


def estimate_normals_covariances(cloud: PointCloud, tree=None,
                                 num_neighbors: int = 20) -> PointCloud:
    """Normals and plane-regularised covariances (``tree`` is accepted for
    API parity; the search is exact over the cloud itself)."""
    normals, covs = _estimate_impl(cloud.points, cloud.num_points,
                                   num_neighbors, True, True)
    return cloud.replace(normals=normals, covs=covs)


def estimate_normals(cloud: PointCloud, tree=None,
                     num_neighbors: int = 20) -> PointCloud:
    normals, _ = _estimate_impl(cloud.points, cloud.num_points, num_neighbors,
                                True, False)
    return cloud.replace(normals=normals)


def estimate_covariances(cloud: PointCloud, tree=None,
                         num_neighbors: int = 20) -> PointCloud:
    _, covs = _estimate_impl(cloud.points, cloud.num_points, num_neighbors,
                             False, True)
    return cloud.replace(covs=covs)
