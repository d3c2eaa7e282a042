"""Exact brute-force neighbour search, in torch.

Counterpart of ``small_gicp_tpu/ops/knn.py``. ``KdTree`` keeps the
reference's name and is a plain container of the target rows; its
searches are exact brute force in difference form, d² = Σ (q − t)²
(no |q|² − 2q·t + |t|² expansion), with ties going to the lower index.
This is the plain path of the tests and of the kernels' plain versions;
the card path searches inside the fused kernels instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from small_gicp_tpu_torch.point_cloud import PointCloud

# Query rows per distance block: a [2048, M] block stays a few hundred MB
# at scan sizes.
QUERY_BLOCK = 2048


def sq_dists(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., Q,3] × [..., M,3] → [..., Q,M] squared distances in difference
    form (leading dimensions broadcast).

    The sum is written out as (dx² + dy²) + dz² so that it rounds exactly
    like the kernels' distance loop.
    """
    dx = q[..., :, None, 0] - t[..., None, :, 0]
    dy = q[..., :, None, 1] - t[..., None, :, 1]
    dz = q[..., :, None, 2] - t[..., None, :, 2]
    return dx * dx + dy * dy + dz * dz


def brute_force_knn(target_xyz: torch.Tensor, query_xyz: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN: (sq_dists [Q,k], indices [Q,k] int64), ascending, ties to
    the lower index."""
    ds, ids = [], []
    for s in range(0, query_xyz.shape[0], QUERY_BLOCK):
        d2 = sq_dists(query_xyz[s:s + QUERY_BLOCK], target_xyz)
        if k == 1:
            i = torch.argmin(d2, dim=1, keepdim=True)  # first minimum
            ds.append(torch.gather(d2, 1, i))
            ids.append(i)
        else:
            d_sorted, i = torch.sort(d2, dim=1, stable=True)
            ds.append(d_sorted[:, :k])
            ids.append(i[:, :k])
    return torch.cat(ds), torch.cat(ids)


@dataclass
class KdTree:
    """Searcher over a cloud's rows (API parity with the reference KdTree)."""

    points: torch.Tensor  # [M,4], padded with the sentinel
    num_points: torch.Tensor  # 0-d int32

    @staticmethod
    def build(cloud, device=None) -> "KdTree":
        if not isinstance(cloud, PointCloud):
            cloud = PointCloud.from_points(cloud, device=device)
        return KdTree(points=cloud.points, num_points=cloud.num_points)

    def knn_search(self, query_xyz, k: int):
        """[Q,3] (or one [3]) → (sq_dists [Q,k], idx [Q,k])."""
        q = torch.as_tensor(query_xyz, dtype=self.points.dtype,
                            device=self.points.device)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        d, i = brute_force_knn(self.points[:, :3], q[:, :3], k)
        return (d[0], i[0]) if single else (d, i)

    def nearest_neighbor_search(self, query_xyz):
        d, i = self.knn_search(query_xyz, 1)
        return d[..., 0], i[..., 0]


def knn_search(target: PointCloud, query_xyz, k: int):
    return KdTree.build(target).knn_search(query_xyz, k)


def nearest_neighbor_search(target: PointCloud, query_xyz):
    return KdTree.build(target).nearest_neighbor_search(query_xyz)
