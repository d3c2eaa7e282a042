"""Exact neighbour search behind ``KdTree``, in torch.

Counterpart of ``small_gicp_tpu/ops/knn.py``. ``KdTree`` keeps the
reference's name and is a plain container of the target rows; its
searches are exact, with ties going to the lower index. Routing follows
the JAX package with the card in the TPU's place: a float32 tree on CUDA
sends k = 1 to kernel K9 and 1 < k ≤ 64 to kernel K10
(``ops/knn_cuda.py``); everything else — k > 64, float64, CPU tensors —
goes to ``brute_force_knn`` below, a torch brute force in difference
form, d² = Σ (q − t)² (no |q|² − 2q·t + |t|² expansion), as the JAX
package sends those cases to its XLA path. Indices are int32, as in the
JAX API.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple

import numpy as np
import torch

from small_gicp_tpu_torch.point_cloud import PointCloud, live_rows

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


def first_k(d2: torch.Tensor, ids: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest columns of each row of ``d2`` [B,L] by stable sort (ties
    to the earlier column); ``ids`` [L] names the columns. Empty slots: d²
    3e38, index 0; indices int32."""
    big = 3.0e38
    if d2.shape[1] < k:
        d2 = torch.cat([d2, d2.new_full((d2.shape[0], k - d2.shape[1]), big)], dim=1)
        ids = torch.cat([ids, ids.new_zeros(k - ids.shape[0])])
    d_sorted, pos = torch.sort(d2, dim=1, stable=True)
    d_k = d_sorted[:, :k]
    idx = ids[pos[:, :k]]
    return d_k, torch.where(d_k < big, idx, 0).to(torch.int32)


def brute_force_knn(target_xyz: torch.Tensor, query_xyz: torch.Tensor, k: int,
                    block: int = QUERY_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN: (sq_dists [Q,k], indices [Q,k] int32), ascending, ties to
    the lower index; ``block`` query rows per distance block. Slots beyond
    the target's rows (k > M) hold inf and index 0."""
    m = target_xyz.shape[0]
    ds, ids = [], []
    for s in range(0, query_xyz.shape[0], block):
        d2 = sq_dists(query_xyz[s:s + block], target_xyz)
        if m < k:
            d2 = torch.cat([d2, d2.new_full((d2.shape[0], k - m), torch.inf)], dim=1)
        if k == 1:
            d, i = torch.min(d2, dim=1, keepdim=True)  # first minimum
        else:
            d_sorted, i = torch.sort(d2, dim=1, stable=True)
            d, i = d_sorted[:, :k], i[:, :k]
        ds.append(d)
        ids.append(torch.where(i < m, i, 0).to(torch.int32))
    if not ds:
        return (query_xyz.new_empty((0, k)),
                torch.empty((0, k), dtype=torch.int32, device=query_xyz.device))
    return torch.cat(ds), torch.cat(ids)


@dataclass
class KdTree:
    """Searcher over a cloud's rows (API parity with the reference KdTree).

    The rows are taken as fixed once the tree is built: what the card's
    searches derive from the target alone (K9's centre, the sorted rows
    and boxes that K12, K3, K4, K1 and K6 walk, the live rows packed first
    for K9 and K10) is computed at the first search that needs it and kept,
    so that the covariance stage and every align against the cloud share
    one sort. The searched rows are the first ``num_points`` live ones
    (``live_rows``: w > 0.5), wherever they stand, as the JAX package
    searches every row and its padding rows lose every race; indices are
    rows of ``points``.
    """

    points: torch.Tensor  # [M,4], padded with the sentinel
    num_points: torch.Tensor  # 0-d int32
    _centre: Any = field(default=None, init=False, repr=False, compare=False)
    _pruned: Any = field(default=None, init=False, repr=False, compare=False)
    _packed: Any = field(default=None, init=False, repr=False, compare=False)

    def replace(self, **changes) -> "KdTree":
        return dataclasses.replace(self, **changes)

    @staticmethod
    def build(cloud, num_threads: int = 1, *, device=None) -> "KdTree":
        """From a PointCloud or a raw [N,3]/[N,4] array (placed on
        ``device``, default the card). ``num_threads`` is accepted for API
        parity: there is no tree to build."""
        del num_threads
        if not isinstance(cloud, PointCloud):
            cloud = PointCloud.from_points(cloud, device=device)
        return KdTree(points=cloud.points, num_points=cloud.num_points)

    def _queries(self, query_xyz):
        q = torch.as_tensor(query_xyz, dtype=self.points.dtype,
                            device=self.points.device)
        single = q.ndim == 1
        return (q[None, :] if single else q), single

    def _on_card(self) -> bool:
        return self.points.device.type == "cuda" and self.points.dtype == torch.float32

    def centre(self) -> torch.Tensor:
        """[3] mean of the finite target rows, on which K9 centres both
        clouds; computed once."""
        if self._centre is None:
            from small_gicp_tpu_torch.ops.knn_cuda import target_centre

            self._centre = target_centre(self.points)
        return self._centre

    def pruned_target(self):
        """The cloud Morton-sorted and boxed for the pruned searches and box
        walks (``knn_cuda.knn_pruned(..., target=...)``, ``knn_moments(...,
        target=...)``, ``gicp_prepare(..., target=...)``); computed once."""
        if self._pruned is None:
            from small_gicp_tpu_torch.ops.morton_boxes import pruned_prepare_target

            self._pruned = pruned_prepare_target(self.points, self.num_points)
        return self._pruned

    def packed(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(rows [M,4] with the live rows first in row order, their count
        0-d int32, order [M] int32: packed position → row), the row set K9
        and K10 scan and the map through which they write their rows;
        computed once. A front-packed cloud packs to itself."""
        if self._packed is None:
            live = live_rows(self.points, self.num_points)
            order = torch.argsort((~live).to(torch.uint8), stable=True)
            self._packed = (self.points[order], live.sum().to(torch.int32),
                            order.to(torch.int32))
        return self._packed

    def knn_search(self, query_xyz, k: int, block: int = QUERY_BLOCK,
                   method: str = "exact", window_cell: float = 1.0):
        """[Q,3] (or one [3]) → (sq_dists [Q,k], idx [Q,k] int32), ascending.

        ``method``: "exact", or "window", the approximate Morton-banded
        search (``knn_window.knn_windowed_query``, cell ``window_cell``;
        ≥ 97 % set recall at the defaults on LiDAR-like clouds, missed slots
        d² = inf) over the tree's live rows packed first. ``block`` tunes the
        query tiling of the torch brute force only; the kernel path ignores
        it.
        """
        q, single = self._queries(query_xyz)
        if method == "window":
            from small_gicp_tpu_torch.ops.knn_window import knn_windowed_query

            rows, num, order = self.packed()
            d, i = knn_windowed_query(rows, num, q[:, :3], k, cell=window_cell)
            i = order[i.long()]
            return (d[0], i[0]) if single else (d, i)
        if method != "exact":
            raise ValueError(f"unknown method {method!r}; have 'exact', 'window'")
        if self._on_card() and 1 < k <= 64:
            from small_gicp_tpu_torch.ops.knn_cuda import knn

            rows, num, order = self.packed()
            d, i = knn(rows, num, q[:, :3], k, rowmap=order)
        else:
            d, i = brute_force_knn(self.points[:, :3], q[:, :3], k, block)
        return (d[0], i[0]) if single else (d, i)

    def nearest_neighbor_search(self, query_xyz, block: int = QUERY_BLOCK):
        """k = 1: [Q,3] (or one [3]) → (sq_dists [Q], idx [Q] int32). On the
        card the distance is the one kernel K9 computes, of coordinates
        centred on the target's mean."""
        q, single = self._queries(query_xyz)
        if self._on_card():
            from small_gicp_tpu_torch.ops.knn_cuda import nearest_neighbor

            rows, num, order = self.packed()
            d, i = nearest_neighbor(rows, num, q[:, :3], centre=self.centre(),
                                    rowmap=order)
        else:
            d, i = brute_force_knn(self.points[:, :3], q[:, :3], 1, block)
            d, i = d[:, 0], i[:, 0]
        return (d[0], i[0]) if single else (d, i)

    # Names of the reference Python bindings.
    def batch_knn_search(self, query_xyz, k: int, num_threads: int = 1):
        del num_threads
        return self.knn_search(query_xyz, k)

    def batch_nearest_neighbor_search(self, query_xyz, num_threads: int = 1):
        del num_threads
        return self.nearest_neighbor_search(query_xyz)


def knn_search(target: PointCloud, query_xyz, k: int):
    """One-shot kNN against a cloud."""
    return KdTree.build(target).knn_search(query_xyz, k)


def nearest_neighbor_search(target: PointCloud, query_xyz):
    return KdTree.build(target).nearest_neighbor_search(query_xyz)


def brute_force_knn_numpy(target_xyz, query_xyz, k: int):
    """Host-side oracle of the tests: (d² [Q,k], indices [Q,k]) by brute
    force in numpy (the reference checks its trees the same way,
    src/test/kdtree_test.cpp:167)."""
    d2 = (np.sum(query_xyz**2, axis=1, keepdims=True)
          - 2.0 * query_xyz @ target_xyz.T
          + np.sum(target_xyz**2, axis=1)[None, :])
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d2, idx, axis=1), idx
