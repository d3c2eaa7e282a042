"""Normal and covariance estimation from k nearest neighbours, in torch.

Counterpart of ``small_gicp_tpu/ops/normals.py``. The neighbour moments
come from one of two routes, chosen as the JAX package chooses them:
  * float32 points, k ≤ 64 and at most 1,048,576 rows: ``knn_moments``
    in its own choice of layout — kernel K3 on the card up to 262,144
    rows, which never materialises the neighbours, and above that the
    pruned search K4 with the moments summed over its gathered winners;
  * anything else (float64, k > 64, larger clouds): ``KdTree.knn_search``
    and query-centred moment sums over the gathered neighbours.
``neighbor_mode="fused"`` insists on the first route and raises where it
does not apply; ``neighbor_mode="window"`` takes the neighbour lists of the
approximate Morton-banded self-search (``knn_window.knn_windowed``, cell
``window_cell``) and sums their moments as the second route does. A ``KdTree`` over the cloud's own points hands the kernels
its kept Morton sort and boxes (``KdTree.pruned_target()``), so that
``preprocess_points`` and the align that follows sort each cloud once.
Then:
  * fewer than 5 neighbours → invalid: normal 0, covariance I;
  * cov = E[ddᵀ] − E[d]E[d]ᵀ over the query-centred offsets d (biased);
  * normal = smallest-eigenvalue eigenvector, flipped so normal·p ≤ 0;
  * GICP covariance = I − (1 − 1e-3)·v₀v₀ᵀ (plane regularisation).
"""

from __future__ import annotations

import torch

from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.ops.cov_fused_cuda import MAX_K, MAX_ROWS, knn_moments
from small_gicp_tpu_torch.ops.eigh3 import smallest_eigvec3x3
from small_gicp_tpu_torch.ops.knn import KdTree

# Squared distances above this are hits on padding rows: the neighbour
# does not exist (cloud smaller than k).
_VALID_NEIGHBOR_SQ_DIST = 1e16
_MIN_NEIGHBORS = 5


def _searched_moments(points: torch.Tensor, num_points: torch.Tensor, k: int):
    """(Σd [N,3], Σddᵀ [N,3,3], counts [N]) through ``KdTree.knn_search``."""
    sq_dists, idx = KdTree(points=points, num_points=num_points).knn_search(
        points[:, :3], k)
    return _list_moments(points, sq_dists, idx)


def _list_moments(points: torch.Tensor, sq_dists: torch.Tensor, idx: torch.Tensor):
    """(Σd [N,3], Σddᵀ [N,3,3], counts [N]) over the neighbour lists (d² [N,k],
    idx [N,k]); a slot at d² ≥ 1e16 (or inf) holds no neighbour."""
    xyz = points[:, :3]
    neighbor_valid = sq_dists < _VALID_NEIGHBOR_SQ_DIST  # [N,k]
    counts = neighbor_valid.to(points.dtype).sum(dim=-1)
    # Centred on the query: the covariance is translation-invariant, and
    # float32 would cancel in E[ppᵀ] − μμᵀ.
    neigh = xyz[idx.long()] - xyz[:, None, :]  # [N,k,3]
    neigh = torch.where(neighbor_valid[..., None], neigh, 0.0)
    return neigh.sum(dim=1), torch.einsum("nkd,nke->nde", neigh, neigh), counts


def _kept_sort(points: torch.Tensor, tree):
    """The tree's kept sort and boxes when it was built over ``points``."""
    if isinstance(tree, KdTree) and tree.points is points:
        return tree.pruned_target()
    return None


def _estimate_impl(points: torch.Tensor, num_points: torch.Tensor,
                   num_neighbors: int, need_normals: bool, need_covs: bool,
                   neighbor_mode: str = "exact", window_cell: float = 0.25, tree=None):
    n = points.shape[0]
    dt, dev = points.dtype, points.device
    xyz = points[:, :3]

    fused_ok = dt == torch.float32 and num_neighbors <= MAX_K
    if neighbor_mode == "exact" and fused_ok and n <= MAX_ROWS:
        neighbor_mode = "fused"
    if neighbor_mode == "fused":
        if not fused_ok:
            raise ValueError("neighbor_mode='fused' needs f32 points and k<=64")
        m1, m2, counts = knn_moments(points, num_points, num_neighbors,
                                     target=_kept_sort(points, tree))
    elif neighbor_mode == "window":
        from small_gicp_tpu_torch.ops.knn_window import knn_windowed

        m1, m2, counts = _list_moments(points, *knn_windowed(
            points, num_points, num_neighbors, cell=window_cell))
    elif neighbor_mode == "exact":
        m1, m2, counts = _searched_moments(points, num_points, num_neighbors)
    else:
        raise ValueError(f"unknown neighbor_mode {neighbor_mode!r}; "
                         "have 'exact', 'window', 'fused'")
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


def estimate_normals_covariances(cloud: PointCloud, tree=None, num_neighbors: int = 20,
                                 num_threads: int = 1) -> PointCloud:
    """Normals and plane-regularised covariances. The search is exact over
    the cloud itself; a ``KdTree`` built over this cloud lends it its kept
    Morton sort. ``num_threads`` is parity-only, as in the JAX package."""
    normals, covs = _estimate_impl(cloud.points, cloud.num_points,
                                   num_neighbors, True, True, tree=tree)
    return cloud.replace(normals=normals, covs=covs)


def estimate_normals(cloud: PointCloud, tree=None, num_neighbors: int = 20,
                     num_threads: int = 1) -> PointCloud:
    normals, _ = _estimate_impl(cloud.points, cloud.num_points, num_neighbors,
                                True, False, tree=tree)
    return cloud.replace(normals=normals)


def estimate_covariances(cloud: PointCloud, tree=None, num_neighbors: int = 20,
                         num_threads: int = 1) -> PointCloud:
    _, covs = _estimate_impl(cloud.points, cloud.num_points, num_neighbors,
                             False, True, tree=tree)
    return cloud.replace(covs=covs)
