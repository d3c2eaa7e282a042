"""Per-point error factors (ICP / point-to-plane / GICP), batched, in torch.

Counterpart of ``small_gicp_tpu/models/factors.py``. Every factor is

    r_i = μ_i − T·p_i,   e_i = ½ r_iᵀ W_i r_i,   J_i = [R·skew(p_i) | −R]
    H = Σ J_iᵀ W_i J_i,  b = Σ J_iᵀ W_i r_i

with W = I (ICP), diag(n∘n) (point-to-plane) or (C_t + R C_s Rᵀ)⁻¹ (GICP).
Robust kernels scale (H_i, b_i, e_i) by w(√e_i). Error totals are summed
in float64, as the reference's double accumulators do.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from small_gicp_tpu_torch.ops.eigh3 import inv3x3
from small_gicp_tpu_torch.utils.lie import skew

ICP = "icp"
PLANE_ICP = "plane_icp"
GICP = "gicp"


@dataclass
class Correspondences:
    """Frozen per-source-point correspondence state."""

    target_mu: torch.Tensor  # [N,3]
    W: torch.Tensor  # [N,3,3]
    mask: torch.Tensor  # [N] bool
    target_idx: torch.Tensor  # [N] int64

    def replace(self, **changes) -> "Correspondences":
        return dataclasses.replace(self, **changes)


def _error_accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Error totals are summed in float64 whatever the cloud dtype: the LM
    accept test new_e ≤ e compares two sums whose float32 rounding noise
    would swamp the real change near convergence."""
    return torch.float64


def make_weights(factor_type: str, T: torch.Tensor, num_points: int,
                 source_covs: Optional[torch.Tensor],
                 target_normals: Optional[torch.Tensor],
                 target_covs: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-point [N,3,3] weight matrices for a factor type."""
    if factor_type == ICP:
        return torch.eye(3, dtype=T.dtype, device=T.device).expand(num_points, 3, 3)
    if factor_type == PLANE_ICP:
        if target_normals is None:
            raise ValueError("point-to-plane ICP requires target normals")
        return torch.diag_embed(target_normals[:, :3] ** 2)
    if factor_type == GICP:
        if source_covs is None or target_covs is None:
            raise ValueError("GICP requires source and target covariances")
        R = T[:3, :3]
        return inv3x3(target_covs + R @ source_covs @ R.T)
    raise ValueError(f"unknown factor type {factor_type!r}")


def robust_weight(kernel: Optional[str], c, e: torch.Tensor) -> torch.Tensor:
    """w(√e): Huber min(1, c/|x|), Cauchy c/(c + x²), with x = √max(e, 0)."""
    if kernel is None:
        return torch.ones_like(e)
    x = torch.sqrt(torch.clamp(e, min=0.0))
    if kernel == "huber":
        return torch.where(x < c, torch.ones_like(x), c / torch.clamp(x, min=1e-30))
    if kernel == "cauchy":
        return c / (c + x * x)
    raise ValueError(f"unknown robust kernel {kernel!r}")


def geometric_jacobian(T: torch.Tensor, source_xyz: torch.Tensor) -> torch.Tensor:
    """[N,3,6] J = [R·skew(p) | −R], d(residual)/d(twist) at T."""
    R = T[:3, :3]
    Jr = R @ skew(source_xyz)
    Jt = (-R).expand(source_xyz.shape[0], 3, 3)
    return torch.cat([Jr, Jt], dim=-1)


def linearize(corr: Correspondences, T: torch.Tensor, source_points: torch.Tensor,
              robust_kernel: Optional[str] = None, robust_c: float = 1.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked (H [6,6], b [6], e float64) over all factors."""
    transed = source_points @ T.T
    r = corr.target_mu - transed[:, :3]
    J = geometric_jacobian(T, source_points[:, :3])
    Wr = (corr.W @ r[..., None])[..., 0]
    e_i = 0.5 * torch.sum(r * Wr, dim=-1)
    w = robust_weight(robust_kernel, robust_c, e_i) * corr.mask.to(r.dtype)
    WJw = (corr.W @ J) * w[:, None, None]
    H = torch.einsum("nij,nik->jk", J, WJw)
    b = torch.einsum("nij,ni->j", J, Wr * w[:, None])
    e = torch.sum((e_i * w).to(_error_accum_dtype(r.dtype)))
    return H, b, e


def error(corr: Correspondences, T: torch.Tensor, source_points: torch.Tensor,
          robust_kernel: Optional[str] = None, robust_c: float = 1.0) -> torch.Tensor:
    """Total error at T with frozen correspondences (float64; reduction.hpp:
    44-62, the per-factor error gicp_factor.hpp:81-89)."""
    r = corr.target_mu - (source_points @ T.T)[:, :3]
    Wr = (corr.W @ r[..., None])[..., 0]
    e_i = 0.5 * torch.sum(r * Wr, dim=-1)
    w = robust_weight(robust_kernel, robust_c, e_i) * corr.mask.to(r.dtype)
    return torch.sum((e_i * w).to(_error_accum_dtype(r.dtype)))


def linearize_per_point(corr: Correspondences, T: torch.Tensor,
                        source_points: torch.Tensor, robust_kernel: Optional[str] = None,
                        robust_c: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point (H_i [N,6,6], b_i [N,6], e_i [N]); masked rows are zero. The
    per-factor view of the reference's bindings (src/python/factors.cpp:
    44-224); summed over i it gives ``linearize``."""
    r = corr.target_mu - (source_points @ T.T)[:, :3]
    J = geometric_jacobian(T, source_points[:, :3])
    Wr = (corr.W @ r[..., None])[..., 0]
    e_i = 0.5 * torch.sum(r * Wr, dim=-1)
    w = robust_weight(robust_kernel, robust_c, e_i) * corr.mask.to(r.dtype)
    H_i = torch.einsum("nij,nik->njk", J, corr.W @ J) * w[:, None, None]
    b_i = torch.einsum("nij,ni->nj", J, Wr) * w[:, None]
    return H_i, b_i, e_i * w


class _FactorBase:
    """Per-point factor objects, the reference's Python factor classes
    (src/python/factors.cpp). ``linearize`` searches every source point's
    correspondence at pose T and returns the per-point linearized system
    and the inlier mask."""

    factor_type: str = ICP
    robust_kernel: Optional[str] = None
    robust_c: float = 1.0

    def __init__(self, robust_kernel: Optional[str] = None, robust_c: float = 1.0):
        self.robust_kernel = robust_kernel
        self.robust_c = robust_c

    def linearize(self, target, source, target_tree, T, source_index=None,
                  rejector=None, max_dist_sq=1.0):
        """Linearize the factor(s) at pose T.

        Batched by default: (H [N,6,6], b [N,6], e [N], mask [N]) for every
        source row. With ``source_index`` the reference binding's form
        (factors.cpp:53-103): (success, H 6x6, b 6, e) of that one point,
        which alone is searched. ``rejector`` (``DistanceRejector``)
        overrides ``max_dist_sq``. On a PointCloud target the search is
        ``target_tree``'s (a ``KdTree`` built here when None): K9 on the card.
        """
        # The registration layer sits above this one: imported where used.
        from small_gicp_tpu_torch.models.registration import search_correspondences

        if source_index is not None and not isinstance(source_index, (int, np.integer)):
            # This slot was once max_dist_sq: a float here must fail loudly.
            raise TypeError(
                f"source_index must be an int, got {type(source_index).__name__}")
        if rejector is not None:
            max_dist_sq = rejector.max_dist_sq
        T = torch.as_tensor(T, dtype=source.points.dtype, device=source.points.device)
        src_points = source.points
        src_covs = source.covs if self.factor_type == GICP else None
        src_n = source.num_points
        if source_index is not None:
            i, n = int(source_index), int(source.num_points)
            if not 0 <= i < n:
                raise IndexError(f"source_index {i} out of range [0, {n})")
            src_points = src_points[i:i + 1]
            src_covs = None if src_covs is None else src_covs[i:i + 1]
            src_n = torch.ones((), dtype=torch.int32, device=src_points.device)
        corr, _ = search_correspondences(self.factor_type, target, target_tree,
                                         src_points, src_n, src_covs, T,
                                         float(max_dist_sq))
        H_i, b_i, e_i = linearize_per_point(corr, T, src_points, self.robust_kernel,
                                            self.robust_c)
        if source_index is not None:
            return bool(corr.mask[0]), H_i[0], b_i[0], float(e_i[0])
        return H_i, b_i, e_i, corr.mask


class DistanceRejector:
    """Correspondence rejector (registration/rejector.hpp:19-28): pairs with
    squared distance above ``max_dist_sq`` are masked out."""

    def __init__(self, max_dist: float = 1.0):
        self.max_dist_sq = max_dist * max_dist

    def set_max_distance(self, dist: float) -> None:
        """The bindings' setter (factors.cpp:29-41)."""
        self.max_dist_sq = dist * dist

    def __call__(self, sq_dists: torch.Tensor) -> torch.Tensor:
        return sq_dists <= self.max_dist_sq


class ICPFactor(_FactorBase):
    """Point-to-point (factors/icp_factor.hpp:14-70)."""

    factor_type = ICP


class PointToPlaneICPFactor(_FactorBase):
    """Point-to-plane (factors/plane_icp_factor.hpp:14-75)."""

    factor_type = PLANE_ICP


class GICPFactor(_FactorBase):
    """Distribution-to-distribution (factors/gicp_factor.hpp:14-97)."""

    factor_type = GICP


def error_multi(corr: Correspondences, Ts: torch.Tensor, source_points: torch.Tensor,
                robust_kernel: Optional[str] = None, robust_c: float = 1.0
                ) -> torch.Tensor:
    """Total error at K poses at once with frozen correspondences: [K,4,4] → [K]."""
    transed = torch.einsum("kab,nb->kna", Ts, source_points)
    r = corr.target_mu[None] - transed[..., :3]
    Wr = torch.einsum("nij,knj->kni", corr.W, r)
    e_i = 0.5 * torch.sum(r * Wr, dim=-1)
    w = robust_weight(robust_kernel, robust_c, e_i) * corr.mask.to(r.dtype)
    return torch.sum((e_i * w).to(_error_accum_dtype(r.dtype)), dim=-1)
