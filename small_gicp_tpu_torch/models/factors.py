"""Per-point error factors (ICP / point-to-plane / GICP), batched, in torch.

Counterpart of ``small_gicp_tpu/models/factors.py``. Every factor is

    r_i = μ_i − T·p_i,   e_i = ½ r_iᵀ W_i r_i,   J_i = [R·skew(p_i) | −R]
    H = Σ J_iᵀ W_i J_i,  b = Σ J_iᵀ W_i r_i

with W = I (ICP), diag(n∘n) (point-to-plane) or (C_t + R C_s Rᵀ)⁻¹ (GICP).
Robust kernels scale (H_i, b_i, e_i) by w(√e_i). Error totals are summed
in float64, as the reference's double accumulators do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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
