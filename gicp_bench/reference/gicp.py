"""Plain GICP registration with Levenberg-Marquardt.

Semantics (small_gicp's ``GICPFactor`` and ``LevenbergMarquardtOptimizer``,
as the configuration states them):
  * each outer iteration (at most ``max_iterations``) finds every
    transformed source point's nearest target point, and keeps the pairs
    within ``max_dist`` (the inliers);
  * residual r = μ_t − T·p_s, Jacobian J = [R·skew(p_s) | −R], weight
    W = (C_t + R·C_s·Rᵀ)⁻¹ at the linearization pose; H = ΣJᵀWJ,
    b = ΣJᵀWr, e = Σ½·rᵀWr over the inliers;
  * trial j < K solves (H + λ·f^j·I)·δ = −b, T_j = T·exp(δ), and is
    accepted if its error with the correspondences and weights frozen is
    not above e; the first accepted trial sets T and λ ← λ·f^j / f; if none
    is accepted, λ ← λ·f^K and the optimizer stops unconverged;
  * converged when an accepted step has ‖δ_rot‖ ≤ rotation_eps and
    ‖δ_t‖ ≤ translation_eps; ``iterations`` is the index of the last
    iteration run; ``inliers`` the count at the last linearization.

The nearest neighbour is exact: a uniform grid of ``max_dist`` cells, each
query searching the 27 cells around its own, which hold every point within
``max_dist`` of it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from gicp_bench.reference.lie import se3_exp, skew
from gicp_bench.reference.precision import F64, Precision

_OFF = 1 << 20
_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


def _pack(c: torch.Tensor) -> torch.Tensor:
    c = c + _OFF
    return (c[..., 2] << 42) | (c[..., 1] << 21) | c[..., 0]


class Grid:
    """Exact nearest neighbour within ``cell`` of [M,3] points."""

    def __init__(self, points: torch.Tensor, cell: float, prec: Precision = F64):
        self.prec = prec
        self.cell = cell
        self.points = prec.q(points)
        keys = _pack(torch.floor(self.points.double() / cell).to(torch.int64))
        keys_s, self.order = torch.sort(keys, stable=True)
        self.ukeys, counts = torch.unique_consecutive(keys_s, return_counts=True)
        self.starts = torch.cumsum(counts, 0) - counts
        self.counts = counts
        self.maxc = int(counts.max()) if counts.numel() else 0
        self.offsets = torch.tensor(_OFFSETS, dtype=torch.int64, device=points.device)

    def nearest(self, q: torch.Tensor, block: int = 2048):
        """(d² [N], index [N] into the points) of each query's nearest point
        within ``cell``; d² = inf and index 0 where none is."""
        if self.ukeys.numel() == 0:
            return (torch.full((q.shape[0],), math.inf, dtype=torch.float64, device=q.device),
                    torch.zeros(q.shape[0], dtype=torch.int64, device=q.device))
        d2_all, idx_all = [], []
        for s in range(0, q.shape[0], block):
            qb = q[s:s + block]
            base = torch.floor(qb.double() / self.cell).to(torch.int64)
            keys = _pack(base[:, None, :] + self.offsets[None])  # [B,27]
            pos = torch.searchsorted(self.ukeys, keys).clamp(max=self.ukeys.numel() - 1)
            hit = self.ukeys[pos] == keys
            cnt = torch.where(hit, self.counts[pos], 0)
            j = torch.arange(self.maxc, device=q.device)
            slot = self.starts[pos][..., None] + j  # [B,27,C]
            ok = j < cnt[..., None]
            cand = self.order[torch.where(ok, slot, 0)]
            diff = self.prec.q(self.points[cand] - qb[:, None, None, :])
            d2 = self.prec.q((diff * diff).sum(-1))
            d2 = torch.where(ok, d2, math.inf).reshape(qb.shape[0], -1)
            best, arg = d2.min(1)
            best = torch.where(best <= self.cell * self.cell, best, math.inf)
            d2_all.append(best)
            idx_all.append(torch.where(torch.isfinite(best),
                                       cand.reshape(qb.shape[0], -1).gather(
                                           1, arg[:, None])[:, 0], 0))
        return torch.cat(d2_all), torch.cat(idx_all)


@dataclass
class Result:
    T: torch.Tensor  # [4,4] float64
    iterations: int
    inliers: int
    converged: bool
    H: torch.Tensor = None  # [6,6] of the last linearization
    b: torch.Tensor = None  # [6]
    error: float = 0.0  # at T, over the last linearization's correspondences


def _transform(T, p, prec):
    return prec.q(p @ T[:3, :3].T + T[:3, 3])


def _linearize(T, grid, tgt_covs, src, src_covs, max_dist, prec):
    """(H, b, e, frozen correspondences) at T."""
    q = prec.q
    R = T[:3, :3]
    tp = _transform(T, src, prec)
    d2, idx = grid.nearest(tp)
    m = d2 <= max_dist * max_dist
    mu = grid.points[idx[m]]
    p = src[m]
    RCR = q(tgt_covs[idx[m]] + q(R @ src_covs[m] @ R.T))
    W = q(torch.linalg.inv(RCR.double()).to(prec.dtype))
    r = q(mu - tp[m])
    J = q(torch.cat([q(R @ skew(p)), (-R).expand(p.shape[0], 3, 3)], -1))  # [n,3,6]
    WJ = q(W @ J)
    H = q((J.transpose(1, 2) @ WJ).sum(0))
    b = q((WJ.transpose(1, 2) @ r[:, :, None])[:, :, 0].sum(0))
    e = q(0.5 * (r[:, None, :] @ W @ r[:, :, None]).sum())
    return H, b, e, (mu, W, p), int(m.sum())


def _frozen_error(T, frozen, prec):
    mu, W, p = frozen
    r = prec.q(mu - _transform(T, p, prec))
    return prec.q(0.5 * (r[:, None, :] @ W @ r[:, :, None]).sum())


def gicp_lm(target: torch.Tensor, target_covs: torch.Tensor, source: torch.Tensor,
            source_covs: torch.Tensor, T0, prec: Precision = F64, *,
            max_dist: float = 1.0, max_iterations: int = 20,
            max_inner_iterations: int = 10, init_lambda: float = 1e-3,
            lambda_factor: float = 10.0, rotation_eps: float = 0.1 * math.pi / 180.0,
            translation_eps: float = 1e-3, grid: Grid = None) -> Result:
    """Register ``source`` [N,3] (covariances [N,3,3]) to ``target`` [M,3]
    from ``T0`` [4,4]; see the module's note."""
    q = prec.q
    dev = target.device
    grid = grid if grid is not None else Grid(target, max_dist, prec)
    tc, src, sc = q(target_covs), q(source), q(source_covs)
    T = q(torch.as_tensor(T0, device=dev))
    lam = init_lambda
    eye = torch.eye(6, dtype=prec.dtype, device=dev)
    it, inliers, converged = 0, 0, False
    for it in range(max_iterations):
        H, b, e, frozen, inliers = _linearize(T, grid, tc, src, sc, max_dist, prec)
        err = float(e)
        accepted = None
        for j in range(max_inner_iterations):
            lam_j = lam * lambda_factor ** j
            delta = q(torch.linalg.solve((H + lam_j * eye).double(),
                                         -b.double()).to(prec.dtype))
            T_j = q(T @ q(se3_exp(delta)))
            e_j = float(_frozen_error(T_j, frozen, prec))
            if e_j <= float(e):
                accepted = (T_j, delta, lam_j)
                err = e_j
                break
        if accepted is None:
            lam = lam * lambda_factor ** max_inner_iterations
            break
        T, delta, lam_j = accepted
        lam = lam_j / lambda_factor
        if (float(torch.linalg.vector_norm(delta[:3])) <= rotation_eps
                and float(torch.linalg.vector_norm(delta[3:])) <= translation_eps):
            converged = True
            break
    return Result(T=T.to(torch.float64), iterations=it, inliers=inliers,
                  converged=converged, H=H.double(), b=b.double(), error=err)


def linearization(target: torch.Tensor, target_covs: torch.Tensor, source: torch.Tensor,
                  source_covs: torch.Tensor, T_lin, T_err, prec: Precision = F64, *,
                  max_dist: float = 1.0, grid: Grid = None):
    """(H [6,6], inliers, error) of the linearization at ``T_lin``, the
    error taken at ``T_err`` over its correspondences: what a registration
    reports of its last iteration."""
    q = prec.q
    dev = target.device
    grid = grid if grid is not None else Grid(target, max_dist, prec)
    T_lin = q(torch.as_tensor(T_lin, device=dev))
    H, _, _, frozen, inliers = _linearize(T_lin, grid, q(target_covs), q(source),
                                          q(source_covs), max_dist, prec)
    e = _frozen_error(q(torch.as_tensor(T_err, device=dev)), frozen, prec)
    return H.double(), inliers, float(e)
