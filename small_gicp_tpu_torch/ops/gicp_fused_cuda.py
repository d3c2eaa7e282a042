"""Fused correspondence search + linearize (K1) and LM trial errors (K2).

Counterpart of ``small_gicp_tpu/ops/gicp_fused_pallas.py``:

  * ``gicp_prepare`` builds the per-align tables once;
  * ``gicp_linearize_tables`` → (H [6,6], b [6], inliers, corr [N,16]):
    exact 1-NN of T·p over the valid target rows (ties to the lower
    index), the factor's weight W, the rejector mask d² ≤ max_d2, the
    optional Huber/Cauchy weight and the sums of J_iᵀW_iJ_i, J_iᵀW_ir_i,
    e_i and the inlier count. corr rows are [μ 3 | W 9 | mask | d² | 0 0]
    in original source order;
  * ``gicp_error_multi`` → [K1] float64: Σ ½ rᵀWr·mask at each of up to
    100 poses over frozen corr rows, re-weighted by w(√e) at each pose.

Per-point terms are float32 on the card; sums across blocks are float64
and are handed on un-truncated. On a CUDA tensor the wrappers launch the
kernels of ``csrc/gicp_fused.cu``; on a CPU tensor they run the plain
versions below, which repeat the kernels' arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from small_gicp_tpu_torch import _build
from small_gicp_tpu_torch.ops.eigh3 import inv3x3
from small_gicp_tpu_torch.ops.knn import QUERY_BLOCK, sq_dists

_BIG = 3.0e38
FACTORS = ("gicp", "plane_icp", "icp")
ROBUST_KERNELS = ("huber", "cauchy")
MAX_POSES = 100


@dataclass
class GicpTables:
    """Per-align kernel tables (built once by ``gicp_prepare``).

    ttab [M,16]: x y z 0 | payload 9 (C_t row-major, or the target normal
    in 0-2, or zeros) | 0 0 0.  qtab [N,16]: x y z 0 | C_s 9 | 0 0 0.
    """

    ttab: torch.Tensor
    tnum: torch.Tensor  # 0-d int32, valid target rows
    qtab: torch.Tensor
    qnum: torch.Tensor  # 0-d int32, valid source rows
    factor: str


def gicp_prepare(target_points: torch.Tensor, target_num: torch.Tensor,
                 source_points: torch.Tensor, source_num: torch.Tensor,
                 factor: str = "gicp", target_covs: Optional[torch.Tensor] = None,
                 source_covs: Optional[torch.Tensor] = None,
                 target_normals: Optional[torch.Tensor] = None) -> GicpTables:
    """Build the tables of one registration (no sort: the search is brute
    force, so the clouds keep their row order)."""
    if factor not in FACTORS:
        raise ValueError(f"unknown fused factor {factor!r}")
    m, n = target_points.shape[0], source_points.shape[0]
    dt = source_points.dtype
    ttab = target_points.new_zeros((m, 16), dtype=dt)
    ttab[:, 0:3] = target_points[:, :3]
    if factor == "gicp":
        if target_covs is None or source_covs is None:
            raise ValueError("GICP requires source and target covariances")
        ttab[:, 4:13] = target_covs.reshape(m, 9)
    elif factor == "plane_icp":
        if target_normals is None:
            raise ValueError("point-to-plane ICP requires target normals")
        ttab[:, 4:7] = target_normals[:, :3]
    qtab = source_points.new_zeros((n, 16))
    qtab[:, 0:3] = source_points[:, :3]
    if factor == "gicp":
        qtab[:, 4:13] = source_covs.reshape(n, 9)
    return GicpTables(ttab=ttab, tnum=target_num.to(torch.int32), qtab=qtab,
                      qnum=source_num.to(torch.int32), factor=factor)


def _pose12(T: torch.Tensor, dtype) -> torch.Tensor:
    """[..., 4, 4] → [..., 12] = R row-major 9 | t 3."""
    return torch.cat([T[..., :3, :3].reshape(T.shape[:-2] + (9,)),
                      T[..., :3, 3]], dim=-1).to(dtype).contiguous()


def _robust_code(robust: Optional[str]) -> int:
    if robust is None:
        return 0
    if robust not in ROBUST_KERNELS:
        raise ValueError(f"unknown robust kernel {robust!r}")
    return 1 + ROBUST_KERNELS.index(robust)


def _robust_w(robust: Optional[str], c: float, e: torch.Tensor) -> torch.Tensor:
    """w(√e) as in the kernels: Huber min(1, c/√e), Cauchy c/(c + e), e ≥ 0."""
    e0 = torch.clamp(e, min=0.0)
    if robust == "huber":
        x = torch.sqrt(e0)
        return torch.where(x < c, torch.ones_like(x), c / torch.clamp(x, min=1e-30))
    return c / (c + e0)


def _finish(sums: torch.Tensor):
    """[44] float64 sums → (H [6,6], b [6], inliers)."""
    return sums[:36].reshape(6, 6), sums[36:42], sums[43]


# ---------------------------------------------------------------- K1 ----

def gicp_linearize_plain(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                         robust: Optional[str] = None, robust_c: float = 1.0):
    """Plain PyTorch version of K1; same outputs as ``gicp_linearize_tables``."""
    _robust_code(robust)
    ttab, qtab = tables.ttab, tables.qtab
    dt, dev = qtab.dtype, qtab.device
    n, m = qtab.shape[0], ttab.shape[0]
    pose = _pose12(T, dt)
    r, t = pose[:9], pose[9:]
    px, py, pz = qtab[:, 0], qtab[:, 1], qtab[:, 2]
    q = torch.stack([r[0] * px + r[1] * py + r[2] * pz + t[0],
                     r[3] * px + r[4] * py + r[5] * pz + t[1],
                     r[6] * px + r[7] * py + r[8] * pz + t[2]], dim=1)

    active = torch.arange(n, device=dev) < tables.qnum
    best_d = torch.full((n,), _BIG, dtype=dt, device=dev)
    best = torch.zeros((n,), dtype=torch.int64, device=dev)
    if m > 0:
        tcol = torch.arange(m, device=dev) < tables.tnum
        for s in range(0, n, QUERY_BLOCK):
            d2 = torch.where(tcol[None, :],
                             sq_dists(q[s:s + QUERY_BLOCK], ttab[:, :3]), _BIG)
            dmin, imin = torch.min(d2, dim=1)  # first minimum on ties
            best_d[s:s + QUERY_BLOCK] = dmin
            best[s:s + QUERY_BLOCK] = imin
    found = active & (best_d < _BIG)
    best_d = torch.where(active, best_d, _BIG)
    rows = torch.where(found[:, None], ttab[best], 0.0)
    mu, pay = rows[:, 0:3], rows[:, 4:13]
    mask = found & (best_d <= max_dist_sq) & (best_d < 0.5 * _BIG)

    R = r.reshape(3, 3)
    if tables.factor == "gicp":
        W = inv3x3(pay.reshape(n, 3, 3) + R @ qtab[:, 4:13].reshape(n, 3, 3) @ R.T)
    elif tables.factor == "plane_icp":
        W = torch.diag_embed(pay[:, 0:3] ** 2)
    else:
        W = torch.eye(3, dtype=dt, device=dev).expand(n, 3, 3)

    res = mu - q
    Wr = (W @ res[..., None])[..., 0]
    e_i = 0.5 * torch.sum(res * Wr, dim=-1)
    wm = torch.ones_like(e_i) if robust is None else _robust_w(robust, robust_c, e_i)
    Jr = torch.stack([
        torch.stack([R[k, 1] * pz - R[k, 2] * py,
                     R[k, 2] * px - R[k, 0] * pz,
                     R[k, 0] * py - R[k, 1] * px], dim=-1)
        for k in range(3)
    ], dim=1)  # R·skew(p), [N,3,3]
    J = torch.cat([Jr, (-R).expand(n, 3, 3)], dim=-1)  # [N,3,6]
    Jt = J.transpose(1, 2)
    H_i = (Jt @ (W @ J)) * wm[:, None, None]
    b_i = (Jt @ Wr[..., None])[..., 0] * wm[:, None]
    per_point = torch.cat([H_i.reshape(n, 36), b_i, (e_i * wm)[:, None],
                           torch.ones_like(e_i)[:, None]], dim=1)
    per_point = torch.where(mask[:, None], per_point, 0.0)
    sums = per_point.to(torch.float64).sum(0)

    corr = torch.cat([mu, W.reshape(n, 9), mask.to(dt)[:, None], best_d[:, None],
                      torch.zeros((n, 2), dtype=dt, device=dev)], dim=1)
    return (*_finish(sums), corr)


def _gicp_linearize_cuda(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                         robust: Optional[str], robust_c: float):
    f32 = torch.float32
    _build.require(tables.ttab, "ttab", f32, (None, 16))
    _build.require(tables.qtab, "qtab", f32, (None, 16))
    _build.require(tables.tnum, "tnum", torch.int32, ())
    _build.require(tables.qnum, "qnum", torch.int32, ())
    n = tables.qtab.shape[0]
    dev = tables.qtab.device
    pose = _pose12(T.to(dev), f32)
    corr = torch.empty((n, 16), dtype=f32, device=dev)
    if n == 0:
        return (*_finish(torch.zeros(44, dtype=torch.float64, device=dev)), corr)
    lib = _build.library("gicp_fused")
    rows = lib.sgt_linearize_block_rows()
    partials = torch.empty(((n + rows - 1) // rows, 44), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sgt_gicp_linearize(
            tables.ttab.data_ptr(), tables.tnum.data_ptr(), tables.qtab.data_ptr(),
            tables.qnum.data_ptr(), n, pose.data_ptr(), float(max_dist_sq),
            float(robust_c), FACTORS.index(tables.factor), _robust_code(robust),
            corr.data_ptr(), partials.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "gicp_linearize")
    gicp_linearize_tables.launches += 1
    return (*_finish(partials.to(torch.float64).sum(0)), corr)


def gicp_linearize_tables(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                          robust: Optional[str] = None, robust_c: float = 1.0
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One linearization at T: (H [6,6] f64, b [6] f64, inliers f64, corr [N,16])."""
    if tables.qtab.device.type == "cpu":
        return gicp_linearize_plain(tables, T, max_dist_sq, robust, robust_c)
    return _gicp_linearize_cuda(tables, T, max_dist_sq, robust, robust_c)


gicp_linearize_tables.launches = 0


# ---------------------------------------------------------------- K2 ----

def gicp_error_multi_plain(corr: torch.Tensor, src: torch.Tensor, Ts: torch.Tensor,
                           num_points: torch.Tensor, robust: Optional[str] = None,
                           robust_c: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K2; same output as ``gicp_error_multi``."""
    _robust_code(robust)
    n = corr.shape[0]
    P = _pose12(Ts, corr.dtype)  # [K1,12]
    px, py, pz = src[None, :, 0], src[None, :, 1], src[None, :, 2]
    col = lambda j: P[:, j, None]  # noqa: E731
    rx = corr[None, :, 0] - (col(0) * px + col(1) * py + col(2) * pz + col(9))
    ry = corr[None, :, 1] - (col(3) * px + col(4) * py + col(5) * pz + col(10))
    rz = corr[None, :, 2] - (col(6) * px + col(7) * py + col(8) * pz + col(11))
    w = [corr[None, :, 3 + j] for j in range(9)]
    wr0 = w[0] * rx + w[1] * ry + w[2] * rz
    wr1 = w[3] * rx + w[4] * ry + w[5] * rz
    wr2 = w[6] * rx + w[7] * ry + w[8] * rz
    e = 0.5 * (rx * wr0 + ry * wr1 + rz * wr2)  # [K1,N]
    if robust is not None:
        e = _robust_w(robust, robust_c, e) * e
    live = (torch.arange(n, device=corr.device) < num_points) & (corr[:, 12] > 0.5)
    return torch.where(live[None, :], e, 0.0).to(torch.float64).sum(1)


def _gicp_error_multi_cuda(corr, src, Ts, num_points, robust, robust_c):
    f32 = torch.float32
    _build.require(corr, "corr", f32, (None, 16))
    n = corr.shape[0]
    _build.require(src, "src", f32, (n, 4))
    _build.require(num_points, "num_points", torch.int32, ())
    dev = corr.device
    k1 = Ts.shape[0]
    poses = _pose12(Ts.to(dev), f32)
    if n == 0:
        return torch.zeros(k1, dtype=torch.float64, device=dev)
    lib = _build.library("gicp_fused")
    rows = lib.sgt_trials_block_rows()
    partials = torch.empty(((n + rows - 1) // rows, k1), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sgt_gicp_error_multi(
            corr.data_ptr(), src.data_ptr(), num_points.data_ptr(), n,
            poses.data_ptr(), k1, float(robust_c), _robust_code(robust),
            partials.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "gicp_error_multi")
    gicp_error_multi.launches += 1
    return partials.to(torch.float64).sum(0)


def gicp_error_multi(corr: torch.Tensor, src: torch.Tensor, Ts: torch.Tensor,
                     num_points: torch.Tensor, robust: Optional[str] = None,
                     robust_c: float = 1.0) -> torch.Tensor:
    """[K1] float64 total errors at the poses Ts [K1,4,4] (K1 ≤ 100)."""
    if not 1 <= Ts.shape[0] <= MAX_POSES:
        raise ValueError(f"1 to {MAX_POSES} poses per call, got {Ts.shape[0]}")
    if corr.device.type == "cpu":
        return gicp_error_multi_plain(corr, src, Ts, num_points, robust, robust_c)
    return _gicp_error_multi_cuda(corr, src, Ts, num_points, robust, robust_c)


gicp_error_multi.launches = 0
