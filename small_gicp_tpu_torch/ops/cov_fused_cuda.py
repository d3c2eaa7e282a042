"""Exact self-kNN covariance moments: kernel K3 and its plain version.

Counterpart of ``small_gicp_tpu/ops/cov_fused_pallas.py``
(``knn_moments_pallas``). ``knn_moments_rows`` returns one row per point,

  [Σd 3 | Σddᵀ upper 6 (xx xy xz yy yz zz) | count | d_k | 0 ×5]

with d = p − q over the k nearest valid rows p of the query q (self
included), count the neighbours with d² < 1e16 and d_k the kth d². Rows
at or beyond ``num_points`` are zero. Ties keep the lower row index, so
the kernel and the plain version choose the same neighbours.

On a CUDA tensor the wrapper launches the CUDA kernel
(``csrc/cov_fused.cu``); on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from small_gicp_tpu_torch import _build
from small_gicp_tpu_torch.ops.knn import QUERY_BLOCK

_BIG = 3.0e38
_VALID_SQ = 1e16
MAX_K = 64


def knn_moments_rows_plain(points: torch.Tensor, num_points: torch.Tensor,
                           k: int) -> torch.Tensor:
    """Plain PyTorch version of K3: [N,4] points → [N,16] moment rows."""
    n = points.shape[0]
    dev, dt = points.device, points.dtype
    xyz = points[:, :3]
    cols = torch.arange(n, device=dev)
    out = torch.zeros((n, 16), dtype=dt, device=dev)
    for s in range(0, n, QUERY_BLOCK):
        q = xyz[s:s + QUERY_BLOCK]
        dx = xyz[None, :, 0] - q[:, None, 0]  # p − q, [B, N]
        dy = xyz[None, :, 1] - q[:, None, 1]
        dz = xyz[None, :, 2] - q[:, None, 2]
        d2 = dx * dx + dy * dy + dz * dz
        d2 = torch.where(cols[None, :] < num_points, d2, _BIG)
        if n < k:
            d2 = torch.cat([d2, d2.new_full((d2.shape[0], k - n), _BIG)], dim=1)
        d_sorted, idx = torch.sort(d2, dim=1, stable=True)
        d_k, idx = d_sorted[:, :k], torch.clamp(idx[:, :k], max=n - 1)
        gx, gy, gz = (torch.gather(a, 1, idx) for a in (dx, dy, dz))
        v = d_k < _VALID_SQ
        vx, vy, vz = (torch.where(v, g, 0.0) for g in (gx, gy, gz))
        rows = torch.stack(
            [vx.sum(1), vy.sum(1), vz.sum(1),
             (vx * gx).sum(1), (vx * gy).sum(1), (vx * gz).sum(1),
             (vy * gy).sum(1), (vy * gz).sum(1), (vz * gz).sum(1),
             v.sum(1).to(dt), d_k[:, k - 1]],
            dim=1,
        )
        live = (s + torch.arange(rows.shape[0], device=dev)) < num_points
        out[s:s + QUERY_BLOCK, :11] = torch.where(live[:, None], rows, 0.0)
    return out


def _knn_moments_rows_cuda(points: torch.Tensor, num_points: torch.Tensor,
                           k: int) -> torch.Tensor:
    _build.require(points, "points", torch.float32, (None, 4))
    _build.require(num_points, "num_points", torch.int32, ())
    n = points.shape[0]
    out = torch.empty((n, 16), dtype=torch.float32, device=points.device)
    if n == 0:
        return out
    lib = _build.library("cov_fused")
    with torch.cuda.device(points.device):
        rc = lib.sgt_knn_moments(
            points.data_ptr(), num_points.data_ptr(), n, k, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "knn_moments")
    knn_moments_rows.launches += 1
    return out


def knn_moments_rows(points: torch.Tensor, num_points: torch.Tensor,
                     k: int) -> torch.Tensor:
    """[N,4] padded cloud → [N,16] moment rows (kernel on CUDA, plain on CPU)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_moments supports 1 <= k <= {MAX_K}, got {k}")
    if points.device.type == "cpu":
        return knn_moments_rows_plain(points, num_points, k)
    return _knn_moments_rows_cuda(points, num_points, k)


knn_moments_rows.launches = 0


def knn_moments(points: torch.Tensor, num_points: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(m1 [N,3] = Σd, m2 [N,3,3] = Σddᵀ, counts [N]) in original row order."""
    rows = knn_moments_rows(points, num_points, k)
    m1 = rows[:, 0:3]
    m2 = rows[:, [3, 4, 5, 4, 6, 7, 5, 7, 8]].reshape(-1, 3, 3)
    return m1, m2, rows[:, 9]
