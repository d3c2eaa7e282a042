"""Plain voxelgrid downsampling and brute-force kNN covariances.

Semantics (small_gicp's ``voxelgrid_sampling`` and
``estimate_covariances``, as the configuration states them):
  * a point's voxel is floor(p · (1/leaf)) with p and 1/leaf in float32,
    the clouds' type; a voxel's point is the mean of its points, and the
    voxels come out in (z, y, x) key order;
  * a point's covariance is that of its k nearest points (itself included):
    E[ddᵀ] − E[d]E[d]ᵀ over the offsets d from the point, regularised to
    I − (1 − 1e-3)·v₀v₀ᵀ with v₀ its smallest eigenvector; fewer than 5
    neighbours give I.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gicp_bench.reference.precision import F64, Precision

_OFF = 1 << 20
_BITS = 21


def voxel_coords(points: torch.Tensor, leaf: float) -> torch.Tensor:
    """[N,3] int64 voxel coordinates floor(p · (1/leaf)), the product taken
    in float32."""
    inv = torch.ones((), dtype=torch.float32) / torch.tensor(leaf, dtype=torch.float32)
    return torch.floor(points.to(torch.float32) * inv.to(points.device)).to(torch.int64)


def pack(coords: torch.Tensor) -> torch.Tensor:
    """[N,3] voxel coordinates → [N] int64 keys ordered by (z, y, x)."""
    c = coords + _OFF
    return (c[:, 2] << (2 * _BITS)) | (c[:, 1] << _BITS) | c[:, 0]


def voxelgrid(points: torch.Tensor, leaf: float, prec: Precision = F64,
              max_points: int = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel means of ``points`` [N,3] (float32 scan returns): (keys [V]
    int64 ascending, means [V,3] in ``prec``); a cloud of ``max_points``
    rows keeps the lowest keys."""
    p = prec.q(points)
    keys = pack(voxel_coords(p, leaf))
    keys_s, order = torch.sort(keys, stable=True)
    uniq, inv, counts = torch.unique_consecutive(keys_s, return_inverse=True,
                                                 return_counts=True)
    sums = torch.zeros((uniq.shape[0], 3), dtype=prec.dtype, device=p.device)
    sums.index_add_(0, inv, p[order].to(prec.dtype))
    keep = uniq.shape[0] if max_points is None else max_points
    return uniq[:keep], prec.q(sums / counts[:, None].to(prec.dtype))[:keep]


def knn_indices(points: torch.Tensor, k: int, prec: Precision = F64,
                block: int = 2048) -> torch.Tensor:
    """[N,k] indices of each point's k nearest points (itself included) by
    brute force over row blocks, distances |a|² + |b|² − 2a·b in ``prec``."""
    p = prec.q(points)
    sq = prec.q((p * p).sum(1))
    out = []
    for s in range(0, p.shape[0], block):
        a = p[s:s + block]
        d2 = prec.q(sq[s:s + block, None] + sq[None, :] - 2.0 * prec.q(a @ p.T))
        out.append(torch.topk(d2, min(k, p.shape[0]), dim=1, largest=False).indices)
    return torch.cat(out)


def covariances(points: torch.Tensor, k: int, prec: Precision = F64,
                block: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N,3,3] plane-regularised covariances of ``points`` [N,3] from their
    k nearest neighbours, and [N,3] the eigenvalues of the neighbourhood's
    covariance, ascending."""
    p = prec.q(points)
    n = p.shape[0]
    idx = knn_indices(p, k, prec, block)
    d = prec.q(p[idx] - p[:, None, :])  # [N,k,3]
    kk = idx.shape[1]
    mean = prec.q(d.sum(1) / kk)
    cov = prec.q(torch.einsum("nki,nkj->nij", d, d) / kk
                 - mean[:, :, None] * mean[:, None, :])
    vals, vecs = torch.linalg.eigh(cov.to(torch.float64))
    v0 = prec.q(vecs[:, :, 0])
    eye = torch.eye(3, dtype=prec.dtype, device=p.device).expand(n, 3, 3)
    reg = prec.q(eye - (1.0 - 1e-3) * v0[:, :, None] * v0[:, None, :])
    return (reg if kk >= 5 else eye.clone()), vals


def preprocess(points: torch.Tensor, leaf: float, k: int, prec: Precision = F64,
               max_points: int = None):
    """(keys, means [V,3], covariances [V,3,3], eigenvalues [V,3]) of a raw
    scan [N,3], downsampled to at most ``max_points`` rows."""
    keys, means = voxelgrid(points, leaf, prec, max_points)
    return (keys, means, *covariances(means, k, prec))
