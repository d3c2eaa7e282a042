"""Plain Gaussian voxel map and its voxel-key correspondences (VGICP).

Semantics (small_gicp's ``GaussianVoxelMap``, ``ann/gaussian_voxelmap.hpp``
over ``ann/incremental_voxelmap.hpp``, as ``odometry_benchmark
small_vgicp_model`` runs it):
  * a point's voxel is floor(p / leaf) of the placed point;
  * a voxel holds the sum of its points, the sum of their covariances and
    their count; its mean and covariance are the sums divided by the count;
  * LRU: every voxel an insert touches is stamped with the insert counter
    before the insert, the counter then advances by one, and every
    ``lru_clear_cycle``-th insert (the counter a multiple of it) evicts the
    voxels whose stamp + ``lru_horizon`` < counter;
  * the search of a query q looks at q's voxel and, with 7 offsets, its 6
    face neighbours in the order (0,0,0), ±x, ±y, ±z; the nearest voxel mean
    wins, the first of equal minima in that order; a query with no voxel
    there has none (d² = inf).

Departures from small_gicp:
  * the sums are kept in float64 from the points; small_gicp keeps each
    voxel's finished mean and covariance and multiplies them back by the
    count before the next insert adds to them: the same values up to
    rounding;
  * an empty insert changes nothing and does not advance the counter
    (small_gicp advances it); the cells feed no empty frame;
  * the map has no slot capacity (small_gicp's has none either); a program
    with fixed slots agrees only while they last.
"""

from __future__ import annotations

import math

import torch

from gicp_bench.reference import gicp as ref_gicp
from gicp_bench.reference.precision import F64, Precision

_OFF = 1 << 20
_BITS = 21
OFFSETS = {1: [(0, 0, 0)],
           7: [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
               (0, 0, -1)]}


def coords(points: torch.Tensor, leaf: float) -> torch.Tensor:
    """[N,3] int64 voxel coordinates floor(p / leaf), in float64."""
    return torch.floor(points.double() / leaf).to(torch.int64)


def pack(c: torch.Tensor) -> torch.Tensor:
    """[..., 3] voxel coordinates → [...] int64 keys ordered by (z, y, x)."""
    c = c + _OFF
    return (c[..., 2] << (2 * _BITS)) | (c[..., 1] << _BITS) | c[..., 0]


class GaussianVoxelMap:
    """The Gaussian voxel map: ``keys`` [M] ascending, ``psum`` [M,3],
    ``csum`` [M,3,3], ``count`` [M], ``stamp`` [M] (float64 sums, int64
    count and stamps), and the insert ``counter``."""

    def __init__(self, leaf: float, lru_horizon: int = 100, lru_clear_cycle: int = 10,
                 device=None):
        self.leaf, self.horizon, self.cycle = leaf, int(lru_horizon), int(lru_clear_cycle)
        self.counter = 0
        self.keys = torch.zeros(0, dtype=torch.int64, device=device)
        self.psum = torch.zeros((0, 3), dtype=torch.float64, device=device)
        self.csum = torch.zeros((0, 3, 3), dtype=torch.float64, device=device)
        self.count = torch.zeros(0, dtype=torch.int64, device=device)
        self.stamp = torch.zeros(0, dtype=torch.int64, device=device)

    @classmethod
    def from_views(cls, leaf: float, means: torch.Tensor, covs: torch.Tensor,
                   counts: torch.Tensor, stamps: torch.Tensor, counter: int,
                   lru_horizon: int = 100, lru_clear_cycle: int = 10) -> "GaussianVoxelMap":
        """A map holding voxels given by their means [M,3], covariances
        [M,3,3], counts [M] and stamps [M] (each voxel's key is its mean's):
        the sums are the views times the counts. Voxels whose means share a
        key are merged into one (their sums added, the newest stamp kept)."""
        m = cls(leaf, lru_horizon, lru_clear_cycle, means.device)
        n = counts.to(torch.float64)
        m.keys, inv = torch.unique(pack(coords(means, leaf)), return_inverse=True)
        k = m.keys.numel()
        m.psum = torch.zeros((k, 3), dtype=torch.float64, device=means.device).index_add_(
            0, inv, means.double() * n[:, None])
        m.csum = torch.zeros((k, 3, 3), dtype=torch.float64, device=means.device).index_add_(
            0, inv, covs.double() * n[:, None, None])
        m.count = torch.zeros(k, dtype=torch.int64, device=means.device).index_add_(
            0, inv, counts.to(torch.int64))
        m.stamp = torch.full((k,), -(1 << 62), dtype=torch.int64,
                             device=means.device).scatter_reduce(
            0, inv, stamps.to(torch.int64), reduce="amax")
        m.counter = int(counter)
        return m

    def copy(self) -> "GaussianVoxelMap":
        m = GaussianVoxelMap(self.leaf, self.horizon, self.cycle, self.keys.device)
        m.counter = self.counter
        m.keys, m.psum, m.csum = self.keys.clone(), self.psum.clone(), self.csum.clone()
        m.count, m.stamp = self.count.clone(), self.stamp.clone()
        return m

    def insert(self, points: torch.Tensor, covs: torch.Tensor) -> None:
        """Add placed points [N,3] with their covariances [N,3,3], then run
        the LRU cycle."""
        if points.shape[0] == 0:
            return
        k = pack(coords(points, self.leaf))
        keys, inv = torch.unique(torch.cat([self.keys, k]), return_inverse=True)
        n0 = self.keys.shape[0]
        old, new = inv[:n0], inv[n0:]
        m = keys.shape[0]
        dev = keys.device
        psum = torch.zeros((m, 3), dtype=torch.float64, device=dev)
        csum = torch.zeros((m, 3, 3), dtype=torch.float64, device=dev)
        count = torch.zeros(m, dtype=torch.int64, device=dev)
        stamp = torch.zeros(m, dtype=torch.int64, device=dev)
        psum[old], csum[old], count[old], stamp[old] = (self.psum, self.csum, self.count,
                                                        self.stamp)
        psum.index_add_(0, new, points.double())
        csum.index_add_(0, new, covs.double())
        count.index_add_(0, new, torch.ones_like(new))
        stamp[new] = self.counter
        self.counter += 1
        keep = torch.ones(m, dtype=torch.bool, device=dev)
        if self.counter % self.cycle == 0:
            keep = stamp + self.horizon >= self.counter
        self.keys, self.psum, self.csum = keys[keep], psum[keep], csum[keep]
        self.count, self.stamp = count[keep], stamp[keep]

    @property
    def means(self) -> torch.Tensor:
        return self.psum / self.count[:, None].to(torch.float64)

    @property
    def covs(self) -> torch.Tensor:
        return self.csum / self.count[:, None, None].to(torch.float64)

    def lookup(self, num_offsets: int = 1, prec: Precision = F64) -> "VoxelLookup":
        return VoxelLookup(self.keys, self.means, self.leaf, num_offsets, prec)


class VoxelLookup:
    """Voxel-key correspondences over a map's voxels: ``nearest(q)`` gives
    (d² [N], index [N] into ``points``), the nearest voxel mean among the
    query's voxel and its offsets; d² = inf and index 0 where none is. It
    stands in ``reference/gicp.py``'s ``gicp_lm(..., grid=)`` for the exact
    ``Grid``; the target covariances passed there are the map's ``covs`` in
    the same order."""

    def __init__(self, keys: torch.Tensor, means: torch.Tensor, leaf: float,
                 num_offsets: int = 1, prec: Precision = F64):
        if num_offsets not in OFFSETS:
            raise ValueError(f"num_offsets must be one of {sorted(OFFSETS)}")
        self.keys, self.leaf, self.prec = keys, leaf, prec
        self.points = prec.q(means)
        self.offsets = torch.tensor(OFFSETS[num_offsets], dtype=torch.int64,
                                    device=keys.device)

    def nearest(self, q: torch.Tensor, block: int = 8192):
        n, m = q.shape[0], self.keys.shape[0]
        if m == 0:
            return (torch.full((n,), math.inf, dtype=torch.float64, device=q.device),
                    torch.zeros(n, dtype=torch.int64, device=q.device))
        d2_all, idx_all = [], []
        for s in range(0, n, block):
            qb = q[s:s + block]
            cand = pack(coords(qb, self.leaf)[:, None, :] + self.offsets[None])  # [B,K]
            pos = torch.searchsorted(self.keys, cand).clamp(max=m - 1)
            hit = self.keys[pos] == cand
            diff = self.prec.q(self.points[pos] - qb[:, None, :])
            d2 = self.prec.q((diff * diff).sum(-1)).double()
            d2 = torch.where(hit, d2, math.inf)
            best, arg = d2.min(1)  # the first of equal minima
            d2_all.append(best)
            idx_all.append(torch.where(torch.isfinite(best),
                                       pos.gather(1, arg[:, None])[:, 0], 0))
        return torch.cat(d2_all), torch.cat(idx_all)


def vgicp_lm(vmap: GaussianVoxelMap, source: torch.Tensor, source_covs: torch.Tensor,
             T0, prec: Precision = F64, num_offsets: int = 1, **lm):
    """VGICP: ``reference/gicp.py``'s GICP with LM against the map's voxel
    means and covariances, searched by voxel key."""
    lookup = vmap.lookup(num_offsets, prec)
    return ref_gicp.gicp_lm(lookup.points, prec.q(vmap.covs), source, source_covs, T0,
                            prec, grid=lookup, **lm)
