"""Voxelgrid downsampling with voxel-moment covariances, in torch.

Counterpart of ``small_gicp_tpu/ops/voxel_covs.py``. The voxelgrid's key
sort already groups the points by voxel, so each output point's local
surface covariance is assembled from the first and second moments of its
27-voxel neighbourhood: one sorted-key lookup a neighbour instead of a kNN
over the downsampled cloud (the moments VGICP's Gaussian voxels hold). The
neighbour set differs from kNN-20's, but GICP's plane regularisation keeps
only the eigenvector frame, which both recover on locally planar geometry.

Each point is centred on its own voxel's corner before its moments are
summed (r = p − corner, O(leaf)), and a neighbour's moments are moved to
the query voxel's corner by the parallel-axis identity with the exact
integer offset δ = offset·leaf; raw p·pᵀ moments would cancel in float32
beyond ~100 m.

Counts, Σr and Σrrᵀ per voxel are differences of one float64 prefix sum
at the segment ends (``downsampling._run_sums``) where the JAX package
takes one ordered ``segment_sum``: ``index_add_`` sums by atomics on the
card, which change float32 sums from run to run, so the card and the CPU
agree only this way. The 27-voxel sums, the covariance and its smallest
eigenvector stay in float64 too (the JAX package: the cloud's dtype), for
the same reason: a near-degenerate neighbourhood turns its float32
eigenvector on rounding differences between the card's and the CPU's
arithmetic. Everything is elementwise products and sums (no
matmul), so TF32 settings do not reach it. No host read.
"""

from __future__ import annotations

import torch

from small_gicp_tpu_torch.point_cloud import PointCloud, pad_row
from small_gicp_tpu_torch.ops.downsampling import _run_sums
from small_gicp_tpu_torch.ops.eigh3 import smallest_eigvec3x3
from small_gicp_tpu_torch.ops.voxel_keys import (
    INVALID_KEY,
    neighbor_offsets,
    pack_coords,
    segment_ids,
    unpack_key,
    voxel_coords,
)

_MIN_NEIGHBOR_POINTS = 5  # normal_estimation.hpp:71's invalid threshold
# The nine (i, j) entries of a 3x3 in row-major order.
_I = (0, 0, 0, 1, 1, 1, 2, 2, 2)
_J = (0, 1, 2, 0, 1, 2, 0, 1, 2)


def voxelgrid_sampling_with_covs_impl(points: torch.Tensor, num_points, leaf_size,
                                      max_points: int):
    """(out_points [max_points,4], out_n 0-d int32, covs [max_points,3,3],
    normals [max_points,4]) of a cloud's first ``num_points`` rows."""
    out_points, out_n, cov, enough = neighborhood_covariances(points, num_points, leaf_size,
                                                              max_points)
    m, dt, dev = max_points, points.dtype, points.device
    v0 = smallest_eigvec3x3(cov).to(dt)
    # Plane regularisation V·diag(1e-3,1,1)·Vᵀ = I − (1−1e-3)·v₀v₀ᵀ.
    eye = torch.eye(3, dtype=dt, device=dev).expand(m, 3, 3)
    reg = eye - (1.0 - 1e-3) * v0[:, :, None] * v0[:, None, :]
    out_covs = torch.where(enough[:, None, None], reg, eye)
    # Normals: the smallest eigenvector, flipped toward the origin.
    flip = torch.sum(out_points[:, :3] * v0, dim=-1) > 0.0
    normal = torch.where(flip[:, None], -v0, v0)
    normal = torch.where(enough[:, None], normal, 0.0)
    out_normals = torch.cat([normal, normal.new_zeros((m, 1))], dim=-1)
    return out_points, out_n, out_covs, out_normals


def neighborhood_covariances(points: torch.Tensor, num_points, leaf_size, max_points: int):
    """(out_points [max_points,4], out_n 0-d int32, cov [max_points,3,3]
    float64, enough [max_points] bool): the voxel means and the raw (biased)
    covariance of each one's 27-voxel neighbourhood, before the plane
    regularisation; ``enough``: a real row with at least 5 neighbourhood
    points."""
    n = points.shape[0]
    dt, dev = points.dtype, points.device
    rows = torch.arange(n, device=dev)
    leaf = (leaf_size.to(device=dev, dtype=dt) if isinstance(leaf_size, torch.Tensor)
            else torch.full((), leaf_size, dtype=dt, device=dev))

    vcoords = voxel_coords(points[:, :3], torch.ones((), dtype=dt, device=dev) / leaf)
    keys = pack_coords(vcoords)
    keys = torch.where(rows < num_points, keys, INVALID_KEY)
    keys_s, order = torch.sort(keys, stable=True)
    rel_s = points[order, :3] - vcoords[order].to(dt) * leaf  # [n,3], O(leaf)
    valid, seg_first, seg, num_voxels = segment_ids(keys_s)

    # Per voxel: count, Σr, Σrrᵀ (the products in the cloud's dtype, as the
    # JAX package forms them), summed in float64 over each sorted run.
    w = valid.to(dt)
    rel_w = rel_s * w[:, None]
    cols = torch.cat([w[:, None], rel_w, rel_s[:, _I] * rel_w[:, _J]], dim=1)
    cols = torch.where(valid[:, None], cols, 0.0).to(torch.float64)
    nxt = torch.cat([keys_s[1:], keys_s.new_full((1,), INVALID_KEY)])
    last = valid & (nxt != keys_s)
    ends = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    ends.scatter_(0, torch.where(last, seg, n), rows)
    is_voxel = rows < num_voxels
    sums = torch.where(is_voxel[:, None], _run_sums(cols, ends[:n]), 0.0)
    counts_v, sums3, outer = sums[:, 0], sums[:, 1:4], sums[:, 4:].reshape(n, 3, 3)
    # A run's key is its first key (the JAX package's segment_max).
    first = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    first.scatter_(0, torch.where(seg_first, seg, n), rows)
    vox_keys = torch.where(is_voxel, keys_s[first[:n]], INVALID_KEY)

    # Output points: voxel means = corner + centred mean.
    vox_corner = unpack_key(vox_keys).to(dt) * leaf
    means3 = vox_corner + sums3.to(dt) / torch.clamp(counts_v, min=1.0).to(dt)[:, None]
    means = torch.cat([means3, torch.ones_like(means3[:, :1])], dim=1)

    m = max_points
    if m > n:
        means = torch.cat([means, means.new_zeros((m - n, 4))])
        vox_keys_out = torch.cat([vox_keys, vox_keys.new_full((m - n,), INVALID_KEY)])
    else:
        vox_keys_out = vox_keys
    out_n = torch.clamp(num_voxels, max=m)
    out_valid = torch.arange(m, device=dev) < out_n
    out_points = torch.where(out_valid[:, None], means[:m], pad_row(dt, dev))
    out_keys = vox_keys_out[:m]

    # The 27-voxel neighbourhood of each output voxel, its moments moved to
    # the query corner c₀ (δ_k = corner_k − c₀ = offset_k·leaf):
    #   Σ (p−c₀)        = Σr + n_k·δ_k
    #   Σ (p−c₀)(p−c₀)ᵀ = Σrrᵀ + δ_k Σrᵀ + Σr δ_kᵀ + n_k·δ_k δ_kᵀ
    offs = neighbor_offsets(27, device=dev)
    cand = pack_coords(unpack_key(out_keys)[:, None, :] + offs[None, :, :])  # [m,27]
    pos = torch.clamp(torch.searchsorted(vox_keys, cand.reshape(-1)).reshape(m, 27),
                      0, n - 1)
    hit = (vox_keys[pos] == cand) & (cand != INVALID_KEY) & out_valid[:, None]
    hw = hit.to(torch.float64)

    # The neighbourhood sums and the covariance in float64: a float32 sum
    # over 27 voxels rounds by the order of its reduction, which the card and
    # the CPU do not share, and a near-degenerate eigenvector magnifies it.
    delta = offs.to(dt).double() * leaf.double()  # [27,3]
    s_k = sums3[pos]  # [m,27,3]
    hn = hw * counts_v[pos]  # [m,27]
    nb_count = hn.sum(dim=1)
    nb_sums = (hw[:, :, None] * s_k).sum(dim=1) + (hn[:, :, None] * delta).sum(dim=1)
    cross = (hw[:, :, None, None] * delta[None, :, :, None] * s_k[:, :, None, :]).sum(dim=1)
    nb_outer = ((hw[:, :, None, None] * outer[pos]).sum(dim=1) + cross
                + cross.transpose(-1, -2)
                + (hn[:, :, None, None] * (delta[:, :, None] * delta[:, None, :])).sum(dim=1))
    safe = torch.clamp(nb_count, min=1.0)
    mu = nb_sums / safe[:, None]
    cov = nb_outer / safe[:, None, None] - mu[:, :, None] * mu[:, None, :]

    enough = (nb_count >= _MIN_NEIGHBOR_POINTS) & out_valid
    return out_points, out_n.to(torch.int32), cov, enough

def voxelgrid_sampling_with_covs(cloud: PointCloud, leaf_size: float, max_points: int,
                                 need_normals: bool = False) -> PointCloud:
    """Downsample a PointCloud and estimate its covariances (and, with
    ``need_normals``, normals) from the voxel moments in one pass, on the
    cloud's device."""
    pts, n, covs, normals = voxelgrid_sampling_with_covs_impl(
        cloud.points, cloud.num_points, leaf_size, max_points)
    return PointCloud(points=pts, num_points=n, covs=covs,
                      normals=normals if need_normals else None)
