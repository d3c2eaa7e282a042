"""Voxelgrid downsampling, in torch.

Counterpart of ``small_gicp_tpu/ops/downsampling.py``: voxel keys → sort
→ per-voxel mean. Output rows come out in key order, with capacity
``max_points`` (default: the input capacity) and ``num_points`` the voxel
count; when there are more voxels than rows the lowest keys are kept.

The segment sums are differences of one float64 prefix sum at segment
ends, so the result is deterministic on every device (no atomics) and
exact to float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from small_gicp_tpu_torch.point_cloud import PAD_SENTINEL, PointCloud
from small_gicp_tpu_torch.ops.voxel_keys import INVALID_KEY, sort_segments, voxel_keys


def _voxelgrid_sampling_impl(points: torch.Tensor, num_points: torch.Tensor,
                             leaf_size: float, max_points: int):
    n = points.shape[0]
    dt, dev = points.dtype, points.device
    rows = torch.arange(n, device=dev)

    keys = voxel_keys(points[:, :3], leaf_size)
    keys = torch.where(rows < num_points, keys, torch.full_like(keys, INVALID_KEY))
    order, keys_s, valid, seg, num_voxels = sort_segments(keys)

    # Valid rows form contiguous runs at the front; the homogeneous w=1
    # column sums to the per-voxel count.
    pts_s = torch.where(valid[:, None], points[order], 0.0).to(torch.float64)
    csum = torch.cumsum(pts_s, dim=0)
    nxt = torch.cat([keys_s[1:], keys_s.new_full((1,), INVALID_KEY)])
    last = valid & (nxt != keys_s)
    ends = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    ends.scatter_(0, torch.where(last, seg, torch.full_like(seg, n)), rows)
    c_end = csum[ends[:n]]
    sums = c_end - torch.cat([c_end.new_zeros((1, 4)), c_end[:-1]])
    means = sums / torch.clamp(sums[:, 3:4], min=1.0)
    means[:, 3] = 1.0
    means = means.to(dt)

    out_n = torch.minimum(num_voxels, torch.tensor(max_points, device=dev))
    if max_points > n:
        means = torch.cat([means, means.new_zeros((max_points - n, 4))])
    out_valid = torch.arange(max_points, device=dev) < out_n
    pad = torch.tensor([PAD_SENTINEL, PAD_SENTINEL, PAD_SENTINEL, 0.0],
                       dtype=dt, device=dev)
    out = torch.where(out_valid[:, None], means[:max_points], pad)
    return out, out_n.to(torch.int32)


def voxelgrid_sampling(cloud, leaf_size: float, max_points: Optional[int] = None,
                       num_threads: int = 1, *, device=None) -> PointCloud:
    """Exact-mean voxelgrid downsampling of a PointCloud or an [N,3]/[N,4] array.

    Parameters sit in the JAX package's positions; ``num_threads`` is
    parity-only, as it is there. ``device`` applies to array input only; a
    PointCloud stays where it is. Normals and covariances are dropped, as
    in the reference.
    """
    if not isinstance(cloud, PointCloud):
        cloud = PointCloud.from_points(cloud, device=device)
    cap = max_points if max_points is not None else cloud.capacity
    pts, n = _voxelgrid_sampling_impl(cloud.points, cloud.num_points,
                                      leaf_size, cap)
    return PointCloud(points=pts, num_points=n)
