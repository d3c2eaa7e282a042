"""Voxelgrid downsampling, in torch.

Counterpart of ``small_gicp_tpu/ops/downsampling.py``: voxel keys → sort
→ per-voxel mean. Output rows come out in key order, with capacity
``max_points`` (default: the input capacity) and ``num_points`` the voxel
count; when there are more voxels than rows the lowest keys are kept.

The segment sums are differences of one float64 prefix sum at segment
ends, so the result is deterministic on every device (no atomics) and
exact to float32. The prefix sum runs along the last dim of the sorted
rows' [4, N] transpose (``_run_sums``): along dim 0 of the [N, 4] rows
(``_run_sums_v1``, the first form) the card runs it as an outer-dim scan,
which took most of preprocessing's device time. No host read.
"""

from __future__ import annotations

from typing import Optional

import torch

from small_gicp_tpu_torch.point_cloud import PointCloud, pad_row
from small_gicp_tpu_torch.ops.voxel_keys import INVALID_KEY, sort_segments, voxel_keys


def _run_sums(rows_s: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """[N,C] float64 sums of the runs of ``rows_s`` [N,C] float64 that end at
    rows ``ends`` [N] (run j: rows ends[j-1]+1 … ends[j]), as differences of
    one prefix sum along the last dim of the [C,N] transpose."""
    csum = torch.cumsum(rows_s.T.contiguous(), dim=1)
    c_end = csum[:, ends]
    return (c_end - torch.cat([c_end.new_zeros((c_end.shape[0], 1)), c_end[:, :-1]],
                              dim=1)).T.contiguous()


def _run_sums_v1(rows_s: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """``_run_sums``' first form: the prefix sum along dim 0 of the rows."""
    c_end = torch.cumsum(rows_s, dim=0)[ends]
    return c_end - torch.cat([c_end.new_zeros((1, 4)), c_end[:-1]])


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
    nxt = torch.cat([keys_s[1:], keys_s.new_full((1,), INVALID_KEY)])
    last = valid & (nxt != keys_s)
    ends = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    ends.scatter_(0, torch.where(last, seg, torch.full_like(seg, n)), rows)
    sums = _run_sums(pts_s, ends[:n])
    means = sums / torch.clamp(sums[:, 3:4], min=1.0)
    means[:, 3] = 1.0
    means = means.to(dt)

    out_n = torch.clamp(num_voxels, max=max_points)
    if max_points > n:
        means = torch.cat([means, means.new_zeros((max_points - n, 4))])
    out_valid = torch.arange(max_points, device=dev) < out_n
    out = torch.where(out_valid[:, None], means[:max_points], pad_row(dt, dev))
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


def random_sampling(cloud: PointCloud, num_samples: int, key) -> PointCloud:
    """Uniform random subsampling without replacement
    (util/downsampling.hpp:85-110, std::sample with a user RNG).

    ``key`` is a ``torch.Generator`` (or None for torch's default one) where
    the JAX package takes a PRNG key: every row gets a uniform score, padding
    scores +inf, and the ``num_samples`` lowest scores are kept. The same
    generator seed gives the same rows; the stream differs from JAX's.
    """
    points, n = cloud.points, cloud.capacity
    dev = key.device if key is not None else points.device
    scores = torch.rand(n, generator=key, device=dev).to(points.device)
    scores = torch.where(torch.arange(n, device=points.device) < cloud.num_points,
                         scores, torch.inf)
    idx = torch.argsort(scores, stable=True)[:num_samples]
    out = points[idx]
    out_n = torch.clamp(cloud.num_points, max=num_samples).to(torch.int32)
    valid = torch.arange(out.shape[0], device=points.device) < out_n
    out = torch.where(valid[:, None], out, pad_row(points.dtype, points.device))
    return PointCloud(points=out, num_points=out_n)
