"""Scale-out registration on ``torch.distributed``: batched and point-sharded.

Counterpart of ``small_gicp_tpu/parallel/sharding.py``, on the meshes of
``parallel/multihost.py`` (a 1-D ``DeviceMesh``, one device a rank):

  * batch (data) parallel — ``align_batch``: B independent pairs; each rank
    registers its contiguous block of pairs, one after the other, through
    ``align_impl`` (K1 and the step kernel per iteration for float32 pairs
    on the card), and one gather returns the [B] results to every rank;
  * point (sequence) parallel — ``align_point_sharded``: ONE registration
    with the source rows split over the ranks and the target replicated;
    ``align_impl(psum_axis=mesh)`` all-reduces the 44 float64 sums and the
    K+1 trial errors each iteration, so every rank takes the same steps.

``mesh=None`` runs on one device without ``torch.distributed``.
"""

from __future__ import annotations

from typing import Optional

import torch

from small_gicp_tpu_torch.models.registration import RegistrationResult, align_impl
from small_gicp_tpu_torch.parallel.multihost import (
    all_gather_fields,
    block,
    global_mesh,
    mesh_group,
)
from small_gicp_tpu_torch.point_cloud import PointCloud, stack_clouds

__all__ = ["make_mesh", "align_batch", "align_point_sharded", "stack_clouds"]


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data", *,
              device=None):
    """1-D mesh over every rank of the group that ``multihost.initialize``
    brought up, on the card (or ``device``). A rank drives one device, so
    ``num_devices`` (the JAX package's device count) must be None or the
    world size: a rank left out of the mesh would still have to join every
    collective."""
    mesh = global_mesh(axis_name, device=device)
    if num_devices is not None and num_devices != mesh.size():
        raise ValueError(f"num_devices must be None or the world size {mesh.size()}, "
                         f"got {num_devices}")
    return mesh


def _lane(clouds: PointCloud, i: int) -> PointCloud:
    """Pair ``i`` of [B]-stacked clouds."""
    return PointCloud(
        points=clouds.points[i], num_points=clouds.num_points[i],
        normals=None if clouds.normals is None else clouds.normals[i],
        covs=None if clouds.covs is None else clouds.covs[i])


def _stack_results(results) -> RegistrationResult:
    return RegistrationResult(**{
        name: torch.stack([getattr(r, name) for r in results])
        for name in RegistrationResult.__dataclass_fields__})


def align_batch(targets: PointCloud, sources: PointCloud, init_Ts,
                mesh=None, **kwargs) -> RegistrationResult:
    """Register B scan pairs.

    Args:
      targets/sources: clouds with a leading [B] axis (``stack_clouds``).
      init_Ts: [B,4,4] initial guesses.
      mesh: optional 1-D mesh; the batch axis is split over its ranks in
        contiguous blocks (B a multiple of its size).
      kwargs: ``align_impl``'s options (registration_type, optimizer, ...).

    Returns a RegistrationResult with a leading [B] axis, on every rank.
    """
    b = targets.points.shape[0]
    init_Ts = torch.as_tensor(init_Ts)
    lanes = range(b)
    if mesh is not None:
        group, rank, size = mesh_group(mesh)
        if b % size:
            raise ValueError(f"batch size {b} must be a multiple of the mesh size {size}")
        lanes = range(b)[block(b, rank, size)]
    res = _stack_results([
        align_impl(_lane(targets, i), _lane(sources, i), None, init_Ts[i], **kwargs)
        for i in lanes])
    return res if mesh is None else all_gather_fields(res, group, size)


def align_point_sharded(target: PointCloud, source: PointCloud, init_T, mesh,
                        **kwargs) -> RegistrationResult:
    """One registration with the SOURCE rows split over the mesh: each rank
    searches and linearizes its contiguous block of rows against the
    replicated target, and ``align_impl(use_fused="never", psum_axis=mesh)``
    all-reduces the sums and the trial errors, so every rank takes the same
    optimizer decisions and returns the same result. The source's capacity
    must be a multiple of the mesh size."""
    _, rank, size = mesh_group(mesh)
    n = source.points.shape[0]
    if n % size:
        raise ValueError(f"source capacity {n} must be a multiple of the mesh size "
                         f"{size} (pad the cloud with PointCloud.with_capacity)")
    rows = block(n, rank, size)
    # Valid rows are a prefix, so rank k holds clamp(num_points - k·rows, 0, rows).
    local_num = torch.clamp(source.num_points - rows.start, 0, n // size).to(torch.int32)
    local = PointCloud(
        points=source.points[rows], num_points=local_num,
        normals=None if source.normals is None else source.normals[rows],
        covs=None if source.covs is None else source.covs[rows])
    return align_impl(target, local, None, init_T, use_fused="never", psum_axis=mesh,
                      **kwargs)
