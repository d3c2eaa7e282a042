"""High-level one-call API: raw points or preprocessed clouds in,
RegistrationResult out. Counterpart of ``small_gicp_tpu/models/helper.py``,
with its parameters in the same positions; the port's own (``optimizer``,
``device``, ``fused_route``) follow them as keywords only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.ops.normals import estimate_normals_covariances
from small_gicp_tpu_torch.models.registration import (
    _NOT_PORTED,
    Registration,
    RegistrationResult,
)

_M_PI = 3.141592653589793
# Targets this slice registers against; voxel maps come with ROADMAP A6.
_CLOUD_TYPES = (PointCloud, np.ndarray, torch.Tensor, list, tuple)


@dataclass
class RegistrationSetting:
    """Mirror of the reference RegistrationSetting, defaults identical."""

    type: str = "gicp"  # "icp" | "plane_icp" | "gicp"
    voxel_resolution: float = 1.0
    downsampling_resolution: float = 0.25
    max_correspondence_distance: float = 1.0
    rotation_eps: float = 0.1 * _M_PI / 180.0
    translation_eps: float = 1e-3
    num_threads: int = 4  # accepted for parity; the card decides parallelism
    max_iterations: int = 20
    verbose: bool = False


def preprocess_points(points, downsampling_resolution: float = 0.25,
                      num_neighbors: int = 10, num_threads: int = 4,
                      max_points: Optional[int] = None, *,
                      device=None) -> Tuple[PointCloud, KdTree]:
    """Downsample → searcher → normals and covariances. The searcher keeps
    the cloud's Morton sort, which the covariance stage walks and an
    ``align`` against this cloud with this tree walks again.

    ``points`` is a PointCloud (which stays on its device) or an
    [N,3]/[N,4] array, placed on ``device`` (default: the card).
    ``num_threads`` is accepted and ignored, as the JAX package does.
    """
    del num_threads
    cloud = points if isinstance(points, PointCloud) else PointCloud.from_points(
        points, device=device)
    down = voxelgrid_sampling(cloud, downsampling_resolution, max_points=max_points)
    tree = KdTree.build(down)
    down = estimate_normals_covariances(down, tree, num_neighbors=num_neighbors)
    return down, tree


def align(target, source, target_tree: Optional[KdTree] = None,
          init_T_target_source=None, registration_type: str = "gicp",
          voxel_resolution: float = 1.0, downsampling_resolution: float = 0.25,
          max_correspondence_distance: float = 1.0, num_threads: int = 4,
          max_iterations: int = 20, rotation_eps: float = 0.1 * _M_PI / 180.0,
          translation_eps: float = 1e-3, verbose: bool = False,
          max_points: Optional[int] = None,
          rotation_epsilon: Optional[float] = None,
          translation_epsilon: Optional[float] = None, *, optimizer: str = "lm",
          device=None, fused_route: Optional[str] = None) -> RegistrationResult:
    """One-shot align of raw [N,3] arrays (preprocessed here, with k=10
    neighbours) or of preprocessed PointClouds. A preprocessed target may be
    a map of millions of rows: above 1,572,864 the fused search sweeps its
    Morton-sorted tiles (``fused_route`` forces "listed" or "swept").

    ``rotation_epsilon`` / ``translation_epsilon`` are the reference
    bindings' spellings and take precedence over ``rotation_eps`` /
    ``translation_eps`` when given. ``voxel_resolution`` serves VGICP, which
    is not ported (ROADMAP A6); ``num_threads`` is accepted and ignored, as
    the JAX package does. ``device`` places raw arrays (default: the card);
    preprocessed clouds stay where they are.
    """
    del voxel_resolution, num_threads
    if rotation_epsilon is not None:
        rotation_eps = rotation_epsilon
    if translation_epsilon is not None:
        translation_eps = translation_epsilon
    registration_type = registration_type.lower()
    if registration_type == "vgicp" or not isinstance(target, _CLOUD_TYPES):
        raise NotImplementedError(_NOT_PORTED)
    if registration_type not in ("icp", "plane_icp", "gicp"):
        raise ValueError(f"unknown registration type {registration_type!r}")

    preprocessed = (isinstance(target, PointCloud) and isinstance(source, PointCloud)
                    and _is_preprocessed(target, source, registration_type))
    if not preprocessed:
        target, target_tree = preprocess_points(
            target, downsampling_resolution, num_neighbors=10,
            max_points=max_points, device=device)
        source, _ = preprocess_points(
            source, downsampling_resolution, num_neighbors=10,
            max_points=max_points, device=device)

    reg = Registration(
        registration_type=registration_type,
        optimizer=optimizer,
        max_correspondence_distance=max_correspondence_distance,
        rotation_eps=rotation_eps,
        translation_eps=translation_eps,
        max_iterations=max_iterations,
        verbose=verbose,
        fused_route=fused_route,
    )
    return reg.align(target, source, target_tree, init_T_target_source)


def _is_preprocessed(target: PointCloud, source: PointCloud, rtype: str) -> bool:
    if rtype == "icp":
        return True
    if rtype == "plane_icp":
        return target.normals is not None
    return target.covs is not None and source.covs is not None
