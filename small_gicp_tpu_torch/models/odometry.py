"""LiDAR odometry engines (scan-to-scan and scan-to-model), in torch.

Counterpart of ``small_gicp_tpu/models/odometry.py``: the reference's
odometry benchmark engines (src/benchmark/odometry_benchmark_*.cpp;
registry benchmark_odom.hpp:29-117) as streaming engines that take one
[N,3] scan at a time. Each frame is voxelgrid-downsampled, gets its
covariances (or normals) and is registered against the previous frame or
the model map; the state (previous cloud, voxel map, poses) stays on the
engine's device, which is the card unless ``device="cpu"`` is given. The
chunked whole-sequence path is ``models/odometry_scan.py``.

Engines (reference counterparts):
  * ScanToScanOdometry      — odometry_benchmark_small_gicp{,_omp,_tbb}.cpp
  * ScanToModelOdometry     — odometry_benchmark_small_gicp_model_{omp,tbb}.cpp
                              (IncrementalVoxelMap target, absolute pose)
  * VGICPModelOdometry      — odometry_benchmark_small_vgicp_model_{omp,tbb}.cpp
                              (GaussianVoxelMap target)
  * VGICPScanToScanOdometry — odometry_benchmark_small_vgicp_{omp,tbb}.cpp
  * FlowScanToScanOdometry  — odometry_benchmark_small_gicp_tbb_flow.cpp
  * ProjectiveScanToScanOdometry — scan-to-scan GICP searched through the
                              equirectangular ProjectiveSearch
                              (ann/projective_search.hpp:42-184)
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from small_gicp_tpu_torch.point_cloud import PointCloud, resolve_device
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.normals import estimate_covariances, estimate_normals
from small_gicp_tpu_torch.ops.projective_search import ProjectiveSearch
from small_gicp_tpu_torch.models.registration import Registration
from small_gicp_tpu_torch.models.voxelmap import GaussianVoxelMap, IncrementalVoxelMap
from small_gicp_tpu_torch.utils.benchmark import Summarizer
from small_gicp_tpu_torch.utils.lie import orthonormalize, rigid_inverse


@dataclass
class OdometryParams:
    """Mirror of OdometryEstimationParams (benchmark_odom.hpp:19-27) with the
    JAX package's fields and defaults."""

    num_threads: int = 4  # parity only; the card decides parallelism
    num_neighbors: int = 20
    downsampling_resolution: float = 0.25
    voxel_resolution: float = 1.0
    max_correspondence_distance: float = 1.0
    # Static capacities: raw scan rows, rows after the voxelgrid, point rows
    # of the model map.
    max_scan_points: int = 131072
    max_downsampled: int = 32768
    map_capacity: int = 131072
    # Voxel slots of the incremental map (None → map_capacity // 4).
    map_voxel_capacity: Optional[int] = None
    dtype: str = "float32"  # "float32" | "float64"
    # Factor of the scan-to-scan engines ("icp" | "plane_icp" | "gicp").
    registration_type: str = "gicp"
    # Seed each alignment with the constant-velocity prediction T_world·T_delta
    # instead of the previous pose (not in the reference; off by default).
    predict_motion: bool = False
    # Voxel neighbourhood searched in the model maps (1, 7 or 27). The
    # reference default is 1; at ≥ 1 m frame motion with 1 m voxels the
    # one-voxel basin is narrower than the motion, and 7 restores the whole
    # rejector radius.
    num_offsets: int = 1
    # LRU bounds of the model maps (reference set_lru; horizon 100, clear
    # every 10 inserts).
    lru_horizon: int = 100
    lru_clear_cycle: int = 10
    # Motion sanity clamp (off by default, not in the reference): an
    # alignment whose translation lies more than this many metres from the
    # constant-velocity prediction is rejected and the engine coasts on the
    # prediction; inactive until a motion estimate exists. Enforced by the
    # model engines of both paths; the others warn when it is set.
    max_frame_motion: Optional[float] = None
    # Live-row budget of the map-side target of the "_fused" model engines
    # (chunked path only): the map's cloud view is compacted to this many
    # live rows before the fused prepare, and live rows beyond it are
    # dropped. None = off.
    model_prepared_rows: Optional[int] = None
    # Type of the optimizer's 6x6 solves: "same" (the clouds') or "float64".
    solve_dtype: str = "same"


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of ``OdometryParams.dtype``."""
    if name not in ("float32", "float64"):
        raise ValueError(f"dtype must be 'float32' or 'float64', got {name!r}")
    return getattr(torch, name)


class _OdometryBase:
    """Frame feeding and timing shared by the streaming engines
    (OnlineOdometryEstimation, benchmark_odom.hpp:44-80)."""

    # Engines that keep a constant-velocity motion model (T_delta) set
    # this; max_frame_motion is enforceable only on them.
    _supports_motion_clamp = False

    def __init__(self, params: Optional[OdometryParams] = None, *, device=None):
        self.params = params or OdometryParams()
        self.device = resolve_device(device)
        self.dtype = torch_dtype(self.params.dtype)
        self.reg_times = Summarizer()
        self.traj: List[np.ndarray] = []
        if (self.params.max_frame_motion is not None
                and not self._supports_motion_clamp):
            warnings.warn(
                f"{type(self).__name__} has no constant-velocity motion "
                "model; max_frame_motion is ignored by this engine "
                "(supported by the scan-to-model engines and the jitted "
                "odometry_scan path)",
                stacklevel=3,
            )

    def _eye(self) -> torch.Tensor:
        return torch.eye(4, dtype=self.dtype, device=self.device)

    def _motion_clamp(self, aligned: torch.Tensor) -> torch.Tensor:
        """Reject an alignment whose translation deviates more than
        max_frame_motion from the prediction T_world·T_delta and coast on
        the prediction, as the chunked path does; inactive until a motion
        estimate exists. By ``torch.where``: no host read."""
        mfm = self.params.max_frame_motion
        if mfm is None:
            return aligned
        pred = self.T_world @ self.T_delta
        dev = torch.linalg.vector_norm(aligned[:3, 3] - pred[:3, 3])
        have_motion = torch.linalg.vector_norm(self.T_delta[:3, 3]) > 1e-6
        reject = have_motion & (dev > mfm)
        return torch.where(reject, pred, aligned)

    def _prep_frame(self, points_xyz) -> PointCloud:
        p = self.params
        return PointCloud.from_points(np.asarray(points_xyz, dtype=p.dtype),
                                      capacity=p.max_scan_points, device=self.device)

    def _downsample(self, cloud: PointCloud) -> PointCloud:
        p = self.params
        return voxelgrid_sampling(cloud, p.downsampling_resolution,
                                  max_points=p.max_downsampled)

    def _with_covs(self, cloud: PointCloud) -> PointCloud:
        return estimate_covariances(self._downsample(cloud),
                                    num_neighbors=self.params.num_neighbors)

    def estimate(self, frames) -> np.ndarray:
        """Run odometry over a list of [N,3] scans; returns [F,4,4] poses."""
        for f in frames:
            t0 = time.perf_counter()
            T = self.estimate_frame(f)
            self.reg_times.push((time.perf_counter() - t0) * 1e3)
            self.traj.append(T.cpu().numpy())
        return np.stack(self.traj)

    def estimate_frame(self, points_xyz) -> torch.Tensor:
        raise NotImplementedError

    def report(self) -> str:
        return f"registration_time_stats={self.reg_times} [msec/scan]"


class ScanToScanOdometry(_OdometryBase):
    """Scan-to-scan odometry (odometry_benchmark_small_gicp_omp.cpp:16-43):
    each frame is aligned to the previous one from the identity, and
    T_world accumulates the relative poses."""

    def __init__(self, params: Optional[OdometryParams] = None,
                 registration_type: Optional[str] = None, *, device=None):
        super().__init__(params, device=device)
        p = self.params
        self.registration_type = registration_type or p.registration_type
        self.reg = Registration(
            registration_type=self.registration_type,
            max_correspondence_distance=p.max_correspondence_distance,
            solve_dtype=p.solve_dtype,
        )
        self._prev: Optional[PointCloud] = None
        self.T_world = self._eye()

    def _preprocess(self, cloud: PointCloud) -> PointCloud:
        if self.registration_type == "plane_icp":
            return estimate_normals(self._downsample(cloud),
                                    num_neighbors=self.params.num_neighbors)
        if self.registration_type == "icp":
            return self._downsample(cloud)
        return self._with_covs(cloud)

    def estimate_frame(self, points_xyz) -> torch.Tensor:
        cur = self._preprocess(self._prep_frame(points_xyz))
        if self._prev is None:
            self._prev = cur
            return self.T_world
        result = self.reg.align(self._prev, cur, None, None)
        # Re-project: the running float32 rotation product drifts off SO(3).
        self.T_world = orthonormalize(self.T_world @ result.T_target_source)
        self._prev = cur
        return self.T_world


class ScanToModelOdometry(_OdometryBase):
    """GICP scan-to-model odometry with an incremental voxel map
    (odometry_benchmark_small_gicp_model_tbb.cpp:22-47): the map is the
    target and its own search structure; the absolute pose is solved, then
    the frame is inserted at it. Frame 0 is inserted at the identity and
    not aligned."""

    _supports_motion_clamp = True

    def __init__(self, params: Optional[OdometryParams] = None, *, device=None):
        super().__init__(params, device=device)
        p = self.params
        self.reg = Registration(
            registration_type="gicp",
            max_correspondence_distance=p.max_correspondence_distance,
            solve_dtype=p.solve_dtype,
        )
        self.voxelmap = self._empty_map(has_covs=True)
        self.T_world = self._eye()
        self.T_delta = self._eye()
        self._first = True

    def _empty_map(self, **payload) -> IncrementalVoxelMap:
        p = self.params
        return IncrementalVoxelMap.empty(
            p.voxel_resolution, capacity=p.map_capacity, dtype=self.dtype,
            cell_capacity=10, num_offsets=p.num_offsets, lru_horizon=p.lru_horizon,
            lru_clear_cycle=p.lru_clear_cycle,
            voxel_capacity=p.map_voxel_capacity or p.map_capacity // 4,
            device=self.device, **payload)

    def _preprocess(self, cloud: PointCloud) -> PointCloud:
        return self._with_covs(cloud)

    def estimate_frame(self, points_xyz) -> torch.Tensor:
        cur = self._preprocess(self._prep_frame(points_xyz))
        if self._first:
            self.voxelmap = self.voxelmap.insert(cur, self.T_world)
            self._first = False
            return self.T_world
        guess = (self.T_world @ self.T_delta if self.params.predict_motion
                 else self.T_world)
        result = self.reg.align(self.voxelmap, cur, None, guess)
        T_new = orthonormalize(self._motion_clamp(result.T_target_source))
        self.T_delta = rigid_inverse(self.T_world) @ T_new
        self.T_world = T_new
        self.voxelmap = self.voxelmap.insert(cur, self.T_world)
        return self.T_world


class PlaneICPModelOdometry(ScanToModelOdometry):
    """Point-to-plane scan-to-model odometry: the incremental map stores
    normals and the point-to-plane factor runs against it (no reference
    counterpart; the registry's twin of the chunked ``plane_icp_model``)."""

    def __init__(self, params: Optional[OdometryParams] = None, *, device=None):
        super().__init__(params, device=device)
        p = self.params
        self.reg = Registration(
            registration_type="plane_icp",
            max_correspondence_distance=p.max_correspondence_distance,
            solve_dtype=p.solve_dtype,
        )
        self.voxelmap = self._empty_map(has_normals=True)

    def _preprocess(self, cloud: PointCloud) -> PointCloud:
        return estimate_normals(self._downsample(cloud),
                                num_neighbors=self.params.num_neighbors)


class VGICPModelOdometry(_OdometryBase):
    """VGICP scan-to-model odometry with a Gaussian voxel map
    (odometry_benchmark_small_vgicp_model_tbb.cpp:30-45). Frame 0 is
    inserted at the identity and not aligned."""

    _supports_motion_clamp = True

    def __init__(self, params: Optional[OdometryParams] = None, *, device=None):
        super().__init__(params, device=device)
        p = self.params
        self.reg = Registration(registration_type="vgicp", solve_dtype=p.solve_dtype)
        self.voxelmap = GaussianVoxelMap.empty(
            p.voxel_resolution, capacity=p.map_capacity, dtype=self.dtype,
            num_offsets=p.num_offsets, lru_horizon=p.lru_horizon,
            lru_clear_cycle=p.lru_clear_cycle, device=self.device)
        self.T_world = self._eye()
        self.T_delta = self._eye()
        self._first = True

    def estimate_frame(self, points_xyz) -> torch.Tensor:
        cur = self._with_covs(self._prep_frame(points_xyz))
        if self._first:
            self.voxelmap = self.voxelmap.insert(cur, self.T_world)
            self._first = False
            return self.T_world
        guess = (self.T_world @ self.T_delta if self.params.predict_motion
                 else self.T_world)
        result = self.reg.align(self.voxelmap, cur, None, guess)
        T_new = orthonormalize(self._motion_clamp(result.T_target_source))
        self.T_delta = rigid_inverse(self.T_world) @ T_new
        self.T_world = T_new
        self.voxelmap = self.voxelmap.insert(cur, self.T_world)
        return self.T_world


class VGICPScanToScanOdometry(_OdometryBase):
    """VGICP scan-to-scan odometry: the previous frame's Gaussian voxel map
    is the target of each step (odometry_benchmark_small_vgicp_{omp,tbb}.cpp)."""

    def __init__(self, params: Optional[OdometryParams] = None, *, device=None):
        super().__init__(params, device=device)
        self.reg = Registration(registration_type="vgicp",
                                solve_dtype=self.params.solve_dtype)
        self._prev_map: Optional[GaussianVoxelMap] = None
        self.T_world = self._eye()

    def estimate_frame(self, points_xyz) -> torch.Tensor:
        p = self.params
        cur = self._with_covs(self._prep_frame(points_xyz))
        cur_map = GaussianVoxelMap.build(cur, p.voxel_resolution,
                                         capacity=p.max_downsampled)
        if self._prev_map is None:
            self._prev_map = cur_map
            return self.T_world
        result = self.reg.align(self._prev_map, cur, None, None)
        self.T_world = orthonormalize(self.T_world @ result.T_target_source)
        self._prev_map = cur_map
        return self.T_world


class FlowScanToScanOdometry(ScanToScanOdometry):
    """Pipelined scan-to-scan odometry, the counterpart of the reference's
    TBB flow-graph engine (odometry_benchmark_small_gicp_tbb_flow.cpp:56-141):
    the poses stay on the device inside the loop, and the trajectory is
    read once at the end. An event recorded after each frame is waited on
    in order, so the laps between those waits are the pipeline's real
    per-frame laps (benchmark_odom.hpp:54-57)."""

    def estimate(self, frames) -> np.ndarray:
        device_traj, done = [], []
        t_start = time.perf_counter()
        on_card = self.device.type == "cuda"
        for f in frames:
            device_traj.append(self.estimate_frame(f))
            if on_card:
                ev = torch.cuda.Event()
                ev.record()
                done.append(ev)
        t_prev = t_start
        for i in range(len(device_traj)):
            if on_card:
                done[i].synchronize()
            t_now = time.perf_counter()
            self.reg_times.push((t_now - t_prev) * 1e3)
            t_prev = t_now
        poses = (torch.stack(device_traj).cpu().numpy() if device_traj
                 else np.zeros((0, 4, 4), self.params.dtype))
        self.traj = list(poses)
        return poses


class ProjectiveScanToScanOdometry(ScanToScanOdometry):
    """Scan-to-scan GICP whose correspondences come from the equirectangular
    ``ProjectiveSearch`` instead of the exact search (the engine form of
    plugging it into the Registration template, 03_registration_template.cpp:
    152-179). The index image is rebuilt from the previous cloud every frame
    (one scatter); the align takes the unfused route, its LM iterations the
    step kernel."""

    def estimate_frame(self, points_xyz) -> torch.Tensor:
        cur = self._preprocess(self._prep_frame(points_xyz))
        if self._prev is None:
            self._prev = cur
            return self.T_world
        tree = ProjectiveSearch.build(self._prev)
        result = self.reg.align(self._prev, cur, tree, None)
        # Re-project: the running float32 rotation product drifts off SO(3).
        self.T_world = orthonormalize(self.T_world @ result.T_target_source)
        self._prev = cur
        return self.T_world


def _scan_to_scan_factory(rtype):
    def make(params=None, *, device=None):
        return ScanToScanOdometry(params, registration_type=rtype, device=device)

    return make


ENGINES = {
    "small_gicp": ScanToScanOdometry,
    "small_icp": _scan_to_scan_factory("icp"),
    "small_plane_icp": _scan_to_scan_factory("plane_icp"),
    "small_vgicp": VGICPScanToScanOdometry,
    "small_gicp_model": ScanToModelOdometry,
    "small_plane_icp_model": PlaneICPModelOdometry,
    "small_vgicp_model": VGICPModelOdometry,
    "small_gicp_flow": FlowScanToScanOdometry,
    "small_gicp_projective": ProjectiveScanToScanOdometry,
}


def create_odometry(engine: str, params: Optional[OdometryParams] = None, *,
                    device=None):
    """Engine registry (benchmark_odom.hpp:112-116); ``device`` defaults to
    the card."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; have {sorted(ENGINES)}")
    return ENGINES[engine](params, device=device)


def write_trajectory(path: str, poses: np.ndarray):
    """KITTI-format trajectory (3x4 rows), evo-compatible
    (odometry_benchmark.cpp:82-94)."""
    with open(path, "w") as f:
        for T in poses:
            row = np.asarray(T)[:3, :].reshape(-1)
            f.write(" ".join(f"{v:.9g}" for v in row) + "\n")
