"""Chunked odometry: the per-frame step of the scan-to-model and
scan-to-scan loops, and ``JitOdometry``, which drives it over chunks of
frames held on the device.

Counterpart of ``small_gicp_tpu/models/odometry_scan.py``. The JAX package
traces the step into one XLA program and runs a chunk as a ``lax.scan``;
here a chunk is a Python loop over its frames with the carry — (T_world,
T_delta, model, is_first) — on the device. One step is downsample →
covariances (or normals; kernel K3) → registration against the model map
(K1 on the map's cloud view for the "_fused" engines, the map's own voxel
search for the others) with the LM step kernel once an iteration → the
insert at the new pose. Whether a frame is the first or a padded empty one
is decided by ``torch.where`` on device tensors: a frame's only host reads
are the optimizer's stop flags (``align_impl``). Empty frames (count 0)
are exact no-ops: the pose and the model carry through unchanged.

Engines: ``gicp_model``, ``vgicp_model``, ``plane_icp_model`` (voxel-key
correspondences) and their ``_fused`` forms (exact nearest stored point
through K1), and the scan-to-scan ``gicp_scan``, ``plane_icp_scan`` and
``icp_scan``. Covariance modes of the model engines: "knn" and
"knn_fused" (exact kNN moments, K3), "knn_window" (the approximate
Morton-banded self-search, ``ops/knn_window.py``) and "voxel" (27-voxel
moments from the voxelgrid's own sort, ``ops/voxel_covs.py``), both torch
ops. ``odometry_scan_batch`` / ``BatchOdometry`` run B independent
sequences: where the JAX package vmaps the lanes into one program, the
port runs each lane's loop in turn, with B carries in a list, so a batch
costs B lanes' launches and host syncs.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from small_gicp_tpu_torch.point_cloud import (
    PAD_SENTINEL,
    PointCloud,
    compact_cloud,
    resolve_device,
)
from small_gicp_tpu_torch.ops.downsampling import _voxelgrid_sampling_impl
from small_gicp_tpu_torch.ops.normals import _estimate_impl
from small_gicp_tpu_torch.ops.voxel_covs import voxelgrid_sampling_with_covs_impl
from small_gicp_tpu_torch.models.registration import align_impl
from small_gicp_tpu_torch.models.voxelmap import (
    GaussianVoxelMap,
    IncrementalVoxelMap,
    ivm_as_cloud,
    voxelmap_as_cloud,
)
from small_gicp_tpu_torch.models.odometry import OdometryParams, torch_dtype
from small_gicp_tpu_torch.utils.lie import orthonormalize, rigid_inverse

COVARIANCE_MODES = ("knn", "knn_fused", "knn_window", "voxel")
MODEL_ENGINES = ("gicp_model", "gicp_model_fused", "vgicp_model", "vgicp_model_fused",
                 "plane_icp_model", "plane_icp_model_fused")
SCAN_ENGINES = ("gicp_scan", "plane_icp_scan", "icp_scan")


def _frame_cloud(frame_points: torch.Tensor, frame_count: torch.Tensor,
                 downsampling_resolution: float, max_downsampled: int,
                 num_neighbors: int, rtype: str, covariance_mode: str = "knn"
                 ) -> PointCloud:
    """The frame downsampled, with normals (point-to-plane), covariances
    (GICP) or neither (ICP). "voxel" takes the covariances from the voxel
    moments (point-to-plane normals stay exact, as in the JAX package);
    "knn_window" searches the windowed lists with the downsampling
    resolution as the Morton cell."""
    if covariance_mode not in COVARIANCE_MODES:
        raise ValueError(f"unknown covariance_mode {covariance_mode!r}; "
                         "have 'knn', 'knn_fused', 'knn_window', 'voxel'")
    if covariance_mode == "voxel" and rtype == "gicp":
        pts, n, covs, _ = voxelgrid_sampling_with_covs_impl(
            frame_points, frame_count, downsampling_resolution, max_downsampled)
        return PointCloud(points=pts, num_points=n, covs=covs)
    mode = {"knn_window": "window", "knn_fused": "fused"}.get(covariance_mode, "exact")
    pts, n = _voxelgrid_sampling_impl(frame_points, frame_count,
                                      downsampling_resolution, max_downsampled)
    if rtype == "plane_icp":
        normals, _ = _estimate_impl(pts, n, num_neighbors, True, False,
                                    neighbor_mode=mode, window_cell=downsampling_resolution)
        return PointCloud(points=pts, num_points=n, normals=normals)
    if rtype == "icp":
        return PointCloud(points=pts, num_points=n)
    _, covs = _estimate_impl(pts, n, num_neighbors, False, True, neighbor_mode=mode,
                             window_cell=downsampling_resolution)
    return PointCloud(points=pts, num_points=n, covs=covs)


def odometry_scan_step(carry, frame_points: torch.Tensor, frame_count: torch.Tensor,
                       downsampling_resolution: float = 0.25,
                       max_correspondence_distance: float = 1.0,
                       max_downsampled: int = 8192, num_neighbors: int = 20,
                       covariance_mode: str = "knn", predict_motion: bool = False,
                       model_nn: str = "voxel", model_rtype: str = "gicp",
                       max_frame_motion: float = 0.0, model_prepared_rows: int = 0,
                       solve_dtype: str = "same"):
    """One scan-to-model step; carry = (T_world [4,4], T_delta [4,4], map,
    is_first 0-d bool), frame_points [N,4] padded homogeneous, frame_count
    0-d int32. Returns (carry, T_new).

    ``covariance_mode``: "knn" or "knn_fused" (both exact kNN moments
    through K3), "knn_window" (approximate windowed kNN lists) or "voxel"
    (27-voxel moments, made with the downsampling).
    ``model_nn``: "voxel" searches the map's own voxel neighbourhood;
    "bruteforce" registers against the map's cloud view
    (``ivm_as_cloud`` / ``voxelmap_as_cloud``) through K1, compacted first
    to ``model_prepared_rows`` live rows when that is set and smaller.
    ``model_rtype``: "gicp" or "plane_icp" (a map of normals). With
    ``predict_motion`` the alignment starts from T_world·T_delta;
    ``max_frame_motion`` > 0 rejects an alignment that lands farther than
    that from the prediction and coasts on the prediction instead.

    The first frame meets an empty map: every correspondence masks out, the
    LM accepts a zero step, and the pose falls back to T_world.
    """
    T_world, T_delta, vm, is_first = carry
    if model_nn not in ("voxel", "bruteforce"):
        raise ValueError(f"model_nn must be 'voxel' or 'bruteforce', got {model_nn!r}")
    cloud = _frame_cloud(frame_points, frame_count, downsampling_resolution,
                         max_downsampled, num_neighbors, model_rtype, covariance_mode)

    guess = T_world @ T_delta if predict_motion else T_world
    target = vm
    if model_nn == "bruteforce":
        needs = "has_normals" if model_rtype == "plane_icp" else "has_covs"
        if isinstance(vm, GaussianVoxelMap):
            target = voxelmap_as_cloud(vm)
        elif isinstance(vm, IncrementalVoxelMap) and getattr(vm, needs):
            target = ivm_as_cloud(vm)
        else:
            raise ValueError("model_nn='bruteforce' needs a GaussianVoxelMap or an "
                             f"IncrementalVoxelMap with {needs}")
        if 0 < model_prepared_rows < target.capacity:
            target = compact_cloud(target, model_prepared_rows)
    result = align_impl(target, cloud, None, guess, registration_type=model_rtype,
                        max_dist_sq=max_correspondence_distance ** 2,
                        solve_dtype=solve_dtype, source_rows=cloud.capacity)
    real = frame_count > 0
    aligned = result.T_target_source
    if max_frame_motion > 0.0:
        # Deviation from the constant-velocity prediction: overshoots and
        # undershoots both reject; inactive until a motion estimate exists.
        pred = T_world @ T_delta
        dev = torch.linalg.vector_norm(aligned[:3, 3] - pred[:3, 3])
        have_motion = torch.linalg.vector_norm(T_delta[:3, 3]) > 1e-6
        aligned = torch.where(have_motion & (dev > max_frame_motion), pred, aligned)
    keep = is_first | ~real
    # Re-project the rotation onto SO(3) every frame: float32 pose products
    # drift off the manifold.
    T_new = torch.where(keep, T_world, orthonormalize(aligned))
    delta_new = torch.where(keep, T_delta, rigid_inverse(T_world) @ T_new)
    vm = vm.insert(cloud, T_new)
    return (T_new, delta_new, vm, is_first & ~real), T_new


def odometry_scan_step_s2s(carry, frame_points: torch.Tensor, frame_count: torch.Tensor,
                           downsampling_resolution: float = 0.25,
                           max_correspondence_distance: float = 1.0,
                           max_downsampled: int = 8192, num_neighbors: int = 20,
                           registration_type: str = "gicp",
                           predict_motion: bool = False):
    """One scan-to-scan step (odometry_benchmark_small_gicp_omp.cpp:16-43):
    the frame is aligned to the previous one from the identity (or the last
    relative motion with ``predict_motion``) and the relative pose
    accumulates. carry = (T_world, T_delta, previous PointCloud, is_first);
    the previous frame rides in the carry at a fixed capacity, and an empty
    frame keeps it."""
    T_world, T_delta, prev, is_first = carry
    cur = _frame_cloud(frame_points, frame_count, downsampling_resolution,
                       max_downsampled, num_neighbors, registration_type)
    eye = torch.eye(4, dtype=T_world.dtype, device=T_world.device)
    guess = T_delta if predict_motion else eye
    result = align_impl(prev, cur, None, guess, registration_type=registration_type,
                        max_dist_sq=max_correspondence_distance ** 2,
                        source_rows=cur.capacity)
    # First frame: the previous cloud is empty and the relative pose stays
    # at the guess; force the identity.
    real = frame_count > 0
    keep = is_first | ~real
    T_rel = torch.where(keep, eye, result.T_target_source)
    # An empty frame keeps T_world as it is: one more sweep of the
    # re-projection would move its last bits, which the JAX package lets
    # happen there.
    T_new = torch.where(real, orthonormalize(T_world @ T_rel), T_world)
    delta_new = torch.where(keep, T_delta, T_rel)

    def pick(a, b):
        return None if a is None else torch.where(real, a, b)

    prev_new = PointCloud(points=pick(cur.points, prev.points),
                          num_points=pick(cur.num_points, prev.num_points),
                          normals=pick(cur.normals, prev.normals),
                          covs=pick(cur.covs, prev.covs))
    return (T_new, delta_new, prev_new, is_first & ~real), T_new


def _run_frames(step, carry, frames: torch.Tensor, counts: torch.Tensor, **kw):
    poses = []
    for i in range(frames.shape[0]):
        carry, T = step(carry, frames[i], counts[i], **kw)
        poses.append(T)
    return carry, torch.stack(poses)


def odometry_scan_s2s(carry, frames: torch.Tensor, counts: torch.Tensor,
                      downsampling_resolution: float = 0.25,
                      max_correspondence_distance: float = 1.0,
                      max_downsampled: int = 8192, num_neighbors: int = 20,
                      registration_type: str = "gicp", predict_motion: bool = False):
    """Scan-to-scan odometry over a chunk of frames [F,N,4] with counts [F]:
    (carry, poses [F,4,4])."""
    return _run_frames(odometry_scan_step_s2s, carry, frames, counts,
                       downsampling_resolution=downsampling_resolution,
                       max_correspondence_distance=max_correspondence_distance,
                       max_downsampled=max_downsampled, num_neighbors=num_neighbors,
                       registration_type=registration_type,
                       predict_motion=predict_motion)


def odometry_scan(carry, frames: torch.Tensor, counts: torch.Tensor,
                  downsampling_resolution: float = 0.25,
                  max_correspondence_distance: float = 1.0,
                  max_downsampled: int = 8192, num_neighbors: int = 20,
                  covariance_mode: str = "knn", predict_motion: bool = False,
                  model_nn: str = "voxel", model_rtype: str = "gicp",
                  max_frame_motion: float = 0.0, model_prepared_rows: int = 0,
                  solve_dtype: str = "same"):
    """Scan-to-model odometry over a chunk of frames [F,N,4] with counts [F]:
    (carry, poses [F,4,4])."""
    return _run_frames(odometry_scan_step, carry, frames, counts,
                       downsampling_resolution=downsampling_resolution,
                       max_correspondence_distance=max_correspondence_distance,
                       max_downsampled=max_downsampled, num_neighbors=num_neighbors,
                       covariance_mode=covariance_mode, predict_motion=predict_motion,
                       model_nn=model_nn, model_rtype=model_rtype,
                       max_frame_motion=max_frame_motion,
                       model_prepared_rows=model_prepared_rows,
                       solve_dtype=solve_dtype)


def stack_frames(frames, n_slots: int, max_scan_points: int, dtype):
    """Host-side stack and pad of [N,3] scans into ([n_slots,
    max_scan_points, 4] padded homogeneous frames, [n_slots] int32 counts):
    sentinel xyz and w = 0 on padding rows, scans cut at max_scan_points."""
    stacked = np.full((n_slots, max_scan_points, 4), PAD_SENTINEL, dtype)
    stacked[:, :, 3] = 0.0
    counts = np.zeros((n_slots,), np.int32)
    for i, f in enumerate(frames):
        f = np.asarray(f, dtype=dtype)[:max_scan_points]
        stacked[i, : len(f), :3] = f
        stacked[i, : len(f), 3] = 1.0
        counts[i] = len(f)
    return stacked, counts


def _model_nn_for(engine: str) -> str:
    """The correspondence mode an engine name implies (``model_nn``)."""
    return "bruteforce" if engine.endswith("_fused") else "voxel"


def _model_rtype_for(engine: str) -> str:
    """The model path's factor an engine name implies."""
    return "plane_icp" if engine.startswith("plane_icp_model") else "gicp"


def make_initial_carry(params: OdometryParams, engine: str, *, device=None):
    """(carry, registration_type) of an odometry loop of ``engine`` on
    ``device`` (default: the card). carry = (T_world, T_delta, model,
    is_first); the model's type (IncrementalVoxelMap, GaussianVoxelMap or
    PointCloud) selects the engine's behaviour in the step.
    registration_type is None for the model engines and the factor's name
    for the scan-to-scan ones."""
    p = params
    dev = resolve_device(device)
    dtype = torch_dtype(p.dtype)
    rtype = None
    lru = dict(num_offsets=p.num_offsets, lru_horizon=p.lru_horizon,
               lru_clear_cycle=p.lru_clear_cycle)
    if engine in ("gicp_model", "gicp_model_fused",
                  "plane_icp_model", "plane_icp_model_fused"):
        payload = ("has_normals" if engine.startswith("plane_icp") else "has_covs")
        vm = IncrementalVoxelMap.empty(
            p.voxel_resolution, capacity=p.map_capacity, dtype=dtype,
            voxel_capacity=p.map_voxel_capacity or p.map_capacity // 4,
            device=dev, **{payload: True}, **lru)
    elif engine in ("vgicp_model", "vgicp_model_fused"):
        vm = GaussianVoxelMap.empty(p.voxel_resolution, capacity=p.map_capacity,
                                    dtype=dtype, device=dev, **lru)
    elif engine in SCAN_ENGINES:
        # The "map" is the previous frame, empty before the first.
        rtype = engine[: -len("_scan")]
        pts = torch.full((p.max_downsampled, 4), PAD_SENTINEL, dtype=dtype, device=dev)
        pts[:, 3] = 0.0
        vm = PointCloud(
            points=pts, num_points=torch.zeros((), dtype=torch.int32, device=dev),
            normals=(torch.zeros((p.max_downsampled, 4), dtype=dtype, device=dev)
                     if rtype == "plane_icp" else None),
            covs=(torch.zeros((p.max_downsampled, 3, 3), dtype=dtype, device=dev)
                  if rtype == "gicp" else None))
    else:
        raise ValueError(f"unknown engine {engine!r}")
    eye = torch.eye(4, dtype=dtype, device=dev)
    carry = (eye, eye.clone(), vm, torch.ones((), dtype=torch.bool, device=dev))
    return carry, rtype


class JitOdometry:
    """Chunked runner of ``odometry_scan``: feed [N,3] numpy scans,
    collect poses; the carry stays on the device across chunks.

    Frames run in chunks of ``chunk_frames``; a tail chunk is padded with
    empty frames, which are exact no-ops. ``chunk_times_ms`` holds each
    chunk's wall time, ended by a device synchronize (the first includes
    building the kernels). The name is the JAX package's, whose chunks are
    one compiled program.
    """

    def __init__(self, params: Optional[OdometryParams] = None,
                 engine: str = "gicp_model", chunk_frames: int = 8,
                 covariance_mode: str = "knn", *, device=None):
        self.chunk_frames = chunk_frames
        self.covariance_mode = covariance_mode
        self.chunk_times_ms: list = []
        self.params = params or OdometryParams()
        self.engine = engine
        self.device = resolve_device(device)
        # Parameters an engine cannot use are dropped loudly.
        if engine.endswith("_scan") and self.params.max_frame_motion is not None:
            warnings.warn(
                f"JitOdometry({engine!r}) is scan-to-scan and has no "
                "constant-velocity motion model; max_frame_motion is "
                "ignored (supported by the jitted MODEL engines)",
                stacklevel=2,
            )
        if self.params.model_prepared_rows and _model_nn_for(engine) != "bruteforce":
            warnings.warn(
                f"JitOdometry({engine!r}): model_prepared_rows only "
                "applies to the _fused (bruteforce-NN) model engines and "
                "is ignored here",
                stacklevel=2,
            )
        self.carry, rtype = make_initial_carry(self.params, engine, device=self.device)
        if rtype is not None:
            self.registration_type = rtype
        self.poses = []

    def _stack_frames(self, frames, n_slots: int):
        p = self.params
        return stack_frames(frames, n_slots, p.max_scan_points, p.dtype)

    def _run_chunk(self, frames_dev: torch.Tensor, counts_dev: torch.Tensor):
        p = self.params
        if self.engine.endswith("_scan"):
            self.carry, poses = odometry_scan_s2s(
                self.carry, frames_dev, counts_dev,
                downsampling_resolution=p.downsampling_resolution,
                max_correspondence_distance=p.max_correspondence_distance,
                max_downsampled=p.max_downsampled, num_neighbors=p.num_neighbors,
                registration_type=self.registration_type,
                predict_motion=p.predict_motion)
            return poses
        self.carry, poses = odometry_scan(
            self.carry, frames_dev, counts_dev,
            downsampling_resolution=p.downsampling_resolution,
            max_correspondence_distance=p.max_correspondence_distance,
            max_downsampled=p.max_downsampled, num_neighbors=p.num_neighbors,
            covariance_mode=self.covariance_mode, predict_motion=p.predict_motion,
            model_nn=_model_nn_for(self.engine), model_rtype=_model_rtype_for(self.engine),
            max_frame_motion=float(p.max_frame_motion or 0.0),
            model_prepared_rows=int(p.model_prepared_rows or 0),
            solve_dtype=p.solve_dtype)
        return poses

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def preload(self, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stack and pad [N,3] scans on the host and copy them to the device
        once, padded to a whole number of chunks: (frames_dev [F',N,4],
        counts_dev [F']) for ``feed_preloaded``, so that per-frame timing
        measures the pipeline and not the host link."""
        fc = self.chunk_frames
        f_pad = (len(frames) + fc - 1) // fc * fc
        stacked, counts = self._stack_frames(frames, f_pad)
        return (torch.from_numpy(stacked).to(self.device),
                torch.from_numpy(counts).to(self.device))

    def feed_preloaded(self, frames_dev: torch.Tensor, counts_dev: torch.Tensor,
                       n_real: Optional[int] = None) -> np.ndarray:
        """Run the loop over device-resident frames (``preload``); returns
        the real frames' [F,4,4] poses. Trailing zero-count frames are taken
        for padding unless ``n_real`` says how many frames are real."""
        fc = self.chunk_frames
        f_pad = frames_dev.shape[0]
        if n_real is None:
            nz = np.nonzero(counts_dev.cpu().numpy() > 0)[0]
            n_real = int(nz[-1]) + 1 if nz.size else 0
        out = []
        for start in range(0, f_pad, fc):
            t0 = time.perf_counter()
            poses_chunk = self._run_chunk(frames_dev[start:start + fc],
                                          counts_dev[start:start + fc])
            self._sync()
            self.chunk_times_ms.append((time.perf_counter() - t0) * 1e3)
            out.append(poses_chunk)
        poses = (torch.cat(out).cpu().numpy()[:n_real] if out
                 else np.zeros((0, 4, 4), self.params.dtype))
        self.poses.extend(poses)
        return poses

    def feed(self, frames) -> np.ndarray:
        """Process [N,3] scans; returns their [F,4,4] poses."""
        fc = self.chunk_frames
        out = []
        for start in range(0, len(frames), fc):
            block = frames[start:start + fc]
            stacked, counts = self._stack_frames(block, fc)
            poses = self._run_chunk(torch.from_numpy(stacked).to(self.device),
                                    torch.from_numpy(counts).to(self.device))
            out.append(poses.cpu().numpy()[:len(block)])
        poses = (np.concatenate(out) if out
                 else np.zeros((0, 4, 4), self.params.dtype))
        self.poses.extend(poses)
        return poses


def odometry_scan_batch(carries, frames: torch.Tensor, counts: torch.Tensor,
                        downsampling_resolution: float = 0.25,
                        max_correspondence_distance: float = 1.0,
                        max_downsampled: int = 8192, num_neighbors: int = 20,
                        covariance_mode: str = "knn", predict_motion: bool = False,
                        registration_type: Optional[str] = None, model_nn: str = "voxel",
                        model_rtype: str = "gicp"):
    """B independent odometry loops: carries a list of B carries
    (``make_initial_carry``), frames [B,F,N,4], counts [B,F]. Each lane runs
    ``odometry_scan`` (``registration_type`` None: the model engines) or
    ``odometry_scan_s2s`` (the factor's name) over its frames, one lane after
    the other; lanes never interact. Returns (carries, poses [B,F,4,4])."""
    out, poses = [], []
    for carry, f, n in zip(carries, frames, counts):
        if registration_type is None:
            carry, p = odometry_scan(
                carry, f, n, downsampling_resolution=downsampling_resolution,
                max_correspondence_distance=max_correspondence_distance,
                max_downsampled=max_downsampled, num_neighbors=num_neighbors,
                covariance_mode=covariance_mode, predict_motion=predict_motion,
                model_nn=model_nn, model_rtype=model_rtype)
        else:
            carry, p = odometry_scan_s2s(
                carry, f, n, downsampling_resolution=downsampling_resolution,
                max_correspondence_distance=max_correspondence_distance,
                max_downsampled=max_downsampled, num_neighbors=num_neighbors,
                registration_type=registration_type, predict_motion=predict_motion)
        out.append(carry)
        poses.append(p)
    return out, torch.stack(poses)


class BatchOdometry:
    """B sequences tracked at once, each lane with its own model map (or
    previous frame), on one device (default: the card).

    A lane's poses equal ``JitOdometry`` over the same frames with the same
    engine and covariance mode: each lane runs the same step. The
    JAX package's ``max_frame_motion``, ``model_prepared_rows`` and
    ``solve_dtype`` do not reach its batch either; they stay at their
    defaults here. ``mesh`` (the lane axis sharded over devices) belongs to
    ROADMAP item A10.
    """

    def __init__(self, num_lanes: int, params: Optional[OdometryParams] = None,
                 engine: str = "gicp_model", covariance_mode: str = "knn",
                 mesh=None, axis_name: str = "data", *, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "BatchOdometry(mesh=...) shards the lanes over devices: ROADMAP item A10")
        del axis_name
        self.params = params or OdometryParams()
        self.engine = engine
        self.covariance_mode = covariance_mode
        self.num_lanes = num_lanes
        self.device = resolve_device(device)
        self.carries = []
        for _ in range(num_lanes):
            carry, self.registration_type = make_initial_carry(self.params, engine,
                                                               device=self.device)
            self.carries.append(carry)

    def feed(self, sequences) -> np.ndarray:
        """``sequences``: B lists of [N,3] scans, of any lengths; a shorter
        lane is padded with empty frames, which are exact no-ops, so its
        padded tail repeats its last pose. Returns [B, F_max, 4, 4]."""
        p = self.params
        if len(sequences) != self.num_lanes:
            raise ValueError(f"expected {self.num_lanes} sequences, got {len(sequences)}")
        f_max = max(len(s) for s in sequences)
        lanes = [stack_frames(seq, f_max, p.max_scan_points, p.dtype) for seq in sequences]
        frames = torch.from_numpy(np.stack([f for f, _ in lanes])).to(self.device)
        counts = torch.from_numpy(np.stack([c for _, c in lanes])).to(self.device)
        self.carries, poses = odometry_scan_batch(
            self.carries, frames, counts,
            downsampling_resolution=p.downsampling_resolution,
            max_correspondence_distance=p.max_correspondence_distance,
            max_downsampled=p.max_downsampled, num_neighbors=p.num_neighbors,
            covariance_mode=self.covariance_mode, predict_motion=p.predict_motion,
            registration_type=self.registration_type,
            model_nn=_model_nn_for(self.engine), model_rtype=_model_rtype_for(self.engine))
        return poses.cpu().numpy()
