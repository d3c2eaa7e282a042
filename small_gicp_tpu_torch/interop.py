"""Interop: a stateful registration class and array conversions.

Counterpart of ``small_gicp_tpu/interop.py``. ``RegistrationTPU`` (the JAX
package's name, kept) follows the reference's RegistrationPCL workflow
(pcl/pcl_registration.hpp:15-112): set the inputs, estimate covariances
and build the searchers lazily at ``align``, reuse them across calls and
source/target swaps, read the final Hessian. The converters speak ROS
PointCloud2-like buffers (duck-typed, no ROS install), numpy and torch.
``cloud_from_numpy`` builds a PointCloud from arrays in the reference's
layout — for example the fields of a JAX-package cloud taken with
``np.asarray`` — so that both packages compute on identical inputs;
``result_to_numpy`` turns a RegistrationResult into plain numpy values.
"""

from __future__ import annotations

import types
from typing import Optional

import numpy as np
import torch

from small_gicp_tpu_torch.point_cloud import PointCloud, resolve_device
from small_gicp_tpu_torch.models.registration import Registration, RegistrationResult
from small_gicp_tpu_torch.models.voxelmap import GaussianVoxelMap
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.ops.normals import estimate_covariances


def cloud_from_numpy(points, num_points, normals=None, covs=None,
                     device=None) -> PointCloud:
    """Padded [N,4] points (+ [N,4] normals, [N,3,3] covs) → PointCloud.

    The arrays are copied and keep their dtype and padding as given;
    ``device`` defaults to the card.
    """
    dev = resolve_device(device)

    def put(a) -> Optional[torch.Tensor]:
        return None if a is None else torch.tensor(np.asarray(a), device=dev)

    pts = put(points)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f"points must be [N,4], got {tuple(pts.shape)}")
    return PointCloud(
        points=pts,
        num_points=torch.tensor(int(num_points), dtype=torch.int32, device=dev),
        normals=put(normals),
        covs=put(covs),
    )


def result_to_numpy(result: RegistrationResult) -> dict:
    """RegistrationResult → dict of numpy arrays and Python scalars; a
    fleet's [P]-batched result gives [P] arrays in place of the scalars."""
    batched = result.T_target_source.dim() == 3

    def get(t, scalar):
        a = t.detach().cpu().numpy()
        return a if batched else scalar(a)

    return {
        "T_target_source": result.T_target_source.detach().cpu().numpy(),
        "converged": get(result.converged, bool),
        "iterations": get(result.iterations, int),
        "num_inliers": get(result.num_inliers, int),
        "H": result.H.detach().cpu().numpy(),
        "b": result.b.detach().cpu().numpy(),
        "error": get(result.error, float),
    }


class RegistrationTPU:
    """Stateful GICP / VGICP registration with RegistrationPCL's workflow
    (pcl/pcl_registration.hpp:15-112; pcl_registration_impl.hpp:202-246).

    Covariances (K3 on the card), each cloud's ``KdTree`` and the target's
    Gaussian voxel map are made lazily at ``align`` and kept per input
    cloud, so repeated aligns and ``swapSourceAndTarget`` make none of them
    again. As in the reference, a cloud's covariances are estimated over its
    own tree (whose Morton sort K3 reuses), and that tree then serves as the
    target's searcher after a swap. Inputs go to ``device`` (default: the
    card); a ``PointCloud`` stays where it is.
    """

    def __init__(self, *, device=None):
        self.device = resolve_device(device)
        self._num_threads = 4  # parity only
        self._k_correspondences = 20  # pcl_registration.hpp's default
        self._rotation_epsilon = 2e-3
        self._transformation_epsilon = 5e-4
        self._voxel_resolution = 1.0
        self._max_correspondence_distance = 1.0
        self._registration_type = "GICP"
        self._max_iterations = 64
        self._verbose = False

        self._source: Optional[PointCloud] = None
        self._target: Optional[PointCloud] = None
        self._source_tree: Optional[KdTree] = None
        self._target_tree: Optional[KdTree] = None
        self._source_voxelmap: Optional[GaussianVoxelMap] = None
        self._target_voxelmap: Optional[GaussianVoxelMap] = None
        self._result: Optional[RegistrationResult] = None

    # -- setters (RegistrationPCL's names) -------------------------------
    def setNumThreads(self, n: int):
        self._num_threads = n

    def setCorrespondenceRandomness(self, k: int):
        self.setNumNeighborsForCovariance(k)

    def setNumNeighborsForCovariance(self, k: int):
        self._k_correspondences = k

    def setVoxelResolution(self, r: float):
        self._voxel_resolution = r

    def setRotationEpsilon(self, eps: float):
        self._rotation_epsilon = eps

    def setTransformationEpsilon(self, eps: float):
        self._transformation_epsilon = eps

    def setMaximumIterations(self, n: int):
        self._max_iterations = n

    def setMaxCorrespondenceDistance(self, d: float):
        self._max_correspondence_distance = d

    def setRegistrationType(self, t: str):
        if t.upper() not in ("GICP", "VGICP"):
            raise ValueError("registration type must be 'GICP' or 'VGICP'")
        self._registration_type = t.upper()

    def setVerbosity(self, v: bool):
        self._verbose = v

    # -- inputs -----------------------------------------------------------
    def setInputSource(self, cloud):
        self._source = as_point_cloud(cloud, device=self.device)
        self._source_tree = None
        self._source_voxelmap = None

    def setInputTarget(self, cloud):
        self._target = as_point_cloud(cloud, device=self.device)
        self._target_tree = None
        self._target_voxelmap = None

    def setSourceCovariances(self, covs):
        self._source = self._source.replace(covs=_as_covs(covs, self._source))

    def setTargetCovariances(self, covs):
        self._target = self._target.replace(covs=_as_covs(covs, self._target))

    def getSourceCovariances(self) -> np.ndarray:
        return self._source.covs_numpy()

    def getTargetCovariances(self) -> np.ndarray:
        return self._target.covs_numpy()

    def swapSourceAndTarget(self):
        """Swap the clouds and what was made for them."""
        self._source, self._target = self._target, self._source
        self._source_tree, self._target_tree = self._target_tree, self._source_tree
        self._source_voxelmap, self._target_voxelmap = (
            self._target_voxelmap, self._source_voxelmap)

    def clearSource(self):
        self._source = None
        self._source_tree = None
        self._source_voxelmap = None

    def clearTarget(self):
        self._target = None
        self._target_tree = None
        self._target_voxelmap = None

    # -- results ------------------------------------------------------------
    def getFinalHessian(self) -> np.ndarray:
        return self._result.H.cpu().numpy()

    def getRegistrationResult(self) -> RegistrationResult:
        return self._result

    def hasConverged(self) -> bool:
        return bool(self._result.converged)

    def getFinalTransformation(self) -> np.ndarray:
        return self._result.T_target_source.cpu().numpy()

    # -- align ----------------------------------------------------------------
    def _tree(self, which: str) -> KdTree:
        tree = getattr(self, f"_{which}_tree")
        if tree is None:
            tree = KdTree.build(getattr(self, f"_{which}"))
            setattr(self, f"_{which}_tree", tree)
        return tree

    def _ensure_covs(self, which: str):
        cloud = getattr(self, f"_{which}")
        if cloud is None:
            raise RuntimeError(f"input {which} not set")
        if cloud.covs is None:
            # Lazy covariance estimation (pcl_registration_impl.hpp:210-215).
            cloud = estimate_covariances(cloud, self._tree(which),
                                         num_neighbors=self._k_correspondences)
            setattr(self, f"_{which}", cloud)

    def align(self, guess=None) -> np.ndarray:
        """Register; returns the 4x4 transform (target <- source), like
        RegistrationPCL::align + getFinalTransformation."""
        self._ensure_covs("source")
        self._ensure_covs("target")
        src = self._source
        guess = (torch.eye(4, dtype=src.dtype, device=src.device) if guess is None
                 else torch.as_tensor(guess, dtype=src.dtype, device=src.device))
        common = dict(max_iterations=self._max_iterations,
                      rotation_eps=self._rotation_epsilon,
                      translation_eps=self._transformation_epsilon,
                      verbose=self._verbose)
        if self._registration_type == "GICP":
            reg = Registration(
                registration_type="gicp",
                max_correspondence_distance=self._max_correspondence_distance,
                **common)
            self._result = reg.align(self._target, src, self._tree("target"), guess)
        else:
            if self._target_voxelmap is None:
                self._target_voxelmap = GaussianVoxelMap.build(
                    self._target, self._voxel_resolution)
            reg = Registration(registration_type="vgicp", **common)
            self._result = reg.align(self._target_voxelmap, src, None, guess)
        return self.getFinalTransformation()


# ----------------------------------------------------------------------
# Array conversion (ROS PointCloud2, torch, numpy structured buffers)
# ----------------------------------------------------------------------


def as_point_cloud(obj, capacity: Optional[int] = None, *, device=None) -> PointCloud:
    """A PointCloud from numpy arrays, torch tensors or structured xyz
    records (PCL layouts), placed on ``device`` (default: the card); a
    PointCloud is returned as it is."""
    if isinstance(obj, PointCloud):
        return obj
    if isinstance(obj, torch.Tensor):
        return PointCloud.from_points(obj.detach(), capacity=capacity, device=device)
    arr = np.asarray(obj)
    if arr.dtype.names:
        from small_gicp_tpu_torch.pcl_interop import from_pcl

        return from_pcl(arr, capacity=capacity, device=device)
    return PointCloud.from_points(arr, capacity=capacity, device=device)


def from_pointcloud2(fields: dict, data: bytes, point_step: int,
                     capacity: Optional[int] = None, *, device=None) -> PointCloud:
    """A ROS PointCloud2-like buffer → PointCloud: ``fields`` maps a name to
    its byte offset (float32 x/y/z required), ``data`` is the packed buffer;
    rows with a non-finite coordinate are skipped (ros/ros_impl.hpp:45-120)."""
    n = len(data) // point_step
    raw = np.frombuffer(data, dtype=np.uint8).reshape(n, point_step)
    xyz = np.empty((n, 3), np.float32)
    for i, name in enumerate(("x", "y", "z")):
        off = fields[name]
        xyz[:, i] = raw[:, off:off + 4].copy().view(np.float32)[:, 0]
    xyz = xyz[np.isfinite(xyz).all(axis=1)]
    return PointCloud.from_points(xyz, capacity=capacity, device=device)


def to_pointcloud2(cloud: PointCloud) -> dict:
    """PointCloud → PointCloud2-like dict (fields, point_step, data), the
    inverse of ``from_pointcloud2`` (ros/ros_impl.hpp:123-171)."""
    xyz = cloud.points_numpy()[:, :3].astype(np.float32)
    return {"fields": {"x": 0, "y": 4, "z": 8}, "point_step": 12,
            "width": xyz.shape[0], "data": xyz.tobytes()}


def from_ros_msg(msg, capacity: Optional[int] = None, *, device=None) -> PointCloud:
    """A sensor_msgs/PointCloud2 message (ROS1 or ROS2: duck-typed over
    ``fields`` with name/offset, ``data`` and ``point_step``) → PointCloud;
    NaN points are skipped, as in the reference."""
    offsets = {f.name: f.offset for f in msg.fields}
    for req in ("x", "y", "z"):
        if req not in offsets:
            raise ValueError(f"PointCloud2 message lacks field {req!r}; "
                             f"have {sorted(offsets)}")
    return from_pointcloud2(offsets, bytes(msg.data), int(msg.point_step),
                            capacity=capacity, device=device)


def to_ros_msg(cloud: PointCloud, msg=None, frame_id: str = "map"):
    """PointCloud → sensor_msgs/PointCloud2 (ros/ros_impl.hpp:123-171; xyz,
    and normals when present).

    A ROS1 or ROS2 PointCloud2 given as ``msg`` is filled in place (its
    PointField class is taken from the message's own package); with
    ``msg=None`` a SimpleNamespace of the same attributes is returned.
    """
    xyz = cloud.points_numpy()[:, :3].astype(np.float32)
    names = ["x", "y", "z"]
    cols = [xyz]
    if cloud.normals is not None:
        names += ["normal_x", "normal_y", "normal_z"]
        cols.append(cloud.normals_numpy()[:, :3].astype(np.float32))
    packed = np.concatenate(cols, axis=1)
    point_step = 4 * packed.shape[1]

    field_cls = None
    if msg is not None:
        import importlib
        import sys

        mod = sys.modules.get(type(msg).__module__)
        try:  # sensor_msgs.msg.PointField lives next to PointCloud2
            field_cls = getattr(importlib.import_module(
                getattr(mod, "__package__", None) or ""), "PointField")
        except (ImportError, AttributeError, ValueError):
            field_cls = None

    def make_field(name, offset):
        if field_cls is not None:
            f = field_cls()
            f.name, f.offset, f.datatype, f.count = name, offset, 7, 1
            return f
        return types.SimpleNamespace(name=name, offset=offset, datatype=7,  # FLOAT32
                                     count=1)

    out = msg if msg is not None else types.SimpleNamespace()
    out.height = 1
    out.width = packed.shape[0]
    out.fields = [make_field(n, 4 * i) for i, n in enumerate(names)]
    out.is_bigendian = False
    out.point_step = point_step
    out.row_step = point_step * packed.shape[0]
    out.data = packed.tobytes()
    out.is_dense = True
    if hasattr(out, "header") and hasattr(out.header, "frame_id"):
        out.header.frame_id = frame_id
    elif msg is None:
        out.header = types.SimpleNamespace(frame_id=frame_id)
    return out


def to_torch(cloud: PointCloud) -> torch.Tensor:
    """The live xyz rows as a CPU tensor [num_points, 3]."""
    return torch.from_numpy(cloud.points_numpy()[:, :3].copy())


def _as_covs(covs, cloud: PointCloud) -> torch.Tensor:
    """[num_points,3,3] (or the reference's 4x4-padded [num_points,4,4])
    covariances → the cloud's [capacity,3,3] tensor."""
    covs = covs.detach().cpu().numpy() if isinstance(covs, torch.Tensor) else np.asarray(covs)
    if covs.ndim == 3 and covs.shape[1:] == (4, 4):
        covs = covs[:, :3, :3]
    if covs.shape != (len(cloud), 3, 3):
        raise ValueError(f"expected [{len(cloud)},3,3] covs, got {covs.shape}")
    out = torch.zeros((cloud.capacity, 3, 3), dtype=cloud.dtype, device=cloud.device)
    out[:len(cloud)] = torch.from_numpy(np.ascontiguousarray(covs)).to(out)
    return out
