"""small_gicp_tpu_torch — the PyTorch/CUDA port of small_gicp_tpu.

Runs scan-pair preprocessing (voxelgrid downsampling, exact kNN normals
and covariances) and ICP / point-to-plane / GICP registration with GN or
LM on an NVIDIA Hopper card, through hand-written CUDA kernels for the
fused search + linearize (K1), the LM trial errors (K2) and the kNN
moments (K3). ``align_fleet`` registers a queue of problems through
persistent lanes with the lane-aware K7 (linearize) and K8 (trial
errors). ``KdTree`` searches through the standalone 1-NN (K9) and kNN
(K10) kernels; ``ops.knn_cuda.knn_T`` (K11) and ``knn_pruned`` (K12) are
the warp-per-query and the Morton-pruned forms of the same search.
``GaussianVoxelMap`` (VGICP's target: ``align(..., registration_type=
"vgicp")``) and ``IncrementalVoxelMap`` (scan-to-model) are slot-table
voxel maps in torch ops; registration against either runs the LM step
kernel once an iteration. ``models.odometry`` (streaming engines,
``create_odometry``, the projective engine among them) and
``models.odometry_scan`` (``JitOdometry``, ``BatchOdometry``) run LiDAR
odometry on those maps and the kernels above. ``ProjectiveSearch`` (an
equirectangular index image) plugs into ``Registration.align`` as the
target's searcher; ``ops.knn_window`` (``KdTree.knn_search(method=
"window")``, normals' ``neighbor_mode="window"``) and
``ops.voxel_covs.voxelgrid_sampling_with_covs`` are the approximate
windowed kNN and the voxel-moment covariances, torch ops on either device.
``parallel`` scales out on ``torch.distributed``: ``sharding.align_batch``
and ``align_point_sharded``, ``map_sharding`` (a voxel map's slots split
over a mesh), ``fleet.align_fleet_sharded``, and ``BatchOdometry(mesh=)``.
``read_ply`` and ``read_kitti_bin`` load scans. Entry points run on the card unless given ``device="cpu"``,
where every kernel runs its plain PyTorch version.
"""

from small_gicp_tpu_torch.point_cloud import (
    PAD_SENTINEL,
    PointCloud,
    stack_clouds,
    transform_covs,
    transform_points,
)
from small_gicp_tpu_torch.utils.lie import se3_exp, so3_exp, skew
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.knn import KdTree, knn_search, nearest_neighbor_search
from small_gicp_tpu_torch.ops.normals import (
    estimate_covariances,
    estimate_normals,
    estimate_normals_covariances,
)
from small_gicp_tpu_torch.models.registration import (
    Registration,
    RegistrationResult,
    align_points,
)
from small_gicp_tpu_torch.models.voxelmap import (
    GaussianVoxelMap,
    IncrementalVoxelMap,
    IncrementalVoxelMapCov,
    IncrementalVoxelMapNormal,
    IncrementalVoxelMapNormalCov,
)
from small_gicp_tpu_torch.ops.projective_search import ProjectiveSearch
from small_gicp_tpu_torch.models.helper import (
    RegistrationSetting,
    align,
    create_gaussian_voxelmap,
    preprocess_points,
)
from small_gicp_tpu_torch.parallel.fleet import align_fleet, fleet_prepare
from small_gicp_tpu_torch.interop import cloud_from_numpy, result_to_numpy
from small_gicp_tpu_torch.utils.io import read_kitti_bin, read_ply

__all__ = [
    "PAD_SENTINEL", "PointCloud", "stack_clouds", "transform_covs",
    "transform_points", "se3_exp",
    "so3_exp", "skew",
    "voxelgrid_sampling", "KdTree", "knn_search", "nearest_neighbor_search",
    "estimate_covariances", "estimate_normals", "estimate_normals_covariances",
    "Registration", "RegistrationResult", "align_points", "RegistrationSetting",
    "align", "preprocess_points", "create_gaussian_voxelmap", "GaussianVoxelMap",
    "IncrementalVoxelMap", "IncrementalVoxelMapNormal", "IncrementalVoxelMapCov",
    "IncrementalVoxelMapNormalCov", "ProjectiveSearch", "align_fleet", "fleet_prepare",
    "cloud_from_numpy", "result_to_numpy", "read_kitti_bin", "read_ply",
]
