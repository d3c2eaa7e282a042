"""The port's interop layer against the JAX package on the CPU:
``RegistrationTPU`` (GICP and VGICP, swaps, clears, covariance get and
set, the cached searchers), the ROS PointCloud2 converters and the PCL
structured layouts.

The pair is the 16-ring × 256-step synthetic pair, downsampled by the JAX
package at 0.25 m; both packages take the same xyz arrays and estimate the
covariances themselves, in float64 for the comparison with JAX (within
1e-6, as ``tests/test_torch_preprocess.py`` holds them). Registrations agree at the convergence level of the port's
queue C: poses within 2 × the translation threshold, iterations within
one. Every buffer equals the JAX package's byte for byte.
"""

import math
import types

import numpy as np
import pytest
import torch

import small_gicp_tpu as sgt
from small_gicp_tpu import interop as j_interop
import small_gicp_tpu_torch as pt
from small_gicp_tpu_torch import interop
from small_gicp_tpu_torch.utils.lie import rotation_error_deg, se3_exp
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

TRANS_EPS = 5e-4  # RegistrationTPU's default transformation epsilon
ROT_EPS = 2e-3


@pytest.fixture(scope="module")
def pair():
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    down = [sgt.voxelgrid_sampling(sgt.PointCloud.from_points(s), 0.25).points_numpy()
            [:, :3].copy() for s in scans]
    rng = np.random.default_rng(11)
    tw = np.r_[rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.2]
    init = (T_gt @ se3_exp(torch.as_tensor(tw)).numpy()).astype(np.float32)
    return down[0], down[1], T_gt, init


def _agree(T, T_ref, iters, iters_ref):
    T, T_ref = torch.as_tensor(np.asarray(T, np.float64)), torch.as_tensor(
        np.asarray(T_ref, np.float64))
    assert math.radians(float(rotation_error_deg(T_ref[:3, :3], T[:3, :3]))) <= 2 * ROT_EPS
    assert float(torch.linalg.vector_norm(T[:3, 3] - T_ref[:3, 3])) <= 2 * TRANS_EPS
    assert abs(int(iters) - int(iters_ref)) <= 1


@pytest.mark.parametrize("rtype", ["GICP", "VGICP"])
def test_registration_tpu_matches_jax(pair, rtype):
    tgt, src, T_gt, init = pair
    # float64, where both packages' kNN pick the same neighbour sets (float32
    # rounding reorders near-tied kth neighbours in the JAX CPU search).
    tgt, src, init = tgt.astype(np.float64), src.astype(np.float64), init.astype(np.float64)
    j, t = j_interop.RegistrationTPU(), pt.RegistrationTPU(device="cpu")
    for r in (j, t):
        r.setRegistrationType(rtype.lower())
        r.setNumNeighborsForCovariance(10)
        r.setInputTarget(tgt)
        r.setInputSource(src)
    T_j, T_t = j.align(init), t.align(init)
    assert isinstance(T_t, np.ndarray) and T_t.dtype == np.float64
    _agree(T_t, T_j, t.getRegistrationResult().iterations,
           j.getRegistrationResult().iterations)
    # The flag itself can differ: float32 sums in another order can end the
    # LM at a knife-edge accept one way in one package and the other way in the
    # other (an abort is "not converged").
    assert t.hasConverged() == bool(t.getRegistrationResult().converged)
    assert np.linalg.norm(T_t[:3, 3] - T_gt[:3, 3]) < 0.05
    H, jH = t.getFinalHessian(), np.asarray(j.getFinalHessian())
    assert H.shape == (6, 6)
    np.testing.assert_allclose(H, jH, rtol=0.05, atol=0.05 * np.abs(jH).max())
    np.testing.assert_allclose(t.getSourceCovariances(), j.getSourceCovariances(),
                               atol=1e-6)
    np.testing.assert_allclose(t.getTargetCovariances(), j.getTargetCovariances(),
                               atol=1e-6)


def test_swap_reuses_what_was_made(pair, monkeypatch):
    tgt, src, _, init = pair
    t = pt.RegistrationTPU(device="cpu")
    t.setInputTarget(tgt)
    t.setInputSource(src)
    T1 = t.align(init)
    src_cloud, tgt_cloud = t._source, t._target
    src_tree, tgt_tree = t._source_tree, t._target_tree
    assert src_tree is not None and tgt_tree is not None

    calls = []
    monkeypatch.setattr(interop, "estimate_covariances",
                        lambda *a, **k: calls.append("covs"))
    monkeypatch.setattr(interop.KdTree, "build",
                        staticmethod(lambda *a, **k: calls.append("tree")))
    t.swapSourceAndTarget()
    assert t._source is tgt_cloud and t._target is src_cloud
    assert t._target_tree is src_tree and t._source_tree is tgt_tree
    T2 = t.align(np.linalg.inv(T1))
    assert calls == []  # no covariance estimate and no tree build after the swap
    np.testing.assert_allclose(T2 @ T1, np.eye(4), atol=1e-2)  # the reverse problem
    t.swapSourceAndTarget()
    np.testing.assert_allclose(t.align(init), T1, atol=1e-6)
    assert calls == []

    t.setRegistrationType("VGICP")
    monkeypatch.undo()
    t.align(init)
    vm = t._target_voxelmap
    t.swapSourceAndTarget()
    assert t._source_voxelmap is vm and t._target_voxelmap is None
    t.clearSource()
    assert t._source is None and t._source_tree is None and t._source_voxelmap is None
    with pytest.raises(RuntimeError, match="source not set"):
        t.align()
    t.clearTarget()
    assert t._target is None and t._target_tree is None
    with pytest.raises(ValueError, match="GICP"):
        t.setRegistrationType("icp")


def test_set_and_get_covariances(pair):
    tgt, src, _, _ = pair
    j, t = j_interop.RegistrationTPU(), pt.RegistrationTPU(device="cpu")
    rng = np.random.default_rng(4)
    X = rng.normal(size=(len(src), 3, 3)).astype(np.float32)
    covs = X @ X.transpose(0, 2, 1)
    padded = np.zeros((len(src), 4, 4), np.float32)
    padded[:, :3, :3] = covs
    for r in (j, t):
        r.setInputSource(src)
        r.setInputTarget(tgt)
        r.setSourceCovariances(padded)
        r.setTargetCovariances(np.tile(np.eye(3, dtype=np.float32), (len(tgt), 1, 1)))
    assert np.array_equal(t.getSourceCovariances(), j.getSourceCovariances())
    assert np.array_equal(t.getSourceCovariances(), covs)
    assert np.array_equal(t.getTargetCovariances(), j.getTargetCovariances())
    assert t._source.covs.shape == (t._source.capacity, 3, 3)
    with pytest.raises(ValueError, match="covs"):
        t.setSourceCovariances(covs[:3])


def test_pointcloud2_and_ros_buffers_equal_jax():
    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    xyz[[3, 17], 1] = np.nan
    cloud_j = j_interop.from_pointcloud2({"x": 0, "y": 4, "z": 8}, xyz.tobytes(), 12)
    cloud = pt.from_pointcloud2({"x": 0, "y": 4, "z": 8}, xyz.tobytes(), 12, device="cpu")
    assert len(cloud) == len(cloud_j) == 48
    assert np.array_equal(cloud.points_numpy(), cloud_j.points_numpy())
    msg, j_msg = pt.to_pointcloud2(cloud), j_interop.to_pointcloud2(cloud_j)
    assert msg == j_msg

    # A 16-byte record with intensity, fields at their offsets.
    rec = np.zeros(50, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("i", "<f4")])
    rec["x"], rec["y"], rec["z"], rec["i"] = xyz[:, 0], xyz[:, 1], xyz[:, 2], 7.0
    fields = [types.SimpleNamespace(name=n, offset=o) for n, o in
              (("x", 0), ("y", 4), ("z", 8), ("intensity", 12))]
    ros = types.SimpleNamespace(fields=fields, data=rec.tobytes(), point_step=16)
    got = pt.from_ros_msg(ros, device="cpu")
    assert np.array_equal(got.points_numpy(), j_interop.from_ros_msg(ros).points_numpy())
    with pytest.raises(ValueError, match="lacks field 'z'"):
        pt.from_ros_msg(types.SimpleNamespace(fields=fields[:2], data=b"", point_step=16))

    nrm = np.zeros((48, 4), np.float32)
    nrm[:, 2] = 1.0
    full_n = np.zeros((cloud.capacity, 4), np.float32)
    full_n[:48] = nrm
    out = pt.to_ros_msg(cloud.replace(normals=torch.as_tensor(full_n)), frame_id="velo")
    j_out = j_interop.to_ros_msg(cloud_j.replace(normals=full_n), frame_id="velo")
    assert out.data == j_out.data and out.point_step == j_out.point_step == 24
    assert [(f.name, f.offset, f.datatype) for f in out.fields] == [
        (f.name, f.offset, f.datatype) for f in j_out.fields]
    assert (out.width, out.row_step, out.header.frame_id) == (
        j_out.width, j_out.row_step, "velo")
    assert np.array_equal(pt.from_ros_msg(out, device="cpu").points_numpy(),
                          cloud.points_numpy())


def test_torch_and_point_cloud_coercion():
    rng = np.random.default_rng(8)
    xyz = rng.normal(size=(20, 3)).astype(np.float32)
    cloud = pt.as_point_cloud(xyz, capacity=32, device="cpu")
    assert cloud.capacity == 32 and len(cloud) == 20
    assert pt.as_point_cloud(cloud) is cloud
    from_tensor = pt.as_point_cloud(torch.as_tensor(xyz), device="cpu")
    assert np.array_equal(from_tensor.points_numpy(), j_interop.as_point_cloud(xyz)
                          .points_numpy())
    t = interop.to_torch(cloud)
    assert t.device.type == "cpu" and t.shape == (20, 3)
    assert torch.equal(t, j_interop.to_torch(j_interop.as_point_cloud(xyz)))
    structured = pt.to_pcl(cloud)
    assert pt.as_point_cloud(structured, device="cpu").points_numpy().tobytes() == \
        cloud.points_numpy().tobytes()


@pytest.mark.parametrize("kind", ["xyz", "normal", "covariance", "normal_covariance"])
def test_pcl_layouts_equal_jax(kind):
    rng = np.random.default_rng(9)
    n = 30
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    X = rng.normal(size=(n, 3, 3)).astype(np.float32)
    covs = X @ X.transpose(0, 2, 1)
    nrm = np.zeros((n, 4), np.float32)
    nrm[:, :3] = rng.normal(size=(n, 3))
    j_cloud = sgt.PointCloud.from_points(xyz).replace(normals=nrm, covs=covs)
    cloud = pt.PointCloud.from_points(xyz, device="cpu").replace(
        normals=torch.as_tensor(nrm), covs=torch.as_tensor(covs))
    assert pt.pcl_dtype(kind) == sgt.pcl_dtype(kind)
    buf, j_buf = pt.to_pcl(cloud, kind), sgt.to_pcl(j_cloud, kind)
    assert buf.dtype == j_buf.dtype and buf.tobytes() == j_buf.tobytes()
    assert buf.dtype.itemsize == {"xyz": 16, "normal": 48, "covariance": 80,
                                  "normal_covariance": 96}[kind]
    bad_rec = buf.copy()
    bad_rec["x"][5] = np.inf
    back = pt.from_pcl(bad_rec.tobytes(), kind, device="cpu")
    j_back = sgt.from_pcl(bad_rec.tobytes(), kind)
    assert len(back) == len(j_back) == n - 1
    assert back.points_numpy().tobytes() == j_back.points_numpy().tobytes()
    assert back.has_normals == j_back.has_normals and back.has_covs == j_back.has_covs
    if back.has_normals:
        assert np.array_equal(back.normals_numpy(), j_back.normals_numpy())
    if back.has_covs:
        assert np.array_equal(back.covs_numpy(), j_back.covs_numpy())
    assert pt.to_pcl(back).tobytes() == sgt.to_pcl(j_back).tobytes()


def test_pcl_guards_and_odd_cov_field():
    with pytest.raises(ValueError, match="unknown PCL layout"):
        pt.pcl_dtype("rgb")
    with pytest.raises(ValueError, match="kind="):
        pt.from_pcl(b"\0" * 16, device="cpu")
    with pytest.raises(ValueError, match="structured"):
        pt.from_pcl(np.zeros((3, 3), np.float32), device="cpu")
    odd = np.zeros(4, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("cov", "<f4", (2,))])
    cloud = pt.from_pcl(odd, device="cpu")
    assert not cloud.has_covs and not sgt.from_pcl(odd).has_covs
    xyz_only = pt.PointCloud.from_points(np.zeros((2, 3), np.float32), device="cpu")
    with pytest.raises(ValueError, match="needs normals"):
        pt.to_pcl(xyz_only, "normal")
    with pytest.raises(ValueError, match="needs covariances"):
        pt.to_pcl(xyz_only, "covariance")
