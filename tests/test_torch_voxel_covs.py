"""The port's voxelgrid downsampling with voxel-moment covariances
(``ops/voxel_covs.py``) against the JAX package on the CPU.

Shapes are those of ``tests/test_voxel_covs.py`` (a noisy tilted plane of
20,000 points at 0.5 m into 2,048 rows; a plane patch 300 m from the origin
into 512 rows; 200 points into 512 rows, above the input's capacity), so
that JAX's persistent compilation cache serves the float32 oracle runs.
Tolerances:
  * voxel counts equal; points within 1e-12 m in float64 and 1e-6 m in
    float32 (the port sums each voxel's moments in float64 where the JAX
    package sums in the cloud's dtype, which moves a float32 mean by an
    ulp);
  * covariances and normals within 1e-9 in float64 and 1e-4 in float32 on
    well-conditioned rows: those whose 27-voxel neighbourhood (computed
    here in numpy, float64) has its two smallest eigenvalues more than 5 %
    of the largest apart — elsewhere the smallest eigenvector is not
    determined by the data and any rounding may turn it;
  * the registration of a synthetic scan pair through voxel covariances
    within 2.5° / 0.2 m of ground truth (this stands in for
    ``tests/test_voxel_covs.py:29,55``, whose real pair is not bundled).
"""

import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.voxel_covs import voxelgrid_sampling_with_covs as j_voxel_covs
from small_gicp_tpu.point_cloud import PointCloud as JCloud
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.models.registration import Registration
from small_gicp_tpu_torch.ops.voxel_covs import voxelgrid_sampling_with_covs
from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.utils.lie import rotation_error_deg
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

TOL = {np.float64: (1e-12, 1e-9), np.float32: (1e-6, 1e-4)}


def _plane(rng):
    g = rng.uniform(-5, 5, size=(20000, 2))
    normal = np.asarray([0.2, -0.3, 1.0])
    normal /= np.linalg.norm(normal)
    basis = np.linalg.svd(normal[None, :])[2][1:]
    return g @ basis + rng.normal(scale=0.002, size=(20000, 1)) * normal, normal


def _far_patch(rng):
    n = 4000
    g = rng.uniform(-4, 4, size=(n, 2))
    pts = np.c_[g[:, 0], g[:, 1], 0.02 * rng.normal(size=n)]
    return pts + np.array([300.0, -250.0, 80.0])


def _well_conditioned(pts, means, leaf):
    """[V] bool: the voxel's 27-neighbourhood has its two smallest eigenvalues
    more than 5 % of the largest apart (and at least 5 points)."""
    vc = np.floor(pts / leaf)
    out = []
    for c in np.floor(means / leaf):
        p = pts[np.all(np.abs(vc - c) <= 1, axis=1)]
        if len(p) < 5:
            out.append(False)
            continue
        ev = np.linalg.eigvalsh(np.cov(p.T, bias=True))
        out.append(ev[1] - ev[0] > 0.05 * ev[2])
    return np.array(out)


def _compare(pts, dtype, leaf, max_points):
    jc = JCloud.from_points(pts.astype(dtype))
    want = j_voxel_covs(jc, leaf, max_points, need_normals=True)
    got = voxelgrid_sampling_with_covs(
        cloud_from_numpy(np.asarray(jc.points), len(pts), device="cpu"), leaf, max_points,
        need_normals=True)
    p_tol, c_tol = TOL[dtype]
    n = int(got.num_points)
    assert got.num_points.dtype == torch.int32 and n == int(want.num_points)
    assert got.points.shape == (max_points, 4) and got.covs.shape == (max_points, 3, 3)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0,
                               atol=p_tol)
    ok = _well_conditioned(pts, np.asarray(want.points[:n, :3], np.float64), leaf)
    assert ok.any()
    np.testing.assert_allclose(got.covs.numpy()[:n][ok], np.asarray(want.covs)[:n][ok],
                               atol=c_tol)
    np.testing.assert_allclose(got.normals.numpy()[:n][ok],
                               np.asarray(want.normals)[:n][ok], atol=c_tol)
    # Padding rows: the sentinel point, identity covariance, zero normal.
    np.testing.assert_array_equal(got.covs.numpy()[n:], np.asarray(want.covs)[n:])
    np.testing.assert_array_equal(got.normals.numpy()[n:], 0.0)
    return got, ok


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plane_matches_jax(dtype):
    pts, normal = _plane(np.random.default_rng(0))
    got, ok = _compare(pts, dtype, 0.5, 2048)
    assert ok.mean() > 0.95
    nrm = got.normals.numpy()[: int(got.num_points), :3]
    assert np.quantile(np.abs(nrm @ normal), 0.05) > 0.999


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_far_from_origin_matches_jax(dtype):
    """Centred moments keep the surface 300 m out: eigenvalues ≈ (1e-3, 1, 1)
    and normals along z (``tests/test_voxel_covs.py:68``)."""
    got, ok = _compare(_far_patch(np.random.default_rng(1)), dtype, 0.5, 512)
    m = int(got.num_points)
    assert m > 50 and ok.mean() > 0.95
    ev = np.linalg.eigvalsh(got.covs.numpy()[:m].astype(np.float64))
    assert np.all(ev[:, 0] > 5e-4) and np.all(ev[:, 2] < 1.5)
    normals = got.normals.numpy()[:m, :3].astype(np.float64)
    valid = np.linalg.norm(normals, axis=1) > 0.5
    assert valid.mean() > 0.8 and np.quantile(np.abs(normals[valid, 2]), 0.1) > 0.95


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_max_points_above_capacity_matches_jax(dtype):
    pts = np.random.default_rng(2).uniform(-3, 3, size=(200, 3))
    got, _ = _compare(pts, dtype, 0.5, 512)
    assert int(got.num_points) <= 200
    assert got.normals is not None and voxelgrid_sampling_with_covs(
        PointCloud.from_points(pts.astype(dtype), device="cpu"), 0.5, 512).normals is None


def test_registration_through_voxel_covariances():
    scans, poses = generate_sequence(n_frames=2, rings=32, azimuth_steps=512, frame_dist=0.5)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    target, source = (voxelgrid_sampling_with_covs(
        PointCloud.from_points(s.astype(np.float32), device="cpu"), 0.4, 8192) for s in scans)
    result = Registration("gicp").align(target, source)
    T = result.T_target_source.to(torch.float64)
    assert float(rotation_error_deg(T[:3, :3], torch.from_numpy(T_gt[:3, :3]))) < 2.5
    T = T.numpy()
    assert np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 0.2
