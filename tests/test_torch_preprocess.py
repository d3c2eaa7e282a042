"""Port parity of scan preprocessing: voxelgrid downsampling, the plain
version of the kNN-moments kernel (K3) against the Pallas kernel in
interpret mode, and normals / covariances against the JAX estimator.

One 16-ring × 256-step synthetic frame (≈3.8k points) feeds every test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.cov_fused_pallas import knn_moments_pallas
from small_gicp_tpu.ops.downsampling import voxelgrid_sampling as j_voxelgrid
from small_gicp_tpu.ops.normals import estimate_normals_covariances as j_estimate
from small_gicp_tpu.point_cloud import PointCloud as JCloud
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.ops.cov_fused_cuda import knn_moments
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.normals import estimate_normals_covariances
from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.utils.synthetic import generate_sequence


@pytest.fixture(scope="module")
def frame():
    scans, _ = generate_sequence(n_frames=1, rings=16, azimuth_steps=256)
    return scans[0]


def _j_down(frame, dtype, leaf=0.25, max_points=None):
    return j_voxelgrid(JCloud.from_points(frame.astype(dtype)), leaf,
                       max_points=max_points)


def test_voxelgrid_matches_jax(frame):
    for dtype, max_points in [(np.float32, None), (np.float64, None),
                              (np.float32, 1500)]:
        _check_voxelgrid(frame, dtype, max_points)


def _check_voxelgrid(frame, dtype, max_points):
    jd = _j_down(frame, dtype, max_points=max_points)
    td = voxelgrid_sampling(frame.astype(dtype), 0.25, max_points=max_points,
                            device="cpu")
    n = int(jd.num_points)
    assert int(td.num_points) == n
    if max_points is not None:
        assert n == max_points  # more voxels than rows: lowest keys kept
    assert td.capacity == jd.capacity
    # Same voxels in the same (key) order; the means differ only by the
    # rounding of the float32 vs float64 segment sums.
    np.testing.assert_allclose(td.points.numpy()[:n], np.asarray(jd.points)[:n],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(td.points.numpy()[n:], np.asarray(jd.points)[n:])


def test_knn_moments_plain_matches_pallas_interpret(frame):
    jd = _j_down(frame, np.float32)
    n = int(jd.num_points)
    jm1, jm2, jc = knn_moments_pallas(jd.points, jd.num_points, 10,
                                      interpret=True, layout="t")
    td = cloud_from_numpy(np.asarray(jd.points), n, device="cpu")
    m1, m2, c = knn_moments(td.points, td.num_points, 10)
    # Same exact-kNN membership (difference-form d², ties to the lower
    # row), so counts agree exactly and the float32 moment sums agree to
    # their rounding (tolerances as tests/test_normals.py uses them).
    np.testing.assert_array_equal(c.numpy()[:n], np.asarray(jc)[:n])
    np.testing.assert_allclose(m1.numpy()[:n], np.asarray(jm1)[:n], atol=1e-4)
    np.testing.assert_allclose(m2.numpy()[:n], np.asarray(jm2)[:n], atol=1e-3)
    assert np.all(c.numpy()[n:] == 0)


def test_knn_moments_small_cloud_counts():
    # Fewer valid rows than k: the missing neighbours count as invalid.
    pts = np.zeros((8, 4), np.float32)
    pts[:3, :3] = [[0, 0, 0], [1, 0, 0], [0, 2, 0]]
    pts[:3, 3] = 1.0
    pts[3:, :3] = 1e9
    cloud = cloud_from_numpy(pts, 3, device="cpu")
    m1, m2, c = knn_moments(cloud.points, cloud.num_points, 5)
    np.testing.assert_array_equal(c.numpy(), [3, 3, 3, 0, 0, 0, 0, 0])
    np.testing.assert_allclose(m1.numpy()[0], [1.0, 2.0, 0.0])
    np.testing.assert_allclose(m2.numpy()[1][0, 0], 1.0 + 1.0)


def test_normals_covariances_match_jax(frame):
    # float64 on both sides: the JAX CPU path searches with the centred
    # |q|²−2q·t+|t|² form, whose float32 rounding would reorder near-tied
    # kth neighbours; in float64 both searches pick the same sets.
    jd = _j_down(frame, np.float64)
    n = int(jd.num_points)
    jc = j_estimate(jd, num_neighbors=10)
    tc = estimate_normals_covariances(
        cloud_from_numpy(np.asarray(jd.points), n, device="cpu"), num_neighbors=10)
    np.testing.assert_allclose(tc.normals.numpy(), np.asarray(jc.normals),
                               atol=1e-6)
    np.testing.assert_allclose(tc.covs.numpy(), np.asarray(jc.covs), atol=1e-6)
    assert np.all(tc.normals.numpy()[n:] == 0.0)


def test_preprocess_points_matches_jax_preprocess(frame):
    from small_gicp_tpu.models.helper import preprocess_points as j_pre
    from small_gicp_tpu_torch.models.helper import preprocess_points

    jcloud, _ = j_pre(frame.astype(np.float64), 0.25, num_neighbors=10)
    tcloud, tree = preprocess_points(frame.astype(np.float64), 0.25,
                                     num_neighbors=10, device="cpu")
    n = int(jcloud.num_points)
    assert int(tcloud.num_points) == n
    np.testing.assert_allclose(tcloud.points.numpy(), np.asarray(jcloud.points),
                               atol=1e-9)
    np.testing.assert_allclose(tcloud.covs.numpy(), np.asarray(jcloud.covs),
                               atol=1e-6)
    assert tree.points is tcloud.points


def test_point_cloud_from_points_layout():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    c = PointCloud.from_points(x, capacity=6, device="cpu")
    assert c.capacity == 6 and int(c.num_points) == 4 and len(c) == 4
    np.testing.assert_array_equal(c.points.numpy()[:4, :3], x)
    np.testing.assert_array_equal(c.points.numpy()[:, 3], [1, 1, 1, 1, 0, 0])
    assert np.all(c.points.numpy()[4:, :3] == 1e9)
    np.testing.assert_array_equal(c.valid_mask().numpy(), [1, 1, 1, 1, 0, 0])
    with pytest.raises(ValueError):
        PointCloud.from_points(x, capacity=2, device="cpu")
    j = JCloud.from_points(x, capacity=6)
    np.testing.assert_array_equal(c.points.numpy(), np.asarray(j.points))
    assert jnp.asarray(j.num_points) == int(c.num_points)
    assert torch.equal(c.points, cloud_from_numpy(np.asarray(j.points), 4,
                                                  device="cpu").points)


def test_kdtree_search_matches_jax_brute_force(frame):
    from small_gicp_tpu.ops.knn import brute_force_knn
    from small_gicp_tpu_torch.ops.knn import KdTree
    from small_gicp_tpu_torch.point_cloud import transform_points
    from small_gicp_tpu.point_cloud import transform_points as j_transform

    jd = _j_down(frame, np.float64)
    tree = KdTree.build(cloud_from_numpy(np.asarray(jd.points), int(jd.num_points),
                                         device="cpu"))
    q = frame[::7].astype(np.float64) + 0.05
    d, i = tree.knn_search(q, 8)
    jd2, ji = brute_force_knn(jd.points[:, :3], jnp.asarray(q), 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd2), rtol=1e-9, atol=1e-9)
    d1, i1 = tree.nearest_neighbor_search(q[0])
    assert int(i1) == int(ji[0, 0]) and abs(float(d1) - float(jd2[0, 0])) < 1e-9
    T = np.eye(4)
    T[:3, 3] = [1.0, -2.0, 0.5]
    np.testing.assert_allclose(
        transform_points(torch.as_tensor(T), tree.points).numpy(),
        np.asarray(j_transform(jnp.asarray(T), jd.points)))


def test_single_output_estimators_match_the_joint_one(frame):
    from small_gicp_tpu_torch.ops.normals import estimate_covariances, estimate_normals

    jd = _j_down(frame, np.float64)
    cloud = cloud_from_numpy(np.asarray(jd.points), int(jd.num_points), device="cpu")
    both = estimate_normals_covariances(cloud, num_neighbors=10)
    assert torch.equal(estimate_normals(cloud, num_neighbors=10).normals, both.normals)
    assert torch.equal(estimate_covariances(cloud, num_neighbors=10).covs, both.covs)
