"""The port's neighbour-search API and the paths behind it, on the CPU
against the JAX package: the ``KdTree`` methods and covariances through
the searched route (k > 64, float64).

Searches are compared in float64 where the JAX CPU path is the oracle: it
ranks by the centred |q|² − 2q·t + |t|² form, whose float32 rounding can
reorder near-tied neighbours; in float64 both pick the same rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.knn import KdTree as JKdTree
from small_gicp_tpu.ops.normals import estimate_covariances as j_covariances
from small_gicp_tpu.point_cloud import PointCloud as JCloud
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.ops.knn_cuda import knn_plain
from small_gicp_tpu_torch.ops.normals import estimate_covariances, estimate_normals
from small_gicp_tpu_torch.utils.synthetic import generate_sequence


@pytest.fixture(scope="module")
def clouds():
    """A 1,200-point surface in a 1,300-row table, float64, in both packages,
    and 300 queries."""
    rng = np.random.default_rng(17)
    tp = rng.uniform(-15, 15, size=(1200, 3))
    tp[:, 2] = np.sin(tp[:, 0] * 0.5) + 0.05 * rng.normal(size=1200)
    q = tp[rng.permutation(1200)[:300]] + rng.normal(scale=0.05, size=(300, 3))
    jc = JCloud.from_points(tp, capacity=1300)
    tc = cloud_from_numpy(np.asarray(jc.points), 1200, device="cpu")
    return tp, q, JKdTree.build(jc), KdTree.build(tc)


@pytest.mark.parametrize("k", [1, 8, 80])
def test_kdtree_knn_search_matches_jax(clouds, k):
    _, q, jtree, tree = clouds
    jd, ji = jtree.knn_search(jnp.asarray(q), k)
    d, i = tree.knn_search(q, k)
    assert i.dtype == torch.int32 and d.dtype == torch.float64
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-9, atol=1e-9)
    # A smaller query block gives the same rows.
    d2, i2 = tree.knn_search(q, k, block=64)
    assert torch.equal(i2, i) and torch.equal(d2, d)


def test_kdtree_single_query_aliases_and_methods(clouds):
    _, q, jtree, tree = clouds
    jd, ji = jtree.knn_search(jnp.asarray(q[3]), 5)
    d, i = tree.knn_search(q[3], 5)
    assert d.shape == (5,) and i.shape == (5,)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    jd1, ji1 = jtree.nearest_neighbor_search(jnp.asarray(q))
    d1, i1 = tree.nearest_neighbor_search(q)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd1), rtol=1e-9, atol=1e-9)
    ds, is_ = tree.nearest_neighbor_search(q[3])
    assert ds.shape == () and int(is_) == int(i[0])
    # The names of the reference's Python bindings.
    db, ib = tree.batch_knn_search(q, 5, num_threads=4)
    jdb, jib = jtree.batch_knn_search(jnp.asarray(q), 5, num_threads=4)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(jib))
    dn, inn = tree.batch_nearest_neighbor_search(q, num_threads=4)
    assert torch.equal(inn, i1) and torch.equal(dn, d1)
    with pytest.raises(ValueError, match="unknown method"):
        tree.knn_search(q, 5, method="approximate")
    with pytest.raises(ValueError, match="unknown method"):
        jtree.knn_search(jnp.asarray(q), 5, method="approximate")
    # The window method in both packages (float64: the same rows).
    jdw, jiw = jtree.knn_search(jnp.asarray(q), 5, method="window", window_cell=0.5)
    dw, iw = tree.knn_search(q, 5, method="window", window_cell=0.5)
    assert iw.dtype == torch.int32
    np.testing.assert_array_equal(iw.numpy(), np.asarray(jiw))
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=0, atol=1e-12)


def test_kdtree_float32_matches_the_plain_kernels(clouds):
    """A float32 tree on the CPU searches by the same difference form as the
    kernels' plain versions: the rows a card would return."""
    tp, q, _, _ = clouds
    cloud = cloud_from_numpy(
        np.asarray(JCloud.from_points(tp.astype(np.float32), capacity=1300).points),
        1200, device="cpu")
    tree = KdTree.build(cloud)
    tq = torch.as_tensor(q, dtype=torch.float32)
    d, i = tree.knn_search(tq, 10)
    dp, ip = knn_plain(cloud.points, cloud.num_points, tq, 10)
    assert torch.equal(i, ip) and torch.equal(d, dp)
    built = KdTree.build(tp.astype(np.float32), num_threads=2, device="cpu")
    assert torch.equal(built.knn_search(tq, 10)[1], i)


@pytest.mark.parametrize("case", ["k80_float32", "k10_float64", "k80_float64"])
def test_searched_covariances_match_jax(case):
    """k > 64 and float64 clouds leave the fused moments kernel for
    ``KdTree.knn_search`` + moment sums, in both packages."""
    k = 80 if case.startswith("k80") else 10
    dtype = np.float32 if case.endswith("32") else np.float64
    scans, _ = generate_sequence(n_frames=1, rings=16, azimuth_steps=256)
    jc = JCloud.from_points(scans[0][:2500].astype(dtype), capacity=2600)
    want = np.asarray(j_covariances(jc, num_neighbors=k).covs)
    cloud = cloud_from_numpy(np.asarray(jc.points), 2500, device="cpu")
    got = estimate_covariances(cloud, num_neighbors=k).covs
    assert got.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
    diff = np.abs(got.numpy() - want).max(axis=(1, 2))
    if dtype == np.float64:
        assert diff.max() <= 1e-6
    else:
        # float32: the JAX search ranks by the expanded form, so a near-tied
        # 80th neighbour can differ, and a near-degenerate eigenvector turn.
        assert np.mean(diff <= 1e-3) >= 0.99
    np.testing.assert_array_equal(got.numpy()[2500:], np.broadcast_to(
        np.eye(3, dtype=dtype), (100, 3, 3)))
    with pytest.raises(ValueError, match="fused"):
        from small_gicp_tpu_torch.ops.normals import _estimate_impl

        _estimate_impl(cloud.points, cloud.num_points, k if k > 64 else 65, True,
                       False, neighbor_mode="fused")


def test_neighbor_mode_rules():
    from small_gicp_tpu_torch.ops.normals import _estimate_impl

    scans, _ = generate_sequence(n_frames=1, rings=16, azimuth_steps=256)
    cloud = cloud_from_numpy(
        np.asarray(JCloud.from_points(scans[0][:800], capacity=800).points), 800,
        device="cpu")
    # "window": the windowed lists' normals and covariances, against JAX's.
    from small_gicp_tpu.ops.normals import _estimate_impl as j_estimate

    jn, jc = j_estimate(jnp.asarray(cloud.points.numpy()), jnp.int32(800), 10, True, True,
                        neighbor_mode="window", window_cell=0.5)
    wn, wc = _estimate_impl(cloud.points, cloud.num_points, 10, True, True, "window", 0.5)
    assert wn.dtype == torch.float32 and wc.shape == (800, 3, 3)
    np.testing.assert_allclose(wc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_allclose(wn.numpy(), np.asarray(jn), atol=1e-4)
    with pytest.raises(ValueError, match="unknown neighbor_mode"):
        _estimate_impl(cloud.points, cloud.num_points, 10, True, True, "nearest")
    # float32, k ≤ 64: "exact" is the fused route.
    a, _ = _estimate_impl(cloud.points, cloud.num_points, 10, True, False, "exact")
    b, _ = _estimate_impl(cloud.points, cloud.num_points, 10, True, False, "fused")
    assert torch.equal(a, b)
    assert torch.equal(estimate_normals(cloud, num_neighbors=10).normals, a)
