"""The port's Morton codes and Morton-banded kNN searches
(``ops/knn_window.py``) against the JAX package on the CPU.

Shapes are those of ``tests/test_knn_window.py`` (2,048-point LiDAR-like
clouds, k = 20 self-search; 512 queries at k = 10; 7 points in 64 rows;
``KdTree`` over 1,024 points at k = 5), so that JAX's persistent
compilation cache serves the oracle runs. Tolerances:
  * ``morton_codes``: integer-exact, out-of-range and non-finite rows
    included, in float64 and float32;
  * float64 searches: indices equal, d² within 1e-12;
  * float32 searches: d² within rtol 1e-6; indices equal on every row whose
    returned distances lie more than that band apart (the two packages sum
    dx² + dy² + dz² in their own order, which may swap two candidates
    closer than that);
  * set recall ≥ 0.97 against the exact search (the JAX contract) and the
    padding rules of ``tests/test_knn_window.py:78-89``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops import knn_window as jkw
from small_gicp_tpu.ops.knn import KdTree as JKdTree
from small_gicp_tpu.ops.normals import _estimate_impl as j_estimate
from small_gicp_tpu.point_cloud import PointCloud as JCloud
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.ops import knn_window as tkw
from small_gicp_tpu_torch.ops.knn import KdTree, brute_force_knn
from small_gicp_tpu_torch.ops.normals import _estimate_impl


def _lidar_like_scan(rng, n=4096, extent=40.0):
    """``tests/test_knn_window.py``'s ground plane, walls and jitter."""
    ground = rng.uniform(-extent, extent, size=(n // 2, 3))
    ground[:, 2] = rng.normal(scale=0.05, size=n // 2)
    wall = rng.uniform(-extent, extent, size=(n // 2, 3))
    wall[:, 0] = extent * np.sign(wall[:, 0])
    pts = np.concatenate([ground, wall])[:n]
    return pts + rng.normal(scale=0.02, size=pts.shape)


def _both(pts, dtype, capacity=None):
    jc = JCloud.from_points(pts.astype(dtype), capacity=capacity)
    return jc, cloud_from_numpy(np.asarray(jc.points), len(pts), device="cpu")


def _agree(d, i, jd, ji, dtype):
    jd, ji = np.asarray(jd), np.asarray(ji)
    d, i = d.numpy(), i.numpy()
    assert i.dtype == np.int32 and d.dtype == jd.dtype
    assert np.array_equal(np.isfinite(d), np.isfinite(jd))
    f = np.isfinite(jd)
    if dtype == np.float64:
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(d[f], jd[f], rtol=0, atol=1e-12)
        return
    np.testing.assert_allclose(d[f], jd[f], rtol=1e-6, atol=0)
    fin = np.where(f, jd, 0.0)
    gaps = np.diff(fin, axis=1) > 1e-6 * np.maximum(fin[:, 1:], 1e-30)
    clear = np.all(gaps | ~f[:, 1:], axis=1)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(i[clear], ji[clear])


def _recall(i, i_ref, m):
    q = i.shape[0]
    tags = i.astype(np.int64) + np.arange(q)[:, None] * m
    tags_ref = i_ref.astype(np.int64) + np.arange(q)[:, None] * m
    return np.isin(tags_ref, tags).mean()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_morton_codes_integer_exact(dtype):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-10, 10, size=(512, 3)),
                        rng.uniform(-1e6, 1e6, size=(256, 3)),  # 2^20 cells: out of range
                        rng.uniform(-3e5, 3e5, size=(256, 3))]).astype(dtype)
    x[::7, 0] = np.nan
    x[::11, 1] = np.inf
    x[::13, 2] = -np.inf
    x[5] = [1e30, 0, 0]
    for cell in (0.25, 0.3, 1.0):
        want = np.asarray(jkw.morton_codes(jnp.asarray(x), cell))
        got = tkw.morton_codes(torch.from_numpy(x), cell).numpy()
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        assert np.all(got[::7] == np.iinfo(np.int64).max)
        assert (got == np.iinfo(np.int64).max).sum() > 100


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_knn_windowed_matches_jax(dtype):
    rng = np.random.default_rng(0)
    pts = _lidar_like_scan(rng, n=2048)
    jc, tc = _both(pts, dtype)
    jd, ji = jkw.knn_windowed(jc.points, jc.num_points, 20)
    d, i = tkw.knn_windowed(tc.points, tc.num_points, 20)
    _agree(d, i, jd, ji, dtype)
    n = len(pts)
    # Every point finds itself at 0, ascending, and the exact lists' recall.
    assert np.array_equal(i[:, 0].numpy(), np.arange(n))
    assert np.all(np.diff(d.numpy(), axis=1) >= 0)
    _, i_ref = brute_force_knn(tc.points[:, :3], tc.points[:, :3], 20)
    assert _recall(i.numpy(), i_ref.numpy(), n) > 0.97


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_knn_windowed_query_matches_jax(dtype):
    rng = np.random.default_rng(4)
    tgt = _lidar_like_scan(rng, n=2048)
    qry = _lidar_like_scan(rng, n=512) + rng.normal(scale=0.1, size=(512, 3))
    jc, tc = _both(tgt, dtype)
    jd, ji = jkw.knn_windowed_query(jc.points, jc.num_points, jnp.asarray(qry.astype(dtype)), 10)
    q = torch.from_numpy(qry.astype(dtype))
    d, i = tkw.knn_windowed_query(tc.points, tc.num_points, q, 10)
    _agree(d, i, jd, ji, dtype)
    _, i_ref = brute_force_knn(tc.points[:, :3], q, 10)
    assert _recall(i.numpy(), i_ref.numpy(), len(tgt)) > 0.97
    for row in i.numpy()[np.all(np.isfinite(d.numpy()), axis=1)]:
        assert len(set(row.tolist())) == len(row)


def test_knn_windowed_padding_and_small_clouds():
    """``tests/test_knn_window.py:78-89``: 7 points in 64 rows, k = 10."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, size=(7, 3))
    jc, tc = _both(pts, np.float64, capacity=64)
    d, i = tkw.knn_windowed(tc.points, tc.num_points, 10, window=16)
    jd, ji = jkw.knn_windowed(jc.points, jc.num_points, 10, window=16)
    _agree(d, i, jd, ji, np.float64)
    d = d.numpy()
    assert np.all(np.isfinite(d[:7, :7]))
    assert np.all(~np.isfinite(d[:7, 7:]))
    assert np.all(~np.isfinite(d[7:]))
    d_ref, _ = brute_force_knn(tc.points[:7, :3], tc.points[:7, :3], 7)
    np.testing.assert_allclose(d[:7, :7], d_ref.numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="shifts"):
        tkw.knn_windowed(tc.points, tc.num_points, 10, shifts=7)
    with pytest.raises(ValueError, match="exceeds"):
        tkw.knn_windowed(tc.points, tc.num_points, 40, window=2, shifts=4)


def test_kdtree_window_method_matches_jax():
    """``KdTree.knn_search(method="window")`` on both packages, and its
    agreement with the exact search (``tests/test_knn_window.py:121``)."""
    rng = np.random.default_rng(5)
    tgt = _lidar_like_scan(rng, n=1024)
    qry = tgt[rng.integers(0, 1024, size=256)] + rng.normal(scale=0.05, size=(256, 3))
    jtree = JKdTree.build(tgt)
    tree = KdTree.build(tgt, device="cpu")
    jd, ji = jtree.knn_search(jnp.asarray(qry), 5, method="window")
    d, i = tree.knn_search(qry, 5, method="window")
    _agree(d, i, jd, ji, np.float64)
    _, i_e = tree.knn_search(qry, 5)
    assert (i == i_e).float().mean() > 0.97
    jd1, ji1 = jtree.knn_search(jnp.asarray(qry[0]), 5, method="window", window_cell=0.5)
    d1, i1 = tree.knn_search(qry[0], 5, method="window", window_cell=0.5)
    assert d1.shape == (5,)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))


def test_window_neighbor_mode_matches_jax():
    """``_estimate_impl(neighbor_mode="window")``: the windowed lists' moments
    in both packages (covariances within 1e-9 in float64), and close to the
    exact covariances as ``tests/test_knn_window.py:51`` bounds them."""
    rng = np.random.default_rng(1)
    pts = _lidar_like_scan(rng, n=2048)
    jc, tc = _both(pts, np.float64)
    jn, jcov = j_estimate(jc.points, jc.num_points, 20, True, True, neighbor_mode="window")
    n_w, c_w = _estimate_impl(tc.points, tc.num_points, 20, True, True, "window")
    np.testing.assert_allclose(c_w.numpy(), np.asarray(jcov), atol=1e-9)
    np.testing.assert_allclose(n_w.numpy(), np.asarray(jn), atol=1e-9)
    _, c_e = _estimate_impl(tc.points, tc.num_points, 20, False, True, "exact")
    ce, cw = c_e.numpy(), c_w.numpy()
    rel = np.linalg.norm(ce - cw, axis=(1, 2)) / np.maximum(np.linalg.norm(ce, axis=(1, 2)),
                                                            1e-12)
    assert np.median(rel) < 1e-6
    assert np.mean(rel < 0.05) > 0.99
