"""The port's ``ProjectiveSearch`` (``ops/projective_search.py``) and its use
as the searcher of a registration, against the JAX package on the CPU.

Shapes are those of ``tests/test_projective_search.py`` (a 32-beam ×
512-step ring scan of 16,384 points in a 512 × 64 image; 500 perturbed
queries for NN, 100 for kNN at k = 5). Tolerances:
  * the index image equal to the JAX package's on a cloud whose points sit
    at pixel centres (with several points on one pixel: the last writer,
    the highest row id, wins): a point at a pixel's edge may land on either
    side in the two packages, whose atan2 / asin differ in the last ulp;
  * NN and kNN of queries at pixel centres: ``found`` and indices equal,
    and d² within rtol 1e-6 where found (XLA sums dx² + dy² + dz² in its
    own order: an ulp apart in a fifth of the rows);
  * the hit rate of perturbed queries ≥ 0.95 with near-optimal distances
    (``tests/test_projective_search.py:52-67``);
  * GICP of a synthetic scan pair through ``Registration(...).align(target,
    source, ProjectiveSearch)`` in both packages, on the same preprocessed
    clouds: translations within 2 × ``translation_eps`` (2e-3 m) of each
    other and the pose within 2.5° / 0.2 m of ground truth.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.models.registration import Registration as JRegistration
from small_gicp_tpu.ops.projective_search import ProjectiveSearch as JProjective
from small_gicp_tpu.point_cloud import PointCloud as JCloud
import small_gicp_tpu_torch as pt
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.models.registration import Registration
from small_gicp_tpu_torch.ops.knn import brute_force_knn
from small_gicp_tpu_torch.ops.projective_search import ProjectiveSearch
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

W, H, VFOV = 512, 64, 2.0944


def _lidar_scan(rng, n_beams=32, n_az=512):
    """``tests/test_projective_search.py``'s ring scan."""
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    el = np.linspace(-0.4, 0.4, n_beams)
    a, e = np.meshgrid(az, el)
    r = 10.0 + rng.normal(scale=0.5, size=a.shape)
    return np.stack([r * np.cos(e) * np.cos(a), r * np.cos(e) * np.sin(a), r * np.sin(e)],
                    -1).reshape(-1, 3)


def _pixel_centres(rng, n, rows=(8, 56)):
    """n points at the centres of random pixels (repeats included), 5-30 m
    out."""
    u = rng.integers(0, W, size=n)
    v = rng.integers(rows[0], rows[1], size=n)
    az = (u + 0.5) / W * 2.0 * np.pi - np.pi
    el = ((v + 0.5) / H - 0.5) * VFOV
    r = rng.uniform(5.0, 30.0, size=n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el)], -1).astype(np.float32)


def _both(pts):
    jc = JCloud.from_points(pts.astype(np.float32))
    return jc, cloud_from_numpy(np.asarray(jc.points), len(pts), device="cpu")


@pytest.fixture(scope="module")
def centred():
    rng = np.random.default_rng(7)
    pts = _pixel_centres(rng, 16384)
    pts[-40:] = pts[:40] * 1.5  # 40 more pixels with two writers
    jc, tc = _both(pts)
    return pts, JProjective.build(jc, width=W, height=H), ProjectiveSearch.build(
        tc, width=W, height=H)


def test_index_image_equals_jax(centred):
    pts, jps, tps = centred
    img = tps.index_image.numpy()
    assert img.dtype == np.int32 and img.shape == (H, W)
    np.testing.assert_array_equal(img, np.asarray(jps.index_image))
    # Last writer wins: row i and row 16344 + i share a pixel for i < 40.
    flat = img.reshape(-1)
    assert np.all(np.isin(np.arange(16344, 16384), flat))
    assert not np.any(np.isin(np.arange(40), flat))
    assert tps.width == W and tps.window_h == 10 and tps.vertical_fov == VFOV


def test_nn_and_knn_equal_jax(centred):
    _, jps, tps = centred
    q = _pixel_centres(np.random.default_rng(8), 2048, rows=(0, 64))
    jd, ji, jf = (np.asarray(a) for a in jps.nearest_neighbor_search(jnp.asarray(q)))
    d, i, f = (a.numpy() for a in tps.nearest_neighbor_search(torch.from_numpy(q)))
    assert i.dtype == np.int32 and f.dtype == bool
    np.testing.assert_array_equal(f, jf)
    assert f.mean() > 0.9
    np.testing.assert_array_equal(i[f], ji[f])
    np.testing.assert_allclose(d[f], jd[f], rtol=1e-6, atol=0)
    jd, ji, jf = (np.asarray(a) for a in jps.knn_search(jnp.asarray(q), 5))
    d, i, f = (a.numpy() for a in tps.knn_search(torch.from_numpy(q), 5))
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(i[f], ji[f])
    np.testing.assert_allclose(d[f], jd[f], rtol=1e-6, atol=0)
    assert np.all(np.diff(d, axis=1) >= 0)


def test_hit_rate_and_self_queries():
    """``tests/test_projective_search.py:29-77`` on the port."""
    rng = np.random.default_rng(0)
    pts = _lidar_scan(rng)
    _, tc = _both(pts)
    ps = ProjectiveSearch.build(tc, width=W, height=H)
    q = pts[rng.choice(len(pts), 500, replace=False)]
    q = torch.from_numpy((q + rng.normal(scale=0.05, size=q.shape)).astype(np.float32))
    d2, _, found = ps.nearest_neighbor_search(q)
    d_ref, _ = brute_force_knn(tc.points[:, :3], q, 1)
    found = found.numpy()
    assert found.mean() > 0.95
    assert ((d2.numpy() - d_ref[:, 0].numpy())[found] <= 0.25).mean() > 0.95
    # Self-queries: every survivor of the fill finds itself.
    d2, _, found = ps.nearest_neighbor_search(tc.points[:len(pts), :3])
    img = ps.index_image.reshape(-1)
    survivors = img[img >= 0].long()
    assert bool(found.all()) and float(d2[survivors].abs().max()) <= 1e-8
    d2, _, _ = ps.knn_search(tc.points[:100, :3] + 0.01, 5)
    assert d2.shape == (100, 5) and bool((d2[:, 1:] >= d2[:, :-1]).all())


def test_registration_through_projective_search_matches_jax():
    scans, poses = generate_sequence(n_frames=2, rings=32, azimuth_steps=512, frame_dist=0.5)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    target, _ = pt.preprocess_points(scans[0].astype(np.float32), 0.4, num_neighbors=10,
                                     max_points=8192, device="cpu")
    source, _ = pt.preprocess_points(scans[1].astype(np.float32), 0.4, num_neighbors=10,
                                     max_points=8192, device="cpu")
    result = Registration(registration_type="gicp").align(
        target, source, ProjectiveSearch.build(target), None)
    jt, js = (JCloud(points=jnp.asarray(c.points.numpy()),
                     num_points=jnp.asarray(int(c.num_points), jnp.int32),
                     covs=jnp.asarray(c.covs.numpy())) for c in (target, source))
    j_result = JRegistration(registration_type="gicp").align(
        jt, js, JProjective.build(jt), None)
    T = result.T_target_source.numpy().astype(np.float64)
    jT = np.asarray(j_result.T_target_source, np.float64)
    assert bool(result.converged) and bool(j_result.converged)
    assert np.linalg.norm(T[:3, 3] - jT[:3, 3]) < 2e-3
    cos = (np.trace(T[:3, :3].T @ T_gt[:3, :3]) - 1) / 2
    assert math.degrees(math.acos(min(1.0, max(-1.0, cos)))) < 2.5
    assert np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 0.2
