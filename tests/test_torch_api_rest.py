"""The core API's remaining names in the port against the JAX package on the
CPU: the per-point factors (``error``, ``linearize_per_point``, the factor
classes, their single-index form and its guards, ``DistanceRejector``),
``random_sampling``, the Jacobi ``eigh3x3``, ``PointCloud``'s host
accessors, ``.replace`` on the result types and ``brute_force_knn_numpy``.

The pair is the 16-ring × 256-step synthetic pair of
``tests/test_torch_unfused.py``, preprocessed once by the JAX package
(0.25 m voxels, k = 10) and taken to float64 in both packages, so that the
searches find the same rows and the per-point systems agree to rtol 1e-9;
in float32 the inliers are JAX's and the per-point sums the unfused
route's to 1e-5 relative. ``random_sampling`` draws from a
``torch.Generator`` where JAX takes a PRNG key, so it is held by count,
membership, no repeats and determinism, not against JAX's rows.
"""

import jax
import numpy as np
import pytest
import torch

import small_gicp_tpu as sgt
from small_gicp_tpu.models import factors as j_factors
from small_gicp_tpu.models.registration import _search_correspondences as j_search
from small_gicp_tpu.ops.eigh3 import eigh3x3 as j_eigh3x3
from small_gicp_tpu.ops.knn import brute_force_knn_numpy as j_brute
import small_gicp_tpu_torch as pt
from small_gicp_tpu_torch.models import factors
from small_gicp_tpu_torch.models.registration import search_correspondences
from small_gicp_tpu_torch.ops.eigh3 import eigh3x3
from small_gicp_tpu_torch.ops.knn import KdTree, brute_force_knn_numpy
from small_gicp_tpu_torch.ops.projective_search import ProjectiveSearch
from small_gicp_tpu_torch.utils.lie import se3_exp
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

CLASSES = ["ICPFactor", "PointToPlaneICPFactor", "GICPFactor"]


def _to_torch(jcloud):
    return pt.cloud_from_numpy(
        np.asarray(jcloud.points), int(jcloud.num_points),
        normals=np.asarray(jcloud.normals), covs=np.asarray(jcloud.covs), device="cpu")


@pytest.fixture(scope="module")
def pair():
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    rng = np.random.default_rng(11)
    tw = np.r_[rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.2]
    init = T_gt @ se3_exp(torch.as_tensor(tw)).numpy()
    jt, _ = sgt.preprocess_points(scans[0], 0.25, num_neighbors=10)
    js, _ = sgt.preprocess_points(scans[1], 0.25, num_neighbors=10)
    return init, jt, js


@pytest.fixture(scope="module")
def pair64(pair):
    init, jt, js = pair
    jt, js = jt.astype(np.float64), js.astype(np.float64)
    return init, (jt, sgt.KdTree.build(jt), js), (_to_torch(jt), _to_torch(js))


def _close(a, b, rtol=1e-9):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("cls", CLASSES)
def test_factor_classes_match_jax(pair64, cls):
    init, (jt, jtree, js), (tt, ts) = pair64
    kw = dict(robust_kernel="huber", robust_c=0.5) if cls == "GICPFactor" else {}
    jH, jb, je, jm = getattr(sgt, cls)(**kw).linearize(jt, js, jtree, init)
    H, b, e, m = getattr(pt, cls)(**kw).linearize(tt, ts, None, init)
    assert torch.equal(m, torch.as_tensor(np.array(jm)))
    assert int(m.sum()) > 1000
    _close(H, jH)
    _close(b, jb)
    _close(e, je)


def test_error_and_per_point_match_jax(pair64):
    init, (jt, jtree, js), (tt, ts) = pair64
    T = torch.as_tensor(init)
    corr, _ = search_correspondences("gicp", tt, None, ts.points, ts.num_points, ts.covs,
                                     T, 1.0)
    jcorr = j_search("gicp", jt, jtree, js.points, js.num_points, js.covs,
                     np.asarray(init), np.float64(1.0))
    for kernel in (None, "huber", "cauchy"):
        e = factors.error(corr, T, ts.points, kernel, 0.3)
        assert e.dtype == torch.float64
        _close(e, j_factors.error(jcorr, np.asarray(init), js.points, kernel, 0.3))
        H_i, b_i, e_i = factors.linearize_per_point(corr, T, ts.points, kernel, 0.3)
        jH, jb, je = j_factors.linearize_per_point(jcorr, np.asarray(init), js.points,
                                                   kernel, 0.3)
        _close(H_i, jH)
        _close(b_i, jb)
        _close(e_i, je)
        H, b, e_tot = factors.linearize(corr, T, ts.points, kernel, 0.3)
        _close(H_i.sum(0), H)
        _close(b_i.sum(0), b)
        _close(e_i.sum(), e_tot)


def test_float32_sums_match_the_unfused_route(pair):
    """In float32 the GICP weights (C_t + R C_s Rᵀ)⁻¹ are ill-conditioned (the
    plane-regularized covariances' least eigenvalue is 1e-3), so per-point
    systems round differently in the two packages; the float64 cases above
    hold the math. Here: the same inliers as JAX, and the per-point sums equal
    to the unfused route's ``linearize`` on the same correspondences to 1e-5
    relative (phase 13 of chip_smoke.py checks the same on the card)."""
    init, jt, js = pair
    tt, ts = _to_torch(jt), _to_torch(js)
    T = torch.as_tensor(init.astype(np.float32))
    tree = KdTree.build(tt)
    H_i, b_i, _, m = pt.GICPFactor().linearize(tt, ts, tree, T)
    *_, jm = sgt.GICPFactor().linearize(jt, js, sgt.KdTree.build(jt), T.numpy())
    assert torch.equal(m, torch.as_tensor(np.array(jm)))
    corr, _ = search_correspondences("gicp", tt, tree, ts.points, ts.num_points, ts.covs,
                                     T, 1.0)
    H, b, _ = factors.linearize(corr, T, ts.points)
    _close(H_i.double().sum(0), H.double(), rtol=1e-5)
    _close(b_i.double().sum(0), b.double(), rtol=1e-5)


def test_single_index_form_and_guards(pair64):
    init, (jt, jtree, js), (tt, ts) = pair64
    f, jf = pt.GICPFactor(), sgt.GICPFactor()
    H_i, b_i, e_i, mask = f.linearize(tt, ts, None, init)
    rej = pt.DistanceRejector(2.0)
    j_rej = sgt.DistanceRejector(2.0)
    for i in (0, 17, len(ts) - 1):
        ok, H, b, e = f.linearize(tt, ts, None, init, i, rej)
        j_ok, jH, jb, je = jf.linearize(jt, js, jtree, init, i, j_rej)
        assert ok == j_ok and isinstance(e, float)
        _close(H, jH)
        _close(b, jb)
        assert e == pytest.approx(je, rel=1e-9, abs=1e-15)
        if bool(mask[i]):
            _close(H, H_i[i])
            assert e == pytest.approx(float(e_i[i]), rel=1e-9, abs=1e-15)
    with pytest.raises(TypeError, match="source_index must be an int"):
        f.linearize(tt, ts, None, init, 0.25)
    for bad in (-1, len(ts), ts.capacity + 3):
        with pytest.raises(IndexError):
            f.linearize(tt, ts, None, init, bad)


def test_distance_rejector():
    rej, j_rej = pt.DistanceRejector(0.5), sgt.DistanceRejector(0.5)
    d2 = np.array([0.0, 0.2, 0.25, 0.26, 9.0])
    assert rej.max_dist_sq == j_rej.max_dist_sq == 0.25
    assert rej(torch.as_tensor(d2)).tolist() == np.asarray(j_rej(d2)).tolist()
    rej.set_max_distance(3.0)
    j_rej.set_max_distance(3.0)
    assert rej.max_dist_sq == j_rej.max_dist_sq == 9.0


def test_random_sampling_count_membership_determinism():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    cloud = pt.PointCloud.from_points(pts, capacity=320, device="cpu")
    rows = {tuple(r) for r in pts}
    for k in (1, 50, 300, 310):
        out = pt.random_sampling(cloud, k, torch.Generator().manual_seed(7))
        n = min(k, 300)
        assert out.capacity == k and int(out.num_points) == n
        got = out.points_numpy()
        assert np.all(got[:, 3] == 1.0)
        assert {tuple(r) for r in got[:, :3]} <= rows
        assert len({tuple(r) for r in got[:, :3]}) == n
        assert np.all(out.points[n:, 3].numpy() == 0.0)
        again = pt.random_sampling(cloud, k, torch.Generator().manual_seed(7))
        assert torch.equal(again.points, out.points)
    other = pt.random_sampling(cloud, 50, torch.Generator().manual_seed(8))
    assert not torch.equal(other.points, pt.random_sampling(
        cloud, 50, torch.Generator().manual_seed(7)).points)
    # The JAX package's result has the same shape and count (its rows differ).
    j = sgt.random_sampling(sgt.PointCloud.from_points(pts, capacity=320), 50,
                            jax.random.PRNGKey(0))
    assert (j.capacity, int(j.num_points)) == (other.capacity, int(other.num_points))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eigh3x3_matches_jax_and_numpy(dtype):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(200, 3, 3))
    A = X @ X.transpose(0, 2, 1)
    A[0] = np.eye(3)
    A[1] = np.diag([2.0, 2.0, 5.0])
    A[2] = 0.0
    A = A.astype(dtype)
    vals, V = eigh3x3(torch.as_tensor(A))
    j_vals, j_V = j_eigh3x3(A)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=tol, atol=tol)
    np.testing.assert_allclose(V.numpy(), np.asarray(j_V), atol=10 * tol)
    np.testing.assert_allclose(vals.numpy(), np.linalg.eigvalsh(A.astype(np.float64)),
                               rtol=tol, atol=10 * tol * np.abs(A).max())
    recon = V @ torch.diag_embed(vals) @ V.transpose(-1, -2)
    np.testing.assert_allclose(recon.numpy(), A, atol=100 * tol * np.abs(A).max())
    np.testing.assert_allclose((V.transpose(-1, -2) @ V).numpy(),
                               np.broadcast_to(np.eye(3), A.shape), atol=10 * tol)


def test_point_cloud_accessors_match_jax():
    pts = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    j = sgt.PointCloud.from_points(pts, capacity=8)
    c = pt.PointCloud.from_points(pts, capacity=8, device="cpu")
    assert repr(c) == repr(j)
    assert c.size() == j.size() == 5 and not c.empty()
    assert pt.PointCloud.from_points(np.zeros((0, 3), np.float32), capacity=2,
                                     device="cpu").empty()
    assert np.array_equal(c.xyz().numpy(), np.asarray(j.xyz()))
    assert np.array_equal(c.points_numpy(), j.points_numpy())
    assert not c.has_normals and not c.has_covs
    c64, j64 = c.astype(np.float64), j.astype(np.float64)
    assert c64.dtype == torch.float64 and repr(c64) == repr(j64)
    assert c.astype(torch.float64).dtype == torch.float64
    covs = np.tile(np.eye(3, dtype=np.float32), (8, 1, 1)) * np.arange(8)[:, None, None]
    nrm = np.zeros((8, 4), np.float32)
    nrm[:, 2] = 1.0
    c = c.replace(covs=torch.as_tensor(covs), normals=torch.as_tensor(nrm))
    j = j.replace(covs=covs, normals=nrm)
    assert c.has_normals and c.has_covs
    assert np.array_equal(c.covs_numpy(), j.covs_numpy())
    assert np.array_equal(c.normals_numpy(), j.normals_numpy())
    for i in (0, 4):
        assert np.array_equal(c.point(i), np.asarray(j.point(i)))
        assert np.array_equal(c.normal(i), np.asarray(j.normal(i)))
        assert np.array_equal(c.cov(i), np.asarray(j.cov(i)))
    for bad in (-1, 5, 7):
        for fn in (c.point, c.normal, c.cov):
            with pytest.raises(IndexError, match=r"out of range \[0, 5\)"):
                fn(bad)


def test_replace_on_result_types(pair):
    _, jt, js = pair
    tt, ts = _to_torch(jt), _to_torch(js)
    tree = KdTree.build(tt)
    other = tree.replace(num_points=torch.tensor(10, dtype=torch.int32))
    assert int(other.num_points) == 10 and other.points is tree.points
    assert int(tree.num_points) == len(tt)
    res = pt.Registration(max_iterations=2).align(tt, ts, tree)
    moved = res.replace(converged=torch.tensor(False))
    assert moved.T_target_source is res.T_target_source and not bool(moved.converged)
    corr, _ = search_correspondences("icp", tt, tree, ts.points, ts.num_points, None,
                                     torch.eye(4), 1.0)
    masked = corr.replace(mask=torch.zeros_like(corr.mask))
    assert masked.W is corr.W and not bool(masked.mask.any())
    ps = ProjectiveSearch.build(tt)
    wide = ps.replace(window_h=3)
    assert wide.window_h == 3 and ps.window_h == 10 and wide.index_image is ps.index_image


def test_brute_force_knn_numpy_matches_jax():
    rng = np.random.default_rng(3)
    t = rng.normal(size=(300, 3))
    q = rng.normal(size=(40, 3))
    d2, idx = brute_force_knn_numpy(t, q, 7)
    j_d2, j_idx = j_brute(t, q, 7)
    assert np.array_equal(idx, j_idx) and np.array_equal(d2, j_d2)
    np.testing.assert_allclose(d2[:, 0], ((q[:, None] - t[None]) ** 2).sum(-1).min(1),
                               atol=1e-12)
