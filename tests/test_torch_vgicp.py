"""VGICP, voxel-map targets and the live rows of a target (fault C3) in the
port, against the JAX package on the CPU.

A 16-ring × 256-step synthetic scan pair is preprocessed by both packages.
Registrations compare at the convergence level (ROADMAP C, knife-edge LM
accepts): poses within 2×``translation_eps`` and 2×``rotation_eps``,
iterations within one, both within 2.5° / 0.2 m of the ground truth where
the path converges. Searches compare exactly: indices equal, d² within
rtol 1e-6 of the float64 distances to the rows found. The JAX KdTree forms
d² as ‖q‖² − 2q·t + ‖t‖², which cancels, so its kNN may order near-ties
apart: there its rows' float64 distances equal the port's within 1e-4
(a few float32 ulps of ‖q‖² + ‖t‖² at 15 m). The packed corr rows through the plain step
equal the unfused errors callback within 1e-6 relative on every error and
1e-6 on the pose.
"""

import math
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import small_gicp_tpu as sgt
from small_gicp_tpu.models import voxelmap as jv
from small_gicp_tpu.models.registration import (
    Registration as JRegistration,
    align_impl as j_align_impl,
)
from small_gicp_tpu.ops.knn import KdTree as JKdTree
from small_gicp_tpu.point_cloud import PointCloud as JCloud
import small_gicp_tpu_torch as pt
from small_gicp_tpu_torch.models import factors, registration
from small_gicp_tpu_torch.models import voxelmap as tv
from small_gicp_tpu_torch.models.registration import (
    Registration,
    align_impl,
    pack_corr_rows,
    search_correspondences,
)
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.ops.knn_cuda import knn, knn_pruned, nearest_neighbor
from small_gicp_tpu_torch.ops.lm_step import gicp_lm_step_plain, lm_state
from small_gicp_tpu_torch.point_cloud import PointCloud, live_rows
from small_gicp_tpu_torch.utils.lie import rotation_error_deg, se3_exp
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

ROT_EPS = 0.1 * math.pi / 180.0
TRANS_EPS = 1e-3


def _errors(T, T_ref):
    T = torch.as_tensor(np.asarray(T, np.float64))
    T_ref = torch.as_tensor(np.asarray(T_ref, np.float64))
    return (float(rotation_error_deg(T_ref[:3, :3], T[:3, :3])),
            float(torch.linalg.vector_norm(T[:3, 3] - T_ref[:3, 3])))


def _agree(j, t, T_gt=None):
    """Poses within 2× the eps, iterations within one (and within the
    reference bounds of ``T_gt`` when given)."""
    d_rot, d_trans = _errors(t.T_target_source.numpy(), j.T_target_source)
    assert math.radians(d_rot) <= 2 * ROT_EPS and d_trans <= 2 * TRANS_EPS, (d_rot, d_trans)
    assert abs(int(t.iterations) - int(j.iterations)) <= 1
    if T_gt is not None:
        rot, trans = _errors(t.T_target_source.numpy(), T_gt)
        assert rot < 2.5 and trans < 0.2


@pytest.fixture(scope="module")
def pair():
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    rng = np.random.default_rng(17)
    tw = np.r_[rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.2]
    init = (T_gt @ se3_exp(torch.as_tensor(tw)).numpy()).astype(np.float32)
    jt, _ = sgt.preprocess_points(scans[0], 0.25)
    js, _ = sgt.preprocess_points(scans[1], 0.25)
    tt, _ = pt.preprocess_points(scans[0], 0.25, device="cpu")
    ts, _ = pt.preprocess_points(scans[1], 0.25, device="cpu")
    return dict(scans=scans, T_gt=T_gt, init=init, j=(jt, js), t=(tt, ts),
                jmap=sgt.create_gaussian_voxelmap(jt, 1.0),
                tmap=pt.create_gaussian_voxelmap(tt, 1.0))


@pytest.mark.parametrize("optimizer", ["lm", "gn"])
def test_vgicp_align_impl_matches_jax(pair, optimizer):
    (jt, js), (tt, ts) = pair["j"], pair["t"]
    assert pair["tmap"].device.type == "cpu"
    jr = j_align_impl(pair["jmap"], js, None, jnp.asarray(pair["init"]),
                      registration_type="gicp", optimizer=optimizer)
    tr = align_impl(pair["tmap"], ts, None, torch.as_tensor(pair["init"]),
                    registration_type="gicp", optimizer=optimizer)
    _agree(jr, tr, pair["T_gt"])
    assert abs(int(tr.num_inliers) - int(jr.num_inliers)) <= 0.01 * int(jr.num_inliers)


def test_vgicp_registration_and_helper_match_jax(pair):
    """``Registration("vgicp")``, ``align`` with a voxel-map target (and its
    warning when ``max_correspondence_distance`` is dropped) and
    ``align(..., registration_type="vgicp")`` from preprocessed clouds and
    from raw points."""
    (jt, js), (tt, ts) = pair["j"], pair["t"]
    init = pair["init"]
    jr = JRegistration("vgicp").align(pair["jmap"], js, init_T=jnp.asarray(init))
    tr = Registration("vgicp").align(pair["tmap"], ts, init_T=torch.as_tensor(init))
    _agree(jr, tr, pair["T_gt"])
    with pytest.warns(UserWarning, match="max_correspondence_distance is ignored"):
        hr = pt.align(pair["tmap"], ts, init_T_target_source=init,
                      max_correspondence_distance=2.0)
    assert torch.equal(hr.T_target_source, tr.T_target_source)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pr = pt.align(tt, ts, init_T_target_source=init, registration_type="vgicp")
    assert torch.equal(pr.T_target_source, tr.T_target_source)
    raw_j = sgt.align(pair["scans"][0], pair["scans"][1], init_T_target_source=init,
                      registration_type="vgicp", voxel_resolution=1.5)
    raw_t = pt.align(pair["scans"][0], pair["scans"][1], init_T_target_source=init,
                     registration_type="VGICP", voxel_resolution=1.5, device="cpu")
    _agree(raw_j, raw_t, pair["T_gt"])
    with pytest.raises(ValueError, match="registration type"):
        Registration("ndt")


def test_incremental_map_target_matches_jax(pair):
    """An incremental map with covariances as the target of align_impl."""
    (jt, js), (tt, ts) = pair["j"], pair["t"]
    jm = jv.IncrementalVoxelMapCov(1.0, 1024).insert(jt)
    tm = tv.IncrementalVoxelMapCov(1.0, 1024, device="cpu").insert(tt)
    jr = j_align_impl(jm, js, None, jnp.asarray(pair["init"]), registration_type="gicp")
    tr = align_impl(tm, ts, None, torch.as_tensor(pair["init"]), registration_type="gicp")
    _agree(jr, tr, pair["T_gt"])


def test_gicp_against_the_incremental_map_cloud_on_both_routes(pair):
    """``ivm_as_cloud`` keeps its live rows at slot positions with
    ``num_points`` the live count (fault C3): both routes search every live
    row, as the JAX package does."""
    (jt, js), (tt, ts) = pair["j"], pair["t"]
    jm = jv.IncrementalVoxelMapCov(1.0, 4096, voxel_capacity=512).insert(jt)
    tm = tv.IncrementalVoxelMapCov(1.0, 4096, voxel_capacity=512, device="cpu").insert(tt)
    jc, tc = jv.ivm_as_cloud(jm), tv.ivm_as_cloud(tm)
    live = tc.points[:, 3] > 0.5
    assert int(live.sum()) == int(tc.num_points) and bool(live[int(tc.num_points):].any())
    assert torch.equal(live_rows(tc.points, tc.num_points), live)
    jr = j_align_impl(jc, js, None, jnp.asarray(pair["init"]), registration_type="gicp")
    for mode in ("auto", "never"):
        tr = align_impl(tc, ts, None, torch.as_tensor(pair["init"]),
                        registration_type="gicp", use_fused=mode)
        _agree(jr, tr, pair["T_gt"])
    # And through a KdTree over the cloud view (its kept sort on the fused route).
    tree = KdTree.build(tc)
    tr = align_impl(tc, ts, tree, torch.as_tensor(pair["init"]), registration_type="gicp")
    _agree(jr, tr, pair["T_gt"])


def _scattered(rng, n_live, cap, dtype=np.float32):
    """A cloud of ``n_live`` live rows spread over ``cap`` rows, sentinel
    rows (w = 0) between them, num_points the live count."""
    rows = np.sort(rng.choice(cap, n_live, replace=False))
    xyz = rng.uniform(-15, 15, (n_live, 3))
    xyz[:, 2] = np.sin(xyz[:, 0] * 0.3) + 0.05 * rng.normal(size=n_live)
    P = np.full((cap, 4), 1e9, dtype)
    P[:, 3] = 0.0
    P[rows, :3], P[rows, 3] = xyz, 1.0
    return P, rows


def test_live_rows_off_the_front_match_jax(pair):
    """Fault C3: live rows that are not the first ``num_points``. The 1-NN,
    the kNN and align_impl on both routes give the JAX package's winners
    and result; the same cloud packed to the front gives the same pose."""
    rng = np.random.default_rng(31)
    P, rows = _scattered(rng, 1500, 4000)
    num = np.int32(len(rows))
    jtree = JKdTree.build(JCloud(points=jnp.asarray(P), num_points=jnp.asarray(num)))
    ttree = KdTree.build(PointCloud(points=torch.as_tensor(P),
                                    num_points=torch.tensor(num)))
    q = (P[rows[::4], :3] + rng.normal(0, 0.3, (len(rows[::4]), 3))).astype(np.float32)
    def exact(idx):  # float64 d² to the rows found
        return ((P[idx, :3].astype(np.float64) - q[:, None, :].astype(np.float64)) ** 2
                ).sum(-1)

    jd, ji = jtree.nearest_neighbor_search(jnp.asarray(q))
    td, ti = ttree.nearest_neighbor_search(torch.as_tensor(q))
    assert np.array_equal(np.asarray(ji), ti.numpy())
    # K9 and K10 (their plain versions here) over the tree's packed rows,
    # writing rows through its map: the tree's rows.
    rows_p, num_p, order = ttree.packed()
    assert int(num_p) == len(rows) and torch.equal(order[:len(rows)].long(),
                                                    torch.as_tensor(rows))
    assert torch.equal(nearest_neighbor(rows_p, num_p, torch.as_tensor(q),
                                        rowmap=order)[1], ti)
    assert torch.equal(knn(rows_p, num_p, torch.as_tensor(q), 5, rowmap=order)[1],
                       ttree.knn_search(torch.as_tensor(q), 5)[1])
    assert np.isin(ti.numpy(), rows).all()
    np.testing.assert_allclose(td.numpy(), exact(ti.numpy()[:, None])[:, 0], rtol=1e-6)
    for k in (5, 20):
        jd, ji = jtree.knn_search(jnp.asarray(q), k)
        td, ti = ttree.knn_search(torch.as_tensor(q), k)
        assert bool((td < 1e16).all()) and np.isin(ti.numpy(), rows).all()
        # K12's plain version sorts the same live rows, with the tree's kept
        # sort or its own: the tree's rows.
        for kept in (None, ttree.pruned_target()):
            pd, pi = knn_pruned(ttree.points, ttree.num_points, torch.as_tensor(q), k,
                                target=kept)
            assert torch.equal(pi, ti) and torch.equal(pd, td)
        np.testing.assert_allclose(td.numpy(), exact(ti.numpy()), rtol=1e-6)
        # The JAX package's rows are as near: the same rows but where its
        # expanded d² reorders near-ties.
        same = np.asarray(ji) == ti.numpy()
        assert same.mean() > 0.99
        np.testing.assert_allclose(exact(np.asarray(ji)), exact(ti.numpy()), atol=1e-4)
    # Registration: the target is the scan pair's target with sentinel rows
    # woven in, the source as preprocessed.
    (jt, js), (tt, ts) = pair["j"], pair["t"]
    n = int(tt.num_points)
    cap = 2 * tt.capacity
    at = np.sort(rng.choice(cap, n, replace=False))
    pts = np.full((cap, 4), 1e9, np.float32)
    pts[:, 3] = 0.0
    covs = np.zeros((cap, 3, 3), np.float32)
    pts[at], covs[at] = tt.points[:n].numpy(), tt.covs[:n].numpy()
    jc = JCloud(points=jnp.asarray(pts), num_points=jnp.asarray(np.int32(n)),
                covs=jnp.asarray(covs))
    tc = PointCloud(points=torch.as_tensor(pts), num_points=torch.tensor(n, dtype=torch.int32),
                    covs=torch.as_tensor(covs))
    init = pair["init"]
    jr = j_align_impl(jc, js, None, jnp.asarray(init), registration_type="gicp")
    front = align_impl(tt, ts, None, torch.as_tensor(init), registration_type="gicp")
    for mode in ("auto", "never"):
        tr = align_impl(tc, ts, None, torch.as_tensor(init), registration_type="gicp",
                        use_fused=mode)
        _agree(jr, tr, pair["T_gt"])
        if mode == "auto":  # the same rows in another order: the same pose
            assert torch.equal(tr.T_target_source, front.T_target_source)
            assert int(tr.iterations) == int(front.iterations)


def test_packed_corr_rows_equal_the_unfused_errors(pair):
    """The voxel correspondences packed as [μ | W | mask | d² | 0 0] rows
    through the plain step give the errors and the step of the factors'
    own errors callback."""
    (_, _), (_, ts) = pair["j"], pair["t"]
    T = torch.as_tensor(pair["init"])
    corr, d2 = search_correspondences("gicp", pair["tmap"], None, ts.points,
                                      ts.num_points, ts.covs, T, 1.0)
    rows = pack_corr_rows(corr, d2)
    assert rows.shape == (ts.capacity, 16) and rows.dtype == torch.float32
    assert torch.equal(rows[:, 12] > 0.5, corr.mask)
    H, b, _ = factors.linearize(corr, T, ts.points)
    sums = torch.cat([H.reshape(36), b, H.new_zeros(1),
                      corr.mask.sum().reshape(1).to(H.dtype)]).to(torch.float64)
    a, c = lm_state(T, device="cpu"), lm_state(T, device="cpu")
    gicp_lm_step_plain(a, sums, rows, ts.points, ts.num_points)
    gicp_lm_step_plain(c, sums, None, None, None,
                       errors=lambda Ts: factors.error_multi(corr, Ts, ts.points))
    np.testing.assert_allclose(a.errs.numpy(), c.errs.numpy(), rtol=1e-6)
    assert bool(a.accepted) == bool(c.accepted) and int(a.j) == int(c.j)
    np.testing.assert_allclose(a.T.numpy(), c.T.numpy(), atol=1e-6)


def test_float32_unfused_routes_run_the_step(pair, monkeypatch):
    """Every float32 unfused iteration (voxel map or point cloud) ends in
    ``gicp_lm_step`` on the packed rows; float64 clouds take the plain step
    on packed float64 rows."""
    (_, _), (tt, ts) = pair["j"], pair["t"]
    calls = {"gicp_lm_step": [], "gicp_lm_step_plain": []}

    def counted(name):
        real = getattr(registration, name)

        def step(state, sums, corr, *rest):
            calls[name].append((corr.shape, corr.dtype))
            return real(state, sums, corr, *rest)
        return step

    for name in calls:
        monkeypatch.setattr(registration, name, counted(name))
    init = torch.as_tensor(pair["init"])
    for target, kw in ((pair["tmap"], {}), (tt, dict(use_fused="never"))):
        calls["gicp_lm_step"].clear()
        r = align_impl(target, ts, None, init, registration_type="gicp", **kw)
        assert len(calls["gicp_lm_step"]) == int(r.iterations) + 1
        assert all(c == ((ts.capacity, 16), torch.float32) for c in calls["gicp_lm_step"])
        assert not calls["gicp_lm_step_plain"]
    calls["gicp_lm_step"].clear()
    d = lambda c: c.replace(points=c.points.double(), covs=c.covs.double())  # noqa: E731
    r = align_impl(d(tt), d(ts), None, init.double(), registration_type="gicp")
    assert not calls["gicp_lm_step"] and r.T_target_source.dtype == torch.float64
    assert len(calls["gicp_lm_step_plain"]) == int(r.iterations) + 1
    assert all(c == ((ts.capacity, 16), torch.float64)
               for c in calls["gicp_lm_step_plain"])
