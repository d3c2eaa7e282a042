"""Port parity of the persistent-lane fleet (``align_fleet``) and of its
kernels' plain versions: K7 (``gicp_linearize_fleet_plain``) and K8
(``gicp_error_multi_fleet_plain``) against the JAX package's
``gicp_linearize_fleet`` / ``gicp_error_multi_fleet`` in interpret mode,
and the port's fleet against JAX ``align_fleet`` on the CPU.

The problem is the one of tests/test_fleet.py, rebuilt from
``np.random.default_rng(7)``: two pairs at capacity 640, five problems.
Clouds are built with the JAX package's own API and handed to the port as
numpy arrays, so both packages compute on identical inputs.

Registrations are compared at the convergence level, as tests/test_fleet.py
compares the fleet with align_impl: pose within 2e-3, error within 1e-4
relative, iterations within one, inliers within max(3, 1 %). The float32
reduction orders of the two packages differ, which can flip a knife-edge
LM accept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.gicp_fused_pallas import (
    gicp_error_multi_fleet as j_error_multi_fleet,
    gicp_fleet_prepare as j_fleet_prepare,
    gicp_linearize_fleet as j_linearize_fleet,
)
from small_gicp_tpu.parallel.fleet import align_fleet as j_align_fleet
from small_gicp_tpu.point_cloud import PointCloud as JPointCloud
from small_gicp_tpu.utils.lie import se3_exp as j_se3_exp
import small_gicp_tpu_torch as pt
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    gicp_error_multi_fleet,
    gicp_fleet_prepare,
    gicp_linearize_fleet,
    gicp_linearize_fleet_plain,
)
from small_gicp_tpu_torch.ops.eigh3 import solve6x6
from small_gicp_tpu_torch.utils.lie import se3_exp

CAP = 640
PAIR_IDS = np.array([0, 1, 0, 1, 0], np.int32)


def _jax_pair(rng, n, m, cap):
    """tests/test_fleet.py::_pair: JAX clouds with covariances."""
    tp = rng.uniform(-8, 8, size=(m, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0]) * 0.5 + 0.05 * rng.normal(size=m)
    sp = tp[rng.permutation(m)[:n]] + rng.normal(scale=0.05, size=(n, 3)).astype(
        np.float32)

    def covs(k):
        a = rng.normal(size=(k, 3, 3)).astype(np.float32) * 0.05
        c = np.einsum("nij,nkj->nik", a, a) + np.eye(3, dtype=np.float32) * 0.01
        return jnp.asarray(np.concatenate([c, np.zeros((cap - k, 3, 3), np.float32)]))

    target = JPointCloud.from_points(tp).with_capacity(cap)
    target = target.replace(covs=covs(m))
    source = JPointCloud.from_points(sp).with_capacity(cap)
    source = source.replace(covs=covs(n))
    return target, source


def _normals(rng, cap):
    nrm = rng.normal(size=(cap, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    out = np.zeros((cap, 4), np.float32)
    out[:, :3] = nrm
    return jnp.asarray(out)


def _jax_stack(clouds):
    return JPointCloud(
        points=jnp.stack([c.points for c in clouds]),
        num_points=jnp.stack([c.num_points for c in clouds]),
        normals=None if clouds[0].normals is None else jnp.stack(
            [c.normals for c in clouds]),
        covs=jnp.stack([c.covs for c in clouds]),
    )


def _port(cloud):
    return cloud_from_numpy(
        np.asarray(cloud.points), int(cloud.num_points),
        normals=None if cloud.normals is None else np.asarray(cloud.normals),
        covs=np.asarray(cloud.covs), device="cpu")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    t0, s0 = _jax_pair(rng, 500, 600, CAP)
    t1, s1 = _jax_pair(rng, 430, 560, CAP)
    tws = rng.normal(size=(5, 6)).astype(np.float32) * np.r_[
        [0.02] * 3, [0.1] * 3].astype(np.float32)
    init_Ts = np.stack([np.asarray(j_se3_exp(jnp.asarray(t))) for t in tws])
    nrm = [_normals(np.random.default_rng(12 + u), CAP) for u in range(2)]
    t0, t1 = t0.replace(normals=nrm[0]), t1.replace(normals=nrm[1])
    jax_clouds = (_jax_stack([t0, t1]), _jax_stack([s0, s1]))
    port_clouds = (pt.stack_clouds([_port(t0), _port(t1)]),
                   pt.stack_clouds([_port(s0), _port(s1)]))
    return jax_clouds, port_clouds, init_Ts


def _assert_rows_agree(r, jr):
    got, want = pt.result_to_numpy(r), jr
    for p in range(len(PAIR_IDS)):
        np.testing.assert_allclose(got["T_target_source"][p],
                                   np.asarray(want.T_target_source[p]), atol=2e-3)
        np.testing.assert_allclose(got["error"][p], float(want.error[p]), rtol=1e-4)
        assert abs(int(got["iterations"][p]) - int(want.iterations[p])) <= 1
        j_inl = int(want.num_inliers[p])
        assert abs(int(got["num_inliers"][p]) - j_inl) <= max(3, int(0.01 * j_inl))


def test_fleet_matches_jax_fleet(problem):
    (jt, js), (tt, ts), init_Ts = problem
    jr = j_align_fleet(jt, js, jnp.asarray(init_Ts), pair_ids=jnp.asarray(PAIR_IDS),
                       num_lanes=2)
    r = pt.align_fleet(tt, ts, init_Ts, pair_ids=PAIR_IDS, num_lanes=3)
    assert r.T_target_source.shape == (5, 4, 4) and r.error.dtype == torch.float64
    assert r.iterations.dtype == torch.int32 and r.H.shape == (5, 6, 6)
    _assert_rows_agree(r, jr)


def test_fleet_lane_count_invariance(problem):
    """Retire and refill must not change any problem's result: 1 lane
    (sequential) == 3 lanes (refilled) == 8 lanes (more lanes than
    problems)."""
    _, (tt, ts), init_Ts = problem
    prepared = pt.fleet_prepare(tt, ts)
    r0, *rest = [pt.align_fleet(None, None, init_Ts, pair_ids=PAIR_IDS, num_lanes=b,
                                prepared=prepared) for b in (1, 3, 8)]
    for r in rest:
        assert torch.equal(r.iterations, r0.iterations)
        assert torch.equal(r.converged, r0.converged)
        assert torch.equal(r.num_inliers, r0.num_inliers)
        torch.testing.assert_close(r.T_target_source, r0.T_target_source, rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(r.error, r0.error, rtol=1e-6, atol=0)


def test_fleet_kernel_plain_versions_match_pallas_interpret(problem):
    """K7 and K8 at 3 lanes over 2 pairs, lane 2 inactive."""
    (jt, js), (tt, ts), init_Ts = problem
    uids = np.array([0, 1, 0], np.int32)
    active = np.array([True, True, False])
    Ts = init_Ts[:3]
    jtab = j_fleet_prepare(jt.points, jt.covs, js.points, js.covs, js.num_points)
    jH, jb, jinl, jcorr = j_linearize_fleet(
        *jtab, jnp.asarray(uids), jnp.asarray(Ts), 1.0, jnp.asarray(active),
        interpret=True)
    tables = gicp_fleet_prepare(tt.points, tt.num_points, ts.points, ts.num_points,
                                "gicp", tt.covs, ts.covs)
    H, b, inl, corr = gicp_linearize_fleet(
        tables, torch.as_tensor(uids), torch.as_tensor(Ts), 1.0,
        torch.as_tensor(active))
    assert H.dtype == torch.float64 and corr.shape == (3, CAP, 16)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    for lane in range(3):
        scale = max(1.0, float(np.abs(np.asarray(jH[lane])).max()))
        np.testing.assert_allclose(H[lane].numpy() / scale, np.asarray(jH[lane]) / scale,
                                   atol=5e-4)
        bscale = max(1.0, float(np.abs(np.asarray(jb[lane])).max()))
        np.testing.assert_allclose(b[lane].numpy() / bscale,
                                   np.asarray(jb[lane]) / bscale, atol=5e-4)
    # The inactive lane: zero sums and all-zero corr rows.
    assert torch.all(H[2] == 0) and torch.all(b[2] == 0) and torch.all(corr[2] == 0)

    # K8 at each lane's pose plus its 10 LM trial poses.
    lambdas = 1e-3 * 10.0 ** torch.arange(10, dtype=torch.float32)
    deltas = solve6x6(H.float()[:, None], -b.float()[:, None], lambdas.expand(3, 10))
    Tt = torch.as_tensor(Ts)
    all_Ts = torch.cat([Tt[:, None], Tt[:, None] @ se3_exp(deltas)], dim=1)
    for robust, c in [(None, 1.0), ("huber", 0.5), ("cauchy", 0.3)]:
        got = gicp_error_multi_fleet(corr, tables, torch.as_tensor(uids), all_Ts,
                                     robust, c).numpy()
        want = np.asarray(j_error_multi_fleet(
            jcorr, jtab[2], jnp.asarray(uids), jnp.asarray(all_Ts.numpy()),
            interpret=True, robust=robust, robust_c=c))
        assert got.dtype == np.float64 and got.shape == (3, 11)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=str(robust))
        assert np.all(got[2] == 0)


@pytest.mark.parametrize("kwargs", [
    dict(robust_kernel="huber", robust_c=0.5),
    dict(robust_kernel="cauchy", robust_c=0.3),
    dict(registration_type="plane_icp"),
    dict(registration_type="icp"),
])
def test_fleet_options_match_jax_fleet(problem, kwargs):
    (jt, js), (tt, ts), init_Ts = problem
    jr = j_align_fleet(jt, js, jnp.asarray(init_Ts), pair_ids=jnp.asarray(PAIR_IDS),
                       num_lanes=3, **kwargs)
    r = pt.align_fleet(tt, ts, init_Ts, pair_ids=PAIR_IDS, num_lanes=4, **kwargs)
    _assert_rows_agree(r, jr)


def test_with_capacity_and_stack_clouds_match_jax(problem):
    (jt, _), (tt, _), _ = problem
    j0 = JPointCloud(points=jt.points[0], num_points=jt.num_points[0],
                     normals=jt.normals[0], covs=jt.covs[0])
    t0 = pt.PointCloud(points=tt.points[0], num_points=tt.num_points[0],
                       normals=tt.normals[0], covs=tt.covs[0])
    for cap in (700, 550, CAP):
        j, t = j0.with_capacity(cap), t0.with_capacity(cap)
        assert int(t.num_points) == int(j.num_points)
        for name in ("points", "normals", "covs"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)))
    stacked = pt.stack_clouds([t0, t0.with_capacity(CAP)])
    assert stacked.points.shape == (2, CAP, 4) and stacked.covs.shape == (2, CAP, 3, 3)
    assert stacked.num_points.tolist() == [int(t0.num_points)] * 2
    with pytest.raises(ValueError, match="capacity"):
        pt.stack_clouds([t0, t0.with_capacity(700)])
    with pytest.raises(ValueError, match="normals"):
        pt.stack_clouds([t0, t0.replace(normals=None)])


def test_fleet_rejects_bad_arguments(problem):
    _, (tt, ts), init_Ts = problem
    with pytest.raises(ValueError, match="f32"):
        pt.align_fleet(tt.replace(points=tt.points.double()), ts, init_Ts,
                       pair_ids=PAIR_IDS)
    with pytest.raises(ValueError, match="need covs"):
        pt.fleet_prepare(tt, ts.replace(covs=None))
    with pytest.raises(ValueError, match="need normals"):
        pt.fleet_prepare(tt.replace(normals=None), ts, registration_type="plane_icp")
    with pytest.raises(ValueError, match="pair_ids required"):
        pt.align_fleet(tt, ts, init_Ts)
    with pytest.raises(ValueError, match=r"pair_ids must be \[P\]"):
        pt.align_fleet(tt, ts, init_Ts, pair_ids=PAIR_IDS[:4])
    tables = pt.fleet_prepare(tt, ts)
    uids = torch.tensor([0, 1], dtype=torch.int32)
    _, _, _, corr = gicp_linearize_fleet_plain(
        tables, uids, torch.as_tensor(init_Ts[:2]), 1.0, torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="poses per lane"):
        gicp_error_multi_fleet(corr, tables, uids, torch.eye(4).expand(2, 101, 4, 4))
    big = gicp_fleet_prepare(torch.zeros((1, 65537, 4)), torch.tensor([1]),
                             torch.zeros((1, 8, 4)), torch.tensor([1]), "icp")
    with pytest.raises(ValueError, match="65536"):
        gicp_linearize_fleet(big, uids[:1], torch.eye(4)[None], 1.0,
                             torch.ones(1, dtype=torch.bool))
    # One pair with P problems: pair_ids default to zeros.
    single = pt.PointCloud(points=tt.points[0], num_points=tt.num_points[0],
                           covs=tt.covs[0])
    source = pt.PointCloud(points=ts.points[0], num_points=ts.num_points[0],
                           covs=ts.covs[0])
    r = pt.align_fleet(single, source, init_Ts[:2], num_lanes=4)
    assert r.T_target_source.shape == (2, 4, 4)
