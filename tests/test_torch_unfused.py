"""The unfused registration route of the port, ``align_impl(use_fused=
"never")``, on the CPU against the JAX package's ``align_impl`` (whose CPU
run is its XLA search + linearize route) and against the port's fused route.

Inputs: the 16-ring × 256-step synthetic pair, preprocessed once by the
JAX package (0.25 m voxels, k = 10); both packages register the same
arrays from the same initial guess. Registrations are compared at the
convergence level — poses within 2× the thresholds, iteration counts
within one — because float32 sums taken in another order can flip a
knife-edge LM accept.
"""

import math

import numpy as np
import pytest
import torch

import small_gicp_tpu as sgt
from small_gicp_tpu.models.registration import align_impl as j_align_impl
import small_gicp_tpu_torch as pt
from small_gicp_tpu_torch.models.registration import align_impl
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.utils.lie import rotation_error_deg, se3_exp
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

ROT_EPS = 0.1 * math.pi / 180.0
TRANS_EPS = 1e-3


def _errors(T, T_ref):
    T = torch.as_tensor(np.asarray(T, np.float64))
    T_ref = torch.as_tensor(np.asarray(T_ref, np.float64))
    return (float(rotation_error_deg(T_ref[:3, :3], T[:3, :3])),
            float(torch.linalg.vector_norm(T[:3, 3] - T_ref[:3, 3])))


def _to_torch(jcloud):
    return pt.cloud_from_numpy(
        np.asarray(jcloud.points), int(jcloud.num_points),
        normals=np.asarray(jcloud.normals), covs=np.asarray(jcloud.covs),
        device="cpu")


@pytest.fixture(scope="module")
def pair():
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    rng = np.random.default_rng(11)
    tw = np.r_[rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.2]
    init = (T_gt @ se3_exp(torch.as_tensor(tw)).numpy()).astype(np.float32)
    jt, jtree = sgt.preprocess_points(scans[0], 0.25, num_neighbors=10)
    js, _ = sgt.preprocess_points(scans[1], 0.25, num_neighbors=10)
    tt, ts = _to_torch(jt), _to_torch(js)
    return scans, T_gt, init, (jt, jtree, js), (tt, KdTree.build(tt), ts)


def _assert_agree(a_T, a_iters, b_T, b_iters):
    d_rot, d_trans = _errors(a_T, b_T)
    assert math.radians(d_rot) <= 2 * ROT_EPS
    assert d_trans <= 2 * TRANS_EPS
    assert abs(int(a_iters) - int(b_iters)) <= 1


@pytest.mark.parametrize("optimizer", ["lm", "gn"])
@pytest.mark.parametrize("factor", ["gicp", "plane_icp", "icp"])
def test_unfused_align_matches_jax(pair, factor, optimizer):
    _, T_gt, init, (jt, jtree, js), (tt, ttree, ts) = pair
    jr = j_align_impl(jt, js, jtree, init, registration_type=factor,
                      optimizer=optimizer)
    tr = align_impl(tt, ts, ttree, init, registration_type=factor,
                    optimizer=optimizer, use_fused="never")
    _assert_agree(tr.T_target_source.numpy(), tr.iterations,
                  np.asarray(jr.T_target_source), jr.iterations)
    # (No check of the converged flags: on a knife edge one LM loop ends by
    # converging and the other by rejecting every trial at the same pose.)
    assert abs(int(tr.num_inliers) - int(jr.num_inliers)) <= 0.01 * int(jr.num_inliers)
    assert tr.error.dtype == torch.float64
    np.testing.assert_allclose(float(tr.error), float(jr.error), rtol=2e-2)
    if factor != "icp":  # point-to-point ICP stalls short of the bounds in both
        rot, trans = _errors(tr.T_target_source.numpy(), T_gt)
        assert rot < 2.5 and trans < 0.2


def test_unfused_align_robust_matches_jax(pair):
    _, T_gt, init, (jt, jtree, js), (tt, ttree, ts) = pair
    jr = j_align_impl(jt, js, jtree, init, robust_kernel="huber", robust_c=0.5)
    tr = align_impl(tt, ts, ttree, init, robust_kernel="huber", robust_c=0.5,
                    use_fused="never")
    _assert_agree(tr.T_target_source.numpy(), tr.iterations,
                  np.asarray(jr.T_target_source), jr.iterations)
    rot, trans = _errors(tr.T_target_source.numpy(), T_gt)
    assert rot < 2.5 and trans < 0.2


def test_unfused_route_matches_fused_route(pair):
    _, _, init, _, (tt, ttree, ts) = pair
    for kwargs in (dict(), dict(optimizer="gn"), dict(registration_type="plane_icp"),
                   dict(robust_kernel="cauchy", robust_c=0.5),
                   dict(dof_mask=[1.0, 1.0, 1.0, 1.0, 1.0, 0.0]),
                   dict(solve_dtype="float64")):
        fused = align_impl(tt, ts, ttree, init, **kwargs)
        unfused = align_impl(tt, ts, None, init, use_fused="never", **kwargs)
        _assert_agree(unfused.T_target_source.numpy(), unfused.iterations,
                      fused.T_target_source.numpy(), fused.iterations)
        assert int(unfused.num_inliers) == int(fused.num_inliers), kwargs
    with pytest.raises(ValueError, match="use_fused"):
        align_impl(tt, ts, ttree, init, use_fused="always")


def test_float64_clouds_match_jax_end_to_end(pair):
    """float64 clouds take the searched covariance route and the unfused
    optimizer route, as in the JAX package."""
    scans, T_gt, init, _, _ = pair
    a, b = scans[0].astype(np.float64), scans[1].astype(np.float64)
    jt, jtree = sgt.preprocess_points(a, 0.25, num_neighbors=10)
    js, _ = sgt.preprocess_points(b, 0.25, num_neighbors=10)
    tt, ttree = pt.preprocess_points(a, 0.25, num_neighbors=10, device="cpu")
    ts, _ = pt.preprocess_points(b, 0.25, num_neighbors=10, device="cpu")
    assert tt.covs.dtype == torch.float64
    np.testing.assert_allclose(tt.covs.numpy(), np.asarray(jt.covs), atol=1e-6)
    jr = sgt.align(jt, js, jtree, init_T_target_source=init.astype(np.float64))
    tr = pt.align(tt, ts, ttree, init_T_target_source=init.astype(np.float64))
    assert tr.T_target_source.dtype == torch.float64
    _assert_agree(tr.T_target_source.numpy(), tr.iterations,
                  np.asarray(jr.T_target_source), jr.iterations)
    rot, trans = _errors(tr.T_target_source.numpy(), T_gt)
    assert rot < 2.5 and trans < 0.2 and bool(tr.converged)
