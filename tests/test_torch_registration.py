"""The port's slice end to end on the CPU against the JAX package: a
16-ring × 256-step synthetic scan pair, raw points → preprocess_points →
align (GICP), with the LM and the GN optimizer.

Both packages must land within the reference bounds of the ground truth
(2.5°, 0.2 m); their poses must agree within 2× translation_eps and
2× rotation_eps, and their iteration counts within one (float32 reduction
order can flip a knife-edge LM accept between the two paths).
"""

import math

import numpy as np
import pytest
import torch

import small_gicp_tpu as sgt
from small_gicp_tpu.models.registration import Registration as JRegistration
import small_gicp_tpu_torch as pt
from small_gicp_tpu_torch.models.registration import Registration, align_impl
from small_gicp_tpu_torch.utils.lie import rotation_error_deg, se3_exp, so3_log
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

ROT_EPS = 0.1 * math.pi / 180.0
TRANS_EPS = 1e-3


def _errors(T, T_ref):
    T = torch.as_tensor(np.asarray(T, np.float64))
    T_ref = torch.as_tensor(np.asarray(T_ref, np.float64))
    return (float(rotation_error_deg(T_ref[:3, :3], T[:3, :3])),
            float(torch.linalg.vector_norm(T[:3, 3] - T_ref[:3, 3])))


@pytest.fixture(scope="module")
def scan_pair():
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    rng = np.random.default_rng(11)
    tw = np.r_[rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.2]
    init = (T_gt @ se3_exp(torch.as_tensor(tw)).numpy()).astype(np.float32)
    return scans, T_gt, init


@pytest.fixture(scope="module")
def preprocessed(scan_pair):
    scans, _, _ = scan_pair
    jt, jtree = sgt.preprocess_points(scans[0], 0.25, num_neighbors=10)
    js, _ = sgt.preprocess_points(scans[1], 0.25, num_neighbors=10)
    tt, ttree = pt.preprocess_points(scans[0], 0.25, num_neighbors=10, device="cpu")
    ts, _ = pt.preprocess_points(scans[1], 0.25, num_neighbors=10, device="cpu")
    return (jt, jtree, js), (tt, ttree, ts)


def _assert_agree(j_T, j_iters, t_T, t_iters, T_gt):
    for T in (j_T, t_T):
        rot, trans = _errors(T, T_gt)
        assert rot < 2.5 and trans < 0.2
    d_rot, d_trans = _errors(t_T, j_T)
    assert math.radians(d_rot) <= 2 * ROT_EPS
    assert d_trans <= 2 * TRANS_EPS
    assert abs(int(j_iters) - int(t_iters)) <= 1


def test_lm_end_to_end_matches_jax(scan_pair):
    scans, T_gt, init = scan_pair
    jr = sgt.align(scans[0], scans[1], init_T_target_source=init)
    tr = pt.align(scans[0], scans[1], init_T_target_source=init, device="cpu")
    assert bool(jr.converged) and bool(tr.converged)
    _assert_agree(np.asarray(jr.T_target_source), jr.iterations,
                  tr.T_target_source.numpy(), tr.iterations, T_gt)
    # Same correspondences up to the few the preprocessing rounding moves.
    assert abs(int(jr.num_inliers) - int(tr.num_inliers)) <= 0.01 * int(jr.num_inliers)
    assert tr.error.dtype == torch.float64 and tr.H.shape == (6, 6)


def test_gn_matches_jax(scan_pair, preprocessed):
    _, T_gt, init = scan_pair
    (jt, jtree, js), (tt, ttree, ts) = preprocessed
    jr = JRegistration(optimizer="gn").align(jt, js, jtree, init)
    tr = Registration(optimizer="gn").align(tt, ts, ttree, init)
    _assert_agree(np.asarray(jr.T_target_source), jr.iterations,
                  tr.T_target_source.numpy(), tr.iterations, T_gt)


@pytest.mark.parametrize("kwargs", [
    dict(registration_type="plane_icp"),
    dict(robust_kernel="huber", robust_c=0.5),
    dict(robust_kernel="cauchy", robust_c=0.5),
    dict(solve_dtype="float64"),
])
def test_port_variants_reach_the_bounds(scan_pair, preprocessed, kwargs):
    _, T_gt, init = scan_pair
    _, (tt, ttree, ts) = preprocessed
    res = Registration(**kwargs).align(tt, ts, ttree, init)
    rot, trans = _errors(res.T_target_source.numpy(), T_gt)
    assert rot < 2.5 and trans < 0.2
    assert 0 <= int(res.iterations) < 20


def test_dof_mask_freezes_translation(scan_pair, preprocessed):
    # T·exp(δ) with δ_t = 0 keeps t. The lock is a λ = 1e9 prior on H,
    # so against gradients |b_t| ~ 1e5-1e6 each step still moves t by
    # ~1e-4 m — against ~0.2 m when translation is free.
    _, _, init = scan_pair
    _, (tt, ttree, ts) = preprocessed
    res = Registration(dof_translation_mask=[0.0, 0.0, 0.0]).align(
        tt, ts, ttree, init)
    T0 = torch.as_tensor(init, dtype=torch.float64)
    T1 = res.T_target_source.to(torch.float64)
    assert float(torch.linalg.vector_norm(T1[:3, 3] - T0[:3, 3])) < 2e-3
    free = Registration().align(tt, ts, ttree, init).T_target_source.to(torch.float64)
    assert float(torch.linalg.vector_norm(free[:3, 3] - T0[:3, 3])) > 2e-2
    assert float(torch.linalg.vector_norm(so3_log(T0[:3, :3].T @ T1[:3, :3]))) > 1e-3


def test_unported_targets_raise(preprocessed):
    _, (tt, ttree, ts) = preprocessed
    # Voxel maps and VGICP are ported (tests/test_torch_vgicp.py), projective
    # search too (tests/test_torch_projective.py); the mesh-sharded voxel-map
    # target waits for A10, and a searcher of another type is refused.
    with pytest.raises(NotImplementedError, match="A10"):
        align_impl({"voxel": "map"}, ts, None, None)
    with pytest.raises(TypeError, match="target"):
        pt.align({"voxel": "map"}, ts)
    with pytest.raises(TypeError, match="KdTree or a ProjectiveSearch"):
        Registration().align(tt, ts, target_tree=object())
    with pytest.raises(ValueError, match="solve_dtype"):
        Registration(solve_dtype="float16")


def test_entry_points_default_to_the_card():
    x = np.random.default_rng(5).uniform(-5, 5, size=(300, 3)).astype(np.float32)
    if torch.cuda.is_available():
        cloud, _ = pt.preprocess_points(x)
        assert cloud.points.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.preprocess_points(x)


def test_result_to_numpy(scan_pair, preprocessed):
    _, _, init = scan_pair
    _, (tt, ttree, ts) = preprocessed
    out = pt.result_to_numpy(pt.align_points(tt, ts, ttree, init))
    assert out["T_target_source"].shape == (4, 4)
    assert isinstance(out["converged"], bool) and isinstance(out["iterations"], int)
    assert out["H"].shape == (6, 6) and np.isfinite(out["error"])
