"""Port parity of the LM step (K2 redesigned, ``ops/lm_step.py``): its plain
version against the JAX package's LM and GN bodies
(``small_gicp_tpu/models/registration.py:412-548``: ``_solve`` vmapped over
the λ_j, ``se3_exp``, the einsum, ``gicp_error_multi_pallas`` in interpret
mode and the accept), on the frozen correspondences and the Morton-sorted
source rows of the JAX fused linearize on a 16-ring × 256-step synthetic
scan pair, with the same H, b, T and λ on both sides.

Tolerances: trial steps δ_j and poses within 1e-6 absolute (float32; the
two packages form sin, the 4×4 product and the sums in other orders);
errors within 1e-5 relative (float32 terms summed in other orders); the
accepted trial, the accept, converged and stop equal wherever every trial's
error is more than 1e-5 relative from e0 (inside that band float32
rounding can flip the accept, ROADMAP.md C's knife-edge accepts).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.eigh3 import solve6x6 as j_solve6x6
from small_gicp_tpu.ops.gicp_fused_pallas import (
    gicp_error_multi_pallas,
    gicp_linearize_pallas,
)
from small_gicp_tpu.utils.lie import se3_exp as j_se3_exp
import small_gicp_tpu_torch as pt
from small_gicp_tpu_torch.models.registration import Registration, align_impl
from small_gicp_tpu_torch.ops import lm_step
from small_gicp_tpu_torch.ops.lm_step import gicp_lm_step, lm_state
from small_gicp_tpu_torch.utils.lie import se3_exp
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

ROT_EPS = 0.1 * math.pi / 180.0
TRANS_EPS = 1e-3
DOF_LAMBDA = 1e9
BAND = 1e-5


@pytest.fixture(scope="module")
def frozen():
    """The JAX fused linearize at a noisy pose: H, b (float64), corr16 [16,QP]
    and the sorted source rows, and the port's view of the same rows."""
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    rng = np.random.default_rng(3)
    tw = np.r_[rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.2]
    T = (T_gt @ se3_exp(torch.as_tensor(tw)).numpy()).astype(np.float32)
    tgt, _ = pt.preprocess_points(scans[0], 0.25, num_neighbors=10, device="cpu")
    src, _ = pt.preprocess_points(scans[1], 0.25, num_neighbors=10, device="cpu")
    H, b, _, _, _, _, corr16, ssrc = gicp_linearize_pallas(
        jnp.asarray(tgt.points.numpy()), jnp.asarray(tgt.covs.numpy()),
        jnp.asarray(src.points.numpy()), jnp.asarray(src.covs.numpy()),
        jnp.asarray(T), jnp.asarray(int(src.num_points), jnp.int32),
        jnp.asarray(1.0, jnp.float32), interpret=True)
    corr16, ssrc = np.asarray(corr16), np.asarray(ssrc)
    return dict(T=T, H=np.asarray(H, np.float64), b=np.asarray(b, np.float64),
                corr16=corr16, ssrc=ssrc, num=int(src.num_points),
                corr=torch.as_tensor(corr16.T.copy()), src=torch.as_tensor(ssrc.copy()))


def _jax_step(f, H, b, T, lam, case):
    """The JAX package's LM / GN body on these inputs (its closures inlined:
    ``_dof``, ``_solve``, the trial batch and the accept)."""
    dtype = jnp.float32
    sdt = jnp.float64 if case.get("solve_dtype") == "float64" else dtype
    K, fac = case.get("K", 10), 10.0
    robust, c = case.get("robust"), case.get("c", 1.0)
    rot_eps = jnp.asarray(case.get("rot_eps", ROT_EPS), dtype)
    trans_eps = jnp.asarray(case.get("trans_eps", TRANS_EPS), dtype)
    Hs = jnp.asarray(H, sdt)
    if case.get("dof") is not None:
        Hs = Hs + jnp.asarray(DOF_LAMBDA, dtype) * jnp.diag(
            jnp.abs(jnp.asarray(case["dof"], dtype) - 1.0))
    bs = jnp.asarray(b, sdt)

    def solve(lam_j):
        return j_solve6x6(Hs.astype(sdt), -bs.astype(sdt), lam_j.astype(sdt)).astype(dtype)

    def conv(d):
        return (jnp.linalg.norm(d[:3]) <= rot_eps) & (jnp.linalg.norm(d[3:]) <= trans_eps)

    T = jnp.asarray(T)
    errs_of = lambda Ts: gicp_error_multi_pallas(  # noqa: E731
        jnp.asarray(f["corr16"]), jnp.asarray(f["ssrc"]), Ts,
        jnp.asarray(f["num"], jnp.int32), interpret=True, robust=robust, robust_c=c)
    if case.get("optimizer") == "gn":
        e = errs_of(T[None])
        delta = solve(jnp.asarray(1e-6, dtype))
        return dict(errs=np.asarray(e), deltas=np.asarray(delta)[None],
                    Ts=np.asarray(T @ j_se3_exp(delta))[None], accepted=True, j=0,
                    T=np.asarray(T @ j_se3_exp(delta)), e=float(e[0]),
                    lam=float(lam), converged=bool(conv(delta)),
                    stop=bool(conv(delta)), delta=np.asarray(delta))
    lambdas = jnp.asarray(lam, dtype) * jnp.asarray(fac, dtype) ** jnp.arange(K, dtype=dtype)
    deltas = jax.vmap(solve)(lambdas)
    Ts = jnp.einsum("ab,kbc->kac", T, jax.vmap(j_se3_exp)(deltas),
                    precision=jax.lax.Precision.HIGHEST)
    errs_all = errs_of(jnp.concatenate([T[None], Ts], axis=0))
    e0, errs = errs_all[0], errs_all[1:]
    ok = errs <= e0
    accepted = bool(jnp.any(ok))
    j = int(jnp.argmax(ok))
    delta = deltas[j] if accepted else jnp.zeros(6, dtype)
    lam_f = lambdas[j] / fac if accepted else jnp.asarray(lam, dtype) * jnp.asarray(
        fac, dtype) ** K
    converged = accepted and bool(conv(delta))
    return dict(errs=np.asarray(errs_all), deltas=np.asarray(deltas), Ts=np.asarray(Ts),
                accepted=accepted, j=j if accepted else -1,
                T=np.asarray(Ts[j] if accepted else T),
                e=float(errs[j] if accepted else e0), lam=float(lam_f),
                converged=converged, stop=converged or not accepted,
                delta=np.asarray(delta))


def _port_step(f, H, b, T, lam, case):
    dof = case.get("dof")
    state = lm_state(T, case.get("optimizer", "lm"), case.get("K", 10), lam, 10.0,
                     1e-6, case.get("rot_eps", ROT_EPS), case.get("trans_eps", TRANS_EPS),
                     None if dof is None else [DOF_LAMBDA * abs(m - 1.0) for m in dof],
                     device="cpu")
    sums = torch.zeros(44, dtype=torch.float64)
    sums[:36] = torch.as_tensor(H).reshape(36)
    sums[36:42] = torch.as_tensor(b)
    sums[43] = 1234.0
    calls = []
    plain = lm_step.gicp_lm_step_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    lm_step.gicp_lm_step_plain = counted
    try:
        gicp_lm_step(state, sums, f["corr"], f["src"],
                     torch.tensor(f["num"], dtype=torch.int32), case.get("robust"),
                     case.get("c", 1.0), case.get("solve_dtype", "same"))
    finally:
        lm_step.gicp_lm_step_plain = plain
    assert len(calls) == 1
    assert int(state.inliers) == 1234 and int(state.iterations) == 0
    assert int(state.count) == 1
    return state


CASES = {
    "lm": {},
    "gn": {"optimizer": "gn"},
    "dof_mask": {"dof": [1.0, 1.0, 1.0, 0.0, 0.0, 0.0]},
    "float64_solve": {"solve_dtype": "float64"},
    "huber": {"robust": "huber", "c": 0.5},
    "cauchy": {"robust": "cauchy", "c": 0.3},
    "all_reject": {"flip_b": True},
    "converging": {"rot_eps": 0.2, "trans_eps": 1.0},
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_step_matches_the_jax_body(frozen, name):
    case = CASES[name]
    f = frozen
    b = -f["b"] if case.get("flip_b") else f["b"]
    lam = 1e-3
    ref = _jax_step(f, f["H"], b, f["T"], lam, case)
    state = _port_step(f, f["H"], b, f["T"], lam, case)
    trials = state.num_trials
    k1 = ref["errs"].shape[0]
    errs = state.errs[:k1].numpy()
    np.testing.assert_allclose(errs, ref["errs"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(state.trials[:, :6].numpy(), ref["deltas"], rtol=0,
                               atol=1e-6)
    got_Ts = state.trials[:, 6:].numpy()
    want_Ts = np.concatenate([ref["Ts"][:, :3, :3].reshape(trials, 9),
                              ref["Ts"][:, :3, 3]], axis=1)
    np.testing.assert_allclose(got_Ts, want_Ts, rtol=0, atol=1e-6)
    clear = k1 == 1 or bool(np.all(np.abs(errs[1:] - errs[0]) > BAND * abs(errs[0])))
    if clear:
        assert bool(state.accepted) == ref["accepted"]
        assert int(state.j) == ref["j"]
        assert bool(state.converged) == ref["converged"]
        assert bool(state.stop) == ref["stop"]
        np.testing.assert_allclose(state.T.numpy(), ref["T"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(state.delta.numpy(), ref["delta"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(state.e), ref["e"], rtol=1e-5)
        np.testing.assert_allclose(float(state.lam), ref["lam"], rtol=1e-6)
    # Each case is what it says.
    if name == "all_reject":
        assert clear and not ref["accepted"] and bool(state.stop)
        np.testing.assert_array_equal(state.T.numpy(), f["T"])
    if name == "converging":
        assert clear and ref["converged"] and bool(state.stop)
    if name in ("lm", "float64_solve", "huber", "cauchy", "dof_mask"):
        assert ref["accepted"] and not ref["stop"]
    if name == "dof_mask":  # the translation is held by the prior
        assert np.abs(ref["deltas"][:, 3:]).max() < 1e-3
    # H and b as the result reports them: in the solve type, DoF prior
    # included, then in the cloud's type.
    Hs = f["H"] + (np.diag([DOF_LAMBDA * abs(m - 1.0) for m in case["dof"]])
                   if case.get("dof") else 0.0)
    np.testing.assert_allclose(state.H.numpy(), Hs.astype(np.float32), rtol=1e-6)
    np.testing.assert_allclose(state.b.numpy(), b.astype(np.float32), rtol=1e-6)


def test_align_impl_runs_the_plain_step_once_an_iteration(frozen, monkeypatch):
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    init = (T_gt @ se3_exp(torch.tensor([0.01, -0.02, 0.02, 0.1, -0.15, 0.05],
                                        dtype=torch.float64)).numpy()).astype(np.float32)
    tgt, tree = pt.preprocess_points(scans[0], 0.25, num_neighbors=10, device="cpu")
    src, _ = pt.preprocess_points(scans[1], 0.25, num_neighbors=10, device="cpu")
    calls = []
    plain = lm_step.gicp_lm_step_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(lm_step, "gicp_lm_step_plain", counted)
    for optimizer in ("lm", "gn"):
        calls.clear()
        res = Registration(optimizer=optimizer).align(tgt, src, tree, init)
        assert len(calls) == int(res.iterations) + 1
        assert res.T_target_source.shape == (4, 4) and res.error.dtype == torch.float64
        assert res.converged.dtype == torch.bool and res.iterations.dtype == torch.int32


@pytest.mark.parametrize("use_fused", ["never", "auto"])
def test_align_impl_takes_any_number_of_trials(use_fused):
    # K = 100 (past the kernel's 99) runs the plain step on both routes and
    # takes the steps K = 10 takes; K = 0 rejects the first step and stops.
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    init = (T_gt @ se3_exp(torch.tensor([0.01, -0.02, 0.02, 0.1, -0.15, 0.05],
                                        dtype=torch.float64)).numpy()).astype(np.float32)
    tgt, tree = pt.preprocess_points(scans[0], 0.25, num_neighbors=10, device="cpu")
    src, _ = pt.preprocess_points(scans[1], 0.25, num_neighbors=10, device="cpu")
    res = {K: align_impl(tgt, src, tree, init, max_inner_iterations=K,
                         use_fused=use_fused) for K in (0, 10, 100)}
    assert int(res[100].iterations) == int(res[10].iterations) > 0
    torch.testing.assert_close(res[100].T_target_source, res[10].T_target_source,
                               rtol=0, atol=0)
    # The errors of 11 and of 101 poses are reduced in batches of other
    # shapes: the same terms, summed in another order.
    np.testing.assert_allclose(float(res[100].error), float(res[10].error), rtol=1e-9)
    rot = torch.as_tensor(T_gt[:3, :3]).T @ res[100].T_target_source[:3, :3].double()
    angle = math.degrees(math.acos(min(1.0, (float(torch.trace(rot)) - 1.0) / 2.0)))
    shift = float(torch.linalg.vector_norm(res[100].T_target_source[:3, 3].double()
                                           - torch.as_tensor(T_gt[:3, 3])))
    assert angle < 2.5 and shift < 0.2
    assert int(res[0].iterations) == 0 and not bool(res[0].converged)
    torch.testing.assert_close(res[0].T_target_source, torch.as_tensor(init),
                               rtol=0, atol=0)


def test_state_record_layout_and_limits():
    # The float32 record's offsets are the kernel's (csrc/gicp_step.cu).
    fields, _ = lm_step._layout(torch.float32, 10)
    offsets = [fields[k][0] for k in ("T", "H", "b", "delta", "lam", "inliers", "e",
                                      "iterations", "count", "j", "converged",
                                      "accepted", "stop", "errs")]
    assert tuple(offsets) == lm_step._GEOMETRY[2:16]
    st = lm_state(np.eye(4), max_inner_iterations=99, lambda_factor=3.0, device="cpu")
    assert st.errs.shape == (100,) and st.trials.shape == (99, 18)
    assert st.params[lm_step._PAR_POW + 99].item() == 3.0 ** 99
    assert lm_state(np.eye(4), "gn", device="cpu").num_trials == 1
    # The plain step takes any K ≥ 0; only the kernel stops at 99 trials.
    st = lm_state(np.eye(4), max_inner_iterations=100, device="cpu")
    assert st.errs.shape == (101,) and st.trials.shape == (100, 18)
    assert lm_state(np.eye(4), max_inner_iterations=0, device="cpu").num_trials == 0
    with pytest.raises(ValueError, match="max_inner_iterations"):
        lm_state(np.eye(4), max_inner_iterations=-1, device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        lm_state(np.eye(4), "bfgs", device="cpu")
    with pytest.raises(ValueError, match="solve_dtype"):
        gicp_lm_step(st, torch.zeros(44, dtype=torch.float64), torch.zeros(4, 16),
                     torch.zeros(4, 4), torch.tensor(0, dtype=torch.int32),
                     solve_dtype="float16")
