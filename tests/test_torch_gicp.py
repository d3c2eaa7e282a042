"""Port parity of the fused GICP kernels' plain versions: K1 (search +
linearize) against ``gicp_linearize_pallas`` and K2 (trial errors)
against ``gicp_error_multi_pallas``, both in interpret mode, over every
factor and robust kernel the kernels switch on.

Inputs (700 source / 900 target points) are made with numpy, as
tests/test_gicp_fused.py makes them, and fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.gicp_fused_pallas import (
    gicp_error_multi_pallas,
    gicp_linearize_pallas,
)
from small_gicp_tpu.utils.lie import se3_exp as j_se3_exp
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    gicp_error_multi,
    gicp_linearize_tables,
    gicp_prepare,
)

TWIST = [0.02, -0.01, 0.03, 0.05, -0.1, 0.08]


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    n, m = 700, 900
    tp = rng.uniform(-8, 8, size=(m, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0]) * 0.5 + 0.05 * rng.normal(size=m)
    sp = tp[rng.permutation(m)[:n]] + rng.normal(scale=0.05, size=(n, 3)).astype(
        np.float32)

    def pad(x, cap):
        out = np.full((cap, 4), 1e9, np.float32)
        out[:, 3] = 0.0
        out[:len(x), :3] = x
        out[:len(x), 3] = 1.0
        return out

    def covs(k, cap):
        a = rng.normal(size=(k, 3, 3)).astype(np.float32) * 0.05
        c = np.zeros((cap, 3, 3), np.float32)
        c[:k] = np.einsum("nij,nkj->nik", a, a) + np.eye(3, dtype=np.float32) * 0.01
        return c

    nrm = rng.normal(size=(m, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    normals = np.zeros((m + 20, 4), np.float32)
    normals[:m, :3] = nrm
    # padded capacities with sentinel rows, as downsampling produces them
    return dict(tp=pad(tp, m + 20), sp=pad(sp, n + 12), tn=m, sn=n,
                tc=covs(m, m + 20), sc=covs(n, n + 12), normals=normals)


def _T():
    return np.array(j_se3_exp(jnp.asarray(TWIST, jnp.float32)))


def _port_linearize(pair, factor, robust, c, T):
    tgt = cloud_from_numpy(pair["tp"], pair["tn"], normals=pair["normals"],
                           covs=pair["tc"], device="cpu")
    src = cloud_from_numpy(pair["sp"], pair["sn"], covs=pair["sc"], device="cpu")
    tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                          factor, tgt.covs, src.covs, tgt.normals)
    return gicp_linearize_tables(tables, torch.as_tensor(T), 1.0, robust, c), src


ROBUST = [(None, 1.0), ("huber", 0.5), ("cauchy", 0.3)]


@pytest.mark.parametrize("factor", ["gicp", "plane_icp", "icp"])
def test_linearize_plain_matches_pallas_interpret(pair, factor):
    for robust, c in ROBUST:
        _check_linearize(pair, factor, robust, c)


def _check_linearize(pair, factor, robust, c):
    T = _T()
    (H, b, inliers, corr), _ = _port_linearize(pair, factor, robust, c, T)
    gicp = factor == "gicp"
    jH, jb, jmu, jW, jmask, jsq, _, _ = gicp_linearize_pallas(
        jnp.asarray(pair["tp"]), jnp.asarray(pair["tc"]) if gicp else None,
        jnp.asarray(pair["sp"]), jnp.asarray(pair["sc"]) if gicp else None,
        jnp.asarray(T), jnp.asarray(pair["sn"], jnp.int32),
        jnp.asarray(1.0, jnp.float32), interpret=True, factor=factor,
        target_normals=jnp.asarray(pair["normals"]), robust=robust, robust_c=c,
    )
    corr = corr.numpy()
    mask = corr[:, 12] > 0.5
    jmask = np.asarray(jmask)
    # Tolerances of tests/test_gicp_fused.py: the mask is exact; μ, d² and
    # W on inlier rows agree to float32 rounding; H and b, scaled by their
    # largest entry, to 5e-4 (different float32 summation orders).
    np.testing.assert_array_equal(mask, jmask)
    assert int(inliers) == int(mask.sum())
    np.testing.assert_allclose(corr[mask, 0:3], np.asarray(jmu)[mask], atol=1e-5)
    np.testing.assert_allclose(corr[mask, 13], np.asarray(jsq)[mask],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(corr[mask, 3:12].reshape(-1, 3, 3),
                               np.asarray(jW)[mask], rtol=2e-3, atol=2e-3)
    jH, jb = np.asarray(jH), np.asarray(jb)
    scale = max(1.0, float(np.abs(jH).max()))
    np.testing.assert_allclose(H.numpy() / scale, jH / scale, atol=5e-4)
    bscale = max(1.0, float(np.abs(jb).max()))
    np.testing.assert_allclose(b.numpy() / bscale, jb / bscale, atol=5e-4)
    assert H.dtype == torch.float64 and b.dtype == torch.float64


def test_error_multi_plain_matches_pallas_interpret(pair):
    T = _T()
    (_, _, _, corr), src = _port_linearize(pair, "gicp", None, 1.0, T)
    Ts = np.stack([
        T,
        np.asarray(j_se3_exp(jnp.asarray([0.01, 0.0, -0.02, 0.02, 0.03, -0.05],
                                         jnp.float32))) @ T,
        np.eye(4, dtype=np.float32),
    ])
    # The same frozen rows in the JAX kernel's [16, QP] layout, padded to
    # whole 512-row blocks with masked-out rows.
    n = corr.shape[0]
    qp = (n + 511) // 512 * 512
    corr16 = np.zeros((16, qp), np.float32)
    corr16[:, :n] = corr.numpy().T
    for robust, c in ROBUST:
        got = gicp_error_multi(corr, src.points, torch.as_tensor(Ts),
                               src.num_points, robust, c).numpy()
        want = np.asarray(gicp_error_multi_pallas(
            jnp.asarray(corr16), jnp.asarray(pair["sp"]), jnp.asarray(Ts),
            jnp.asarray(pair["sn"], jnp.int32), interpret=True, robust=robust,
            robust_c=c))
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=2e-5, err_msg=str(robust))


def test_linearize_handles_padding_and_empty(pair):
    T = np.eye(4, dtype=np.float32)
    tgt = cloud_from_numpy(pair["tp"], pair["tn"], covs=pair["tc"], device="cpu")
    src = cloud_from_numpy(pair["sp"], 37, covs=pair["sc"], device="cpu")
    tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                          "gicp", tgt.covs, src.covs)
    H, b, inliers, corr = gicp_linearize_tables(tables, torch.as_tensor(T), 1.0)
    assert int(corr[37:, 12].sum()) == 0 and int(inliers) <= 37
    assert torch.isfinite(H).all() and torch.isfinite(b).all()
    tables.qnum = torch.tensor(0, dtype=torch.int32)
    H, b, inliers, corr = gicp_linearize_tables(tables, torch.as_tensor(T), 1.0)
    assert int(inliers) == 0 and not corr[:, 12].any()
    assert torch.all(H == 0) and torch.all(b == 0)
    tables.qnum = torch.tensor(pair["sn"], dtype=torch.int32)
    tables.tnum = torch.tensor(0, dtype=torch.int32)  # no target rows at all
    H, b, inliers, corr = gicp_linearize_tables(tables, torch.as_tensor(T), 1.0)
    assert int(inliers) == 0 and torch.all(corr[:, 0:3] == 0)


def test_wrappers_validate_arguments(pair):
    (_, _, _, corr), src = _port_linearize(pair, "icp", None, 1.0, _T())
    with pytest.raises(ValueError, match="poses"):
        gicp_error_multi(corr, src.points, torch.eye(4).expand(101, 4, 4),
                         src.num_points)
    with pytest.raises(ValueError, match="robust"):
        gicp_error_multi(corr, src.points, torch.eye(4)[None], src.num_points,
                         "tukey")
    with pytest.raises(ValueError, match="factor"):
        gicp_prepare(src.points, src.num_points, src.points, src.num_points, "ndt")


def test_factors_match_jax_and_the_fused_path(pair):
    for robust, c in ROBUST[:2]:
        _check_factors(pair, robust, c)


def _check_factors(pair, robust, c):
    from small_gicp_tpu.models import factors as jf
    from small_gicp_tpu_torch.models import factors as tf

    T = _T()
    (H_k, b_k, _, corr), src = _port_linearize(pair, "gicp", robust, c, T)
    n = corr.shape[0]
    mu, W, mask = corr[:, 0:3], corr[:, 3:12].reshape(n, 3, 3), corr[:, 12] > 0.5
    Tt = torch.as_tensor(T)
    H, b, e = tf.linearize(tf.Correspondences(mu, W, mask, torch.zeros(n)), Tt,
                           src.points, robust, c)
    jcorr = jf.Correspondences(target_mu=jnp.asarray(mu.numpy()),
                               W=jnp.asarray(W.numpy()),
                               mask=jnp.asarray(mask.numpy()),
                               target_idx=jnp.zeros(n, jnp.int32))
    jH, jb, je = jf.linearize(jcorr, jnp.asarray(T), jnp.asarray(src.points.numpy()),
                              robust, c)
    scale = max(1.0, float(np.abs(np.asarray(jH)).max()))
    np.testing.assert_allclose(H.numpy() / scale, np.asarray(jH) / scale, atol=5e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(e), float(je), rtol=1e-5)
    # The fused path's float64 block sums carry the same system.
    np.testing.assert_allclose(H.numpy() / scale, H_k.numpy() / scale, atol=5e-4)
    Ts = np.stack([T, np.eye(4, dtype=np.float32)])
    np.testing.assert_allclose(
        tf.error_multi(tf.Correspondences(mu, W, mask, torch.zeros(n)),
                       torch.as_tensor(Ts), src.points, robust, c).numpy(),
        np.asarray(jf.error_multi(jcorr, jnp.asarray(Ts),
                                  jnp.asarray(src.points.numpy()), robust, c)),
        rtol=1e-5)
    # Weights and Jacobian on their own.
    covs = torch.as_tensor(pair["sc"][:n])
    np.testing.assert_allclose(
        tf.make_weights("gicp", Tt, n, covs, None, covs).numpy(),
        np.asarray(jf.make_weights("gicp", jnp.asarray(T), n, jnp.asarray(covs.numpy()),
                                   None, jnp.asarray(covs.numpy()))),
        rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        tf.geometric_jacobian(Tt, src.points[:, :3]).numpy(),
        np.asarray(jf.geometric_jacobian(jnp.asarray(T),
                                         jnp.asarray(src.points.numpy()[:, :3]))),
        rtol=1e-6, atol=1e-3)
