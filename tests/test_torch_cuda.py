"""On-card checks of the port's CUDA kernels against their plain versions.

Every compiled instance runs here — K1 and K7 for each factor × robust
kernel, K2 and K8 for each robust kernel and pose count, K3 for both top-k
bounds — at small shapes with padding rows, plus one small registration
and one small fleet on the card against the CPU path. The tests need an NVIDIA card and skip without one.
This file imports neither JAX nor the JAX package, so on the card it runs
without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from small_gicp_tpu_torch.interop import cloud_from_numpy, result_to_numpy
from small_gicp_tpu_torch.models.helper import align, preprocess_points
from small_gicp_tpu_torch.ops.cov_fused_cuda import (
    knn_moments_rows,
    knn_moments_rows_plain,
)
from small_gicp_tpu_torch.ops.eigh3 import solve6x6
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    FACTORS,
    gicp_error_multi,
    gicp_error_multi_fleet,
    gicp_error_multi_fleet_plain,
    gicp_error_multi_plain,
    gicp_fleet_prepare,
    gicp_linearize_fleet,
    gicp_linearize_fleet_plain,
    gicp_linearize_plain,
    gicp_linearize_tables,
    gicp_prepare,
)
from small_gicp_tpu_torch.parallel.fleet import align_fleet
from small_gicp_tpu_torch.point_cloud import stack_clouds
from small_gicp_tpu_torch.utils.lie import se3_exp
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _padded(x, cap):
    out = np.full((cap, 4), 1e9, np.float32)
    out[:, 3] = 0.0
    out[:len(x), :3] = x
    out[:len(x), 3] = 1.0
    return out


@pytest.fixture(scope="module")
def pair(dev):
    rng = np.random.default_rng(7)
    n, m = 700, 900
    tp = rng.uniform(-8, 8, size=(m, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0]) * 0.5 + 0.05 * rng.normal(size=m)
    sp = tp[rng.permutation(m)[:n]] + rng.normal(scale=0.05, size=(n, 3)).astype(
        np.float32)

    def covs(k, cap):
        a = rng.normal(size=(k, 3, 3)).astype(np.float32) * 0.05
        c = np.zeros((cap, 3, 3), np.float32)
        c[:k] = np.einsum("nij,nkj->nik", a, a) + np.eye(3, dtype=np.float32) * 0.01
        return c

    nrm = rng.normal(size=(m, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    normals = np.zeros((m + 20, 4), np.float32)
    normals[:m, :3] = nrm
    tgt = cloud_from_numpy(_padded(tp, m + 20), m, normals=normals,
                           covs=covs(m, m + 20), device=dev)
    src = cloud_from_numpy(_padded(sp, n + 12), n, covs=covs(n, n + 12), device=dev)
    T = se3_exp(torch.tensor([0.02, -0.01, 0.03, 0.05, -0.1, 0.08])).float().to(dev)
    return tgt, src, T


ROBUST = [(None, 1.0), ("huber", 0.5), ("cauchy", 0.3)]


# The KMAX = 16 instance serves k ≤ 16, the KMAX = 64 one 16 < k ≤ 64.
@pytest.mark.parametrize("ks", [(1, 10, 16), (17, 40, 64)])
def test_knn_moments_kernel_matches_plain(dev, ks):
    scans, _ = generate_sequence(n_frames=1, rings=16, azimuth_steps=256)
    pts = torch.as_tensor(_padded(scans[0][:3000], 3100), device=dev)
    num = torch.tensor(3000, dtype=torch.int32, device=dev)
    for k in ks:
        got = knn_moments_rows(pts, num, k)
        ref = knn_moments_rows_plain(pts, num, k)
        torch.cuda.synchronize()
        # Same neighbours (bitwise-equal d², lower-index ties): counts and
        # d_k are exact. Moments agree to the float32 rounding of sums of
        # up to 64 products, which reach ~1e3 m² on a raw scan: relative 1e-5.
        assert torch.equal(got[:, 9], ref[:, 9]), k
        assert torch.equal(got[:3000, 10], ref[:3000, 10]), k
        torch.testing.assert_close(got[:, :9], ref[:, :9], rtol=1e-5, atol=1e-4,
                                   msg=lambda m: f"k={k}: {m}")
        assert torch.all(got[3000:] == 0), k


@pytest.mark.parametrize("factor", ["gicp", "plane_icp", "icp"])
def test_linearize_kernel_matches_plain(dev, pair, factor):
    for robust, c in ROBUST:
        _check_linearize(pair, factor, robust, c)


def _check_linearize(pair, factor, robust, c):
    tgt, src, T = pair
    tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                          factor, tgt.covs, src.covs, tgt.normals)
    H, b, inl, corr = gicp_linearize_tables(tables, T, 1.0, robust, c)
    Hp, bp, inlp, corrp = gicp_linearize_plain(tables, T, 1.0, robust, c)
    torch.cuda.synchronize()
    mask = corr[:, 12] > 0.5
    assert torch.equal(mask, corrp[:, 12] > 0.5) and int(inl) == int(inlp)
    assert torch.equal(corr[mask][:, [0, 1, 2, 13]], corrp[mask][:, [0, 1, 2, 13]])
    torch.testing.assert_close(corr[mask][:, 3:12], corrp[mask][:, 3:12],
                               rtol=2e-3, atol=2e-3)
    scale = max(1.0, Hp.abs().max().item())
    torch.testing.assert_close(H / scale, Hp / scale, rtol=0, atol=5e-4)
    bscale = max(1.0, bp.abs().max().item())
    torch.testing.assert_close(b / bscale, bp / bscale, rtol=0, atol=5e-4)


def test_error_multi_kernel_matches_plain(dev, pair):
    tgt, src, T = pair
    tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                          "gicp", tgt.covs, src.covs)
    _, _, _, corr = gicp_linearize_tables(tables, T, 1.0)
    for k1 in (1, 11, 100):
        g = torch.Generator().manual_seed(k1)
        tw = torch.randn(k1, 6, generator=g, dtype=torch.float64) * 0.02
        Ts = (T.double().cpu() @ se3_exp(tw)).float().to(dev)
        for robust, c in ROBUST:
            got = gicp_error_multi(corr, src.points, Ts, src.num_points, robust, c)
            ref = gicp_error_multi_plain(corr, src.points, Ts, src.num_points,
                                         robust, c)
            torch.cuda.synchronize()
            assert got.dtype == torch.float64 and got.shape == (k1,)
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=0,
                                       msg=lambda m: f"{k1} {robust}: {m}")


def test_wrappers_reject_what_the_kernels_do_not_take(dev, pair):
    tgt, src, T = pair
    with pytest.raises(ValueError, match="float32"):
        knn_moments_rows(tgt.points.double(), tgt.num_points, 10)
    with pytest.raises(ValueError, match="contiguous"):
        knn_moments_rows(tgt.points.t().contiguous().t(), tgt.num_points, 10)
    with pytest.raises(ValueError, match="int32"):
        knn_moments_rows(tgt.points, tgt.num_points.long(), 10)


def test_small_registration_card_matches_cpu(dev):
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    init = T_gt @ se3_exp(torch.tensor([0.01, -0.02, 0.02, 0.1, -0.15, 0.05],
                                       dtype=torch.float64)).numpy()
    before = (gicp_linearize_tables.launches, gicp_error_multi.launches,
              knn_moments_rows.launches)
    a = result_to_numpy(align(scans[0], scans[1], init_T_target_source=init,
                              device=dev))
    c = result_to_numpy(align(scans[0], scans[1], init_T_target_source=init,
                              device="cpu"))
    after = (gicp_linearize_tables.launches, gicp_error_multi.launches,
             knn_moments_rows.launches)
    assert all(y > x for x, y in zip(before, after))
    dT = np.linalg.inv(c["T_target_source"].astype(np.float64)) @ a["T_target_source"]
    assert np.linalg.norm(dT[:3, 3]) <= 2e-3
    assert np.linalg.norm(dT[[2, 0, 1], [1, 2, 0]]) <= 2 * 0.1 * math.pi / 180.0
    assert abs(a["iterations"] - c["iterations"]) <= 1


@pytest.fixture(scope="module")
def fleet(dev):
    """Fleet tables of three pairs at one capacity (920 target, 712 source
    rows): 900/700, 850/640 and 880/0 valid rows (the last pair has no
    source points)."""
    rng = np.random.default_rng(9)
    cols = {"tp": [], "tn": [], "tc": [], "nrm": [], "sp": [], "sn": [], "sc": []}
    for m, n in ((900, 700), (850, 640), (880, 0)):
        tp = rng.uniform(-8, 8, size=(m, 3)).astype(np.float32)
        tp[:, 2] = np.sin(tp[:, 0]) * 0.5 + 0.05 * rng.normal(size=m)
        sp = tp[rng.permutation(m)[:n]] + rng.normal(scale=0.05, size=(n, 3)).astype(
            np.float32)
        for key, k, cap in (("tc", m, 920), ("sc", n, 712)):
            a = rng.normal(size=(k, 3, 3)).astype(np.float32) * 0.05
            c = np.zeros((cap, 3, 3), np.float32)
            c[:k] = np.einsum("nij,nkj->nik", a, a) + np.eye(3, dtype=np.float32) * 0.01
            cols[key].append(c)
        nrm = np.zeros((920, 4), np.float32)
        nrm[:m, :3] = rng.normal(size=(m, 3))
        nrm[:m, :3] /= np.linalg.norm(nrm[:m, :3], axis=1, keepdims=True)
        cols["tp"].append(_padded(tp, 920))
        cols["sp"].append(_padded(sp, 712))
        cols["tn"].append(m)
        cols["sn"].append(n)
        cols["nrm"].append(nrm)

    def put(key):
        return torch.as_tensor(np.stack(cols[key]), device=dev)

    return {factor: gicp_fleet_prepare(
        put("tp"), put("tn").int(), put("sp"), put("sn").int(), factor, put("tc"),
        put("sc"), put("nrm")) for factor in FACTORS}


def _lanes(dev, bsz):
    """Lane → pair ids, active flags (every fourth lane idle) and poses."""
    uids = torch.arange(bsz, device=dev, dtype=torch.int32) % 3
    active = torch.arange(bsz, device=dev) % 4 != 3
    g = torch.Generator().manual_seed(bsz)
    tw = torch.randn(bsz, 6, generator=g, dtype=torch.float64) * 0.02
    Ts = (se3_exp(torch.tensor([0.02, -0.01, 0.03, 0.05, -0.1, 0.08],
                               dtype=torch.float64)) @ se3_exp(tw)).float().to(dev)
    return uids, active, Ts


@pytest.mark.parametrize("factor", FACTORS)
def test_fleet_kernels_match_plain(dev, fleet, factor):
    tables = fleet[factor]
    for bsz in (1, 5, 32):
        uids, active, Ts = _lanes(dev, bsz)
        for robust, c in ROBUST:
            H, b, inl, corr = gicp_linearize_fleet(tables, uids, Ts, 1.0, active,
                                                   robust, c)
            Hp, bp, inlp, corrp = gicp_linearize_fleet_plain(tables, uids, Ts, 1.0,
                                                             active, robust, c)
            torch.cuda.synchronize()
            what = f"{factor} B={bsz} {robust}"
            mask = corr[..., 12] > 0.5
            assert torch.equal(mask, corrp[..., 12] > 0.5), what
            assert torch.equal(inl, inlp), what
            assert torch.equal(corr[mask][:, [0, 1, 2, 13]],
                               corrp[mask][:, [0, 1, 2, 13]]), what
            torch.testing.assert_close(corr[mask][:, 3:12], corrp[mask][:, 3:12],
                                       rtol=2e-3, atol=2e-3)
            scale = Hp.abs().amax(dim=(1, 2)).clamp(min=1.0)[:, None, None]
            torch.testing.assert_close(H / scale, Hp / scale, rtol=0, atol=5e-4)
            bscale = bp.abs().amax(dim=1).clamp(min=1.0)[:, None]
            torch.testing.assert_close(b / bscale, bp / bscale, rtol=0, atol=5e-4)
            idle = ~active
            assert torch.all(H[idle] == 0) and torch.all(corr[idle] == 0), what

            lambdas = 1e-3 * 10.0 ** torch.arange(10, dtype=torch.float32, device=dev)
            deltas = solve6x6(H.float()[:, None], -b.float()[:, None],
                              lambdas.expand(bsz, 10))
            all_Ts = torch.cat([Ts[:, None], Ts[:, None] @ se3_exp(deltas)], dim=1)
            got = gicp_error_multi_fleet(corr, tables, uids, all_Ts, robust, c)
            ref = gicp_error_multi_fleet_plain(corr, tables, uids, all_Ts, robust, c)
            torch.cuda.synchronize()
            assert got.dtype == torch.float64 and got.shape == (bsz, 11), what
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=0,
                                       msg=lambda m: f"{what}: {m}")


def test_small_fleet_card_matches_cpu(dev):
    scans, poses = generate_sequence(n_frames=3, rings=16, azimuth_steps=256)
    clouds = {}
    for where in (dev, "cpu"):
        pre = [preprocess_points(s, 0.25, max_points=4096, device=where)[0]
               for s in scans]
        clouds[where] = (stack_clouds(pre[:2]), stack_clouds(pre[1:]))
    g = np.random.default_rng(3)
    gts = [np.linalg.inv(poses[u]) @ poses[u + 1] for u in (0, 1)]
    pair_ids = np.arange(6) % 2
    init = np.stack([gts[u] @ se3_exp(torch.as_tensor(
        np.r_[g.normal(size=3) * 0.02, g.normal(size=3) * 0.1])).numpy()
        for u in pair_ids]).astype(np.float32)
    before = (gicp_linearize_fleet.launches, gicp_error_multi_fleet.launches)
    a = result_to_numpy(align_fleet(*clouds[dev], init, pair_ids=pair_ids,
                                    num_lanes=4))
    after = (gicp_linearize_fleet.launches, gicp_error_multi_fleet.launches)
    c = result_to_numpy(align_fleet(*clouds["cpu"], init, pair_ids=pair_ids,
                                    num_lanes=4))
    assert all(y > x for x, y in zip(before, after))
    for p in range(6):
        dT = (np.linalg.inv(c["T_target_source"][p].astype(np.float64))
              @ a["T_target_source"][p])
        assert np.linalg.norm(dT[:3, 3]) <= 2e-3
        assert np.linalg.norm(dT[[2, 0, 1], [1, 2, 0]]) <= 2 * 0.1 * math.pi / 180.0
        assert abs(int(a["iterations"][p]) - int(c["iterations"][p])) <= 1
