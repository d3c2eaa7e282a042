"""On-card checks of the port's CUDA kernels against their plain versions.

Every compiled instance runs here — K1 and K7 for each factor × robust
kernel, K2 and K8 for each robust kernel and pose count, K3 for both top-k
bounds, both K9 variants, the three list bounds of K10 and K12 and K11 below
and above 32 neighbours — at small shapes with padding rows, plus one small
registration (fused and unfused) and one small fleet on the card against
the CPU path. The tests need an NVIDIA card and skip without one.
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
from small_gicp_tpu_torch.models.registration import align_impl
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.ops.knn_cuda import (
    knn,
    knn_plain,
    knn_pruned,
    knn_pruned_launch,
    knn_T,
    nearest_neighbor,
    nearest_neighbor_plain,
    pruned_prepare_queries,
    target_centre,
)
from small_gicp_tpu_torch.ops.normals import estimate_covariances
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


# ----------------------------------------------------------- K9-K12 ----

def _search_clouds(dev, kind):
    """(target [cap,4], num_points, queries [Q,3]) on the card. ``scan``: a
    coherent 3,000-point surface in a 3,100-row table, 1,234 jittered
    queries taken as a [Q,3] view of [Q,4] rows; ``grid``: 1,000 points on
    an 8³ integer grid (exact distance ties), queried with themselves;
    ``tiny``: 3 valid rows; ``empty``: no valid row."""
    rng = np.random.default_rng(21)
    if kind == "grid":
        tp = rng.integers(0, 8, (1000, 3)).astype(np.float32)
        qp, cap = tp[:700], 1000
    else:
        tp = rng.uniform(-20, 20, size=(3000, 3)).astype(np.float32)
        tp[:, 2] = np.sin(tp[:, 0] * 0.4) + 0.05 * rng.normal(size=3000)
        qp = tp[rng.permutation(3000)[:1234]] + rng.normal(
            scale=0.05, size=(1234, 3)).astype(np.float32)
        cap = 3100
    n = {"tiny": 3, "empty": 0}.get(kind, len(tp))
    tgt = torch.as_tensor(_padded(tp[:n], cap), device=dev)
    num = torch.tensor(n, dtype=torch.int32, device=dev)
    q4 = torch.as_tensor(_padded(qp, len(qp)), device=dev)
    return tgt, num, q4[:, :3]


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_nearest_neighbor_kernel_matches_plain(dev, variant):
    for kind in ("scan", "grid", "tiny", "empty"):
        tgt, num, q = _search_clouds(dev, kind)
        before = nearest_neighbor.launches
        d, i = nearest_neighbor(tgt, num, q, variant)
        dp, ip = nearest_neighbor_plain(tgt, num, q, variant)
        torch.cuda.synchronize()
        assert nearest_neighbor.launches == before + 1
        # Same centre, same operation order, first index on ties: exact.
        assert i.dtype == torch.int32 and torch.equal(i, ip), (variant, kind)
        assert torch.equal(d, dp), (variant, kind)
    # The score |t|² − 2 q·t of a row carries a rounding error of up to
    # 2·2⁻²³·(|q| + |t|)² in the centred frame, twice that between two rows.
    # Per query, from its own reach and its winners': the two variants agree
    # on d² within that, and on the rows wherever the runner-up is farther.
    tgt, num, q = _search_clouds(dev, "scan")
    c = target_centre(tgt)
    dv, iv = nearest_neighbor(tgt, num, q, "vpu", c)
    dm, im = nearest_neighbor(tgt, num, q, "mxu", c)
    t_reach = torch.maximum((tgt[iv.long(), :3] - c).norm(dim=1),
                            (tgt[im.long(), :3] - c).norm(dim=1))
    tol = 4.0 * 2.0 ** -23 * ((q - c).norm(dim=1) + t_reach) ** 2
    d2, _ = knn(tgt, num, q, 2)
    clear = d2[:, 1] - d2[:, 0] > tol
    assert torch.equal(iv[clear], im[clear]) and int(clear.sum()) > 0.9 * len(q)
    assert bool(((dm - dv).abs() <= tol).all())


# K10 and K12 have list bounds 16, 32 and 64 (the smallest that holds k);
# K11 runs four warps per block up to k = 32 and two above.
@pytest.mark.parametrize("ks", [(1, 10, 16), (17, 32, 33, 64)])
@pytest.mark.parametrize("search", [knn, knn_T, knn_pruned])
def test_knn_kernels_match_plain(dev, search, ks):
    for kind in ("scan", "grid", "tiny", "empty"):
        tgt, num, q = _search_clouds(dev, kind)
        for k in ks:
            before = search.launches
            d, i = search(tgt, num, q, k)
            dp, ip = knn_plain(tgt, num, q, k)
            torch.cuda.synchronize()
            what = (search.__name__, kind, k)
            assert search.launches == before + 1, what
            assert d.shape == (q.shape[0], k) and i.dtype == torch.int32, what
            # Bitwise-equal d² and (d², index) order in all three kernels
            # and the plain version: exact, ties included.
            assert torch.equal(d, dp), what
            assert torch.equal(i, ip), what
            if kind == "tiny":
                assert torch.all(d[:, 3:] == 3e38) and torch.all(i[:, 3:] == 0), what


def test_search_wrappers_edges(dev):
    tgt, num, q = _search_clouds(dev, "scan")
    for fn in (knn, knn_T, knn_pruned):
        d, i = fn(tgt, num, q[:0], 5)
        assert d.shape == (0, 5) and i.shape == (0, 5)
        with pytest.raises(ValueError, match="k <= 64"):
            fn(tgt, num, q, 65)
        with pytest.raises(ValueError, match="float32"):
            fn(tgt.double(), num, q.double(), 5)
    assert nearest_neighbor(tgt, num, q[:0])[0].shape == (0,)
    # Contiguous [Q,3] queries and one query give the same rows as the view.
    d, i = knn(tgt, num, q, 7)
    dc, ic = knn(tgt, num, q.contiguous(), 7)
    d1, i1 = knn_pruned(tgt, num, q[5:6], 7)
    assert torch.equal(i, ic) and torch.equal(d, dc)
    assert torch.equal(i1[0], i[5]) and torch.equal(d1[0], d[5])


def test_kdtree_routes_to_the_kernels(dev):
    tgt, num, q = _search_clouds(dev, "scan")
    tree = KdTree(points=tgt, num_points=num)
    before = (nearest_neighbor.launches, knn.launches)
    d1, i1 = tree.nearest_neighbor_search(q)
    dk, ik = tree.knn_search(q, 10)
    ds, is_ = tree.knn_search(q[3], 10)
    d80, i80 = tree.knn_search(q[:50], 80)  # torch brute force, no kernel
    assert (nearest_neighbor.launches, knn.launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(i1, ik[:, 0]) and torch.equal(is_, ik[3])
    assert torch.equal(i80[:, :10], ik[:50]) and i80.dtype == torch.int32
    cpu = KdTree(points=tgt.cpu(), num_points=num.cpu())
    dc, ic = cpu.knn_search(q.cpu(), 10)
    assert torch.equal(ik.cpu(), ic) and torch.equal(dk.cpu(), dc)
    # The tree keeps K9's centre and the target half of K12's prologue.
    assert tree.centre() is tree.centre() and tree.pruned_target() is tree.pruned_target()
    assert torch.equal(tree.centre(), target_centre(tgt))
    dn, in_ = nearest_neighbor(tgt, num, q)
    assert torch.equal(i1, in_) and torch.equal(d1, dn)
    before = knn_pruned.launches
    tables = tree.pruned_target()
    dp, ip = knn_pruned(tgt, num, q, 10, target=tables)
    dl, il = knn_pruned_launch(tables, num, q, pruned_prepare_queries(tables, q), 10)
    assert knn_pruned.launches == before + 2
    assert torch.equal(ip, ik) and torch.equal(dp, dk)
    assert torch.equal(il, ik) and torch.equal(dl, dk)


def test_unfused_registration_card_matches_cpu(dev):
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    init = T_gt @ se3_exp(torch.tensor([0.01, -0.02, 0.02, 0.1, -0.15, 0.05],
                                       dtype=torch.float64)).numpy()
    out = {}
    for where in (dev, "cpu"):
        tgt, tree = preprocess_points(scans[0], 0.25, device=where)
        src, _ = preprocess_points(scans[1], 0.25, device=where)
        before = (nearest_neighbor.launches, gicp_linearize_tables.launches)
        out[where] = result_to_numpy(align_impl(tgt, src, tree, init,
                                                use_fused="never"))
        if where == dev:
            assert nearest_neighbor.launches == before[0] + out[dev]["iterations"] + 1
            assert gicp_linearize_tables.launches == before[1]
    a, c = out[dev], out["cpu"]
    dT = np.linalg.inv(c["T_target_source"].astype(np.float64)) @ a["T_target_source"]
    assert np.linalg.norm(dT[:3, 3]) <= 2e-3
    assert np.linalg.norm(dT[[2, 0, 1], [1, 2, 0]]) <= 2 * 0.1 * math.pi / 180.0
    assert abs(a["iterations"] - c["iterations"]) <= 1


def test_unfused_covariances_on_the_card(dev):
    """k > 64 and float64 clouds take the searched route instead of raising."""
    scans, _ = generate_sequence(n_frames=1, rings=16, azimuth_steps=256)
    pts = _padded(scans[0][:2000], 2100)
    for dtype, k in ((np.float32, 80), (np.float64, 10)):
        on_card = estimate_covariances(
            cloud_from_numpy(pts.astype(dtype), 2000, device=dev), num_neighbors=k)
        on_cpu = estimate_covariances(
            cloud_from_numpy(pts.astype(dtype), 2000, device="cpu"), num_neighbors=k)
        # The same neighbours, float sums in another order: the regularised
        # covariances agree to 1e-3 except where two eigenvalues nearly tie.
        diff = (on_card.covs.cpu() - on_cpu.covs).abs().amax(dim=(1, 2))
        assert float((diff <= 1e-3).float().mean()) >= 0.99, (dtype, k)
        assert torch.all(on_card.covs[2000:].cpu() == torch.eye(3, dtype=diff.dtype))
