"""On-card checks of the port's CUDA kernels against their plain versions.

Every compiled instance runs here — K1 (difference and score form, the
score form against its plain account, its brute-force plain version and
its first form), K12 at each of its teams, K6 and
K7 (the box-pruned fleet kernel, against its plain version and against the
brute-force lane kernel it replaced) for each factor × robust kernel, K2 and
K8 for each robust kernel and pose count, K3 for both top-k bounds, the
three list bounds of K4, K10 and K12, K5 and K11 below and above 32 neighbours (K11 and K5 also
against their first forms, K5 against K3 bit for bit over the kept sort), both K9 variants — at small shapes
with padding rows, K9 and K10 with one chunk and with many and against
their first forms, K4 and K6 against their first forms (K4 over more than
one cull pass, K6 at one chunk, at the planned count and above the live
tiles, and at a pose with no live tile), plus one small registration (fused on both routes and
unfused) and one small fleet on the card against the CPU path and at one
lane against 32; and the scan pair's walks — K3 with its team of threads a
query against its plain version, its plain account and its first form (the
brute-force scan it replaced) on every row, K1 in chunks against its plain
version, its
split plain account and its first form for each factor × robust kernel,
at a pose with no live tile, a radius of inf, an empty target and no
source rows, and in the source's row order. The tests need an NVIDIA card
and skip without one.
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
from small_gicp_tpu_torch.ops import gicp_fused_cuda
from small_gicp_tpu_torch.ops.cov_fused_cuda import (
    MOMENTS_Q_TEAM,
    _knn_moments_rows_q_v1,
    _knn_moments_rows_v1,
    _knn_topk_idx_v1,
    knn_moments,
    knn_moments_rows,
    knn_moments_rows_plain,
    knn_moments_rows_q,
    knn_moments_rows_q_plain,
    knn_topk_idx,
    knn_topk_idx_plain,
    knn_topk_idx_walk_plain,
    knn_moments_walk_plain,
)
from small_gicp_tpu_torch.ops.eigh3 import solve6x6
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    FACTORS,
    gicp_error_multi,
    _gicp_error_multi_fleet_k2,
    _gicp_linearize_fleet_brute,
    _gicp_linearize_listed_cuda,
    _gicp_linearize_swept_cuda,
    _gicp_linearize_score_v1,
    _gicp_linearize_v1,
    _gicp_linearize_swept_v1,
    fleet_live_tiles,
    gicp_error_multi_fleet,
    gicp_error_multi_fleet_plain,
    gicp_error_multi_plain,
    gicp_fleet_prepare,
    gicp_linearize_fleet,
    gicp_linearize_fleet_plain,
    gicp_linearize_listed_plain,
    gicp_linearize_plain,
    gicp_linearize_score,
    gicp_linearize_score_plain,
    gicp_linearize_score_walk_plain,
    gicp_linearize_swept,
    gicp_linearize_swept_plain,
    gicp_linearize_swept_split_plain,
    gicp_linearize_tables,
    gicp_prepare,
    swept_live_tiles,
    swept_plan,
)
from small_gicp_tpu_torch.models.registration import align_impl
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.ops import knn_cuda
from small_gicp_tpu_torch.ops.knn_cuda import (
    PRUNED_TEAMS,
    _knn_T_v1,
    _knn_pruned_v1,
    _knn_v1,
    _nearest_neighbor_v1,
    knn,
    knn_plain,
    knn_pruned,
    knn_pruned_launch,
    knn_pruned_plain,
    knn_T,
    nearest_neighbor,
    nearest_neighbor_plain,
    pruned_prepare_queries,
    target_centre,
)
from small_gicp_tpu_torch.ops.morton_boxes import CULL_PASS, TILE_ROWS, pruned_prepare_target
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
            before = gicp_linearize_fleet.launches
            H, b, inl, corr = gicp_linearize_fleet(tables, uids, Ts, 1.0, active,
                                                   robust, c)
            assert gicp_linearize_fleet.launches == before + 1
            Hp, bp, inlp, corrp = gicp_linearize_fleet_plain(tables, uids, Ts, 1.0,
                                                             active, robust, c)
            torch.cuda.synchronize()
            what = f"{factor} B={bsz} {robust}"
            mask = corr[..., 12] > 0.5
            assert torch.equal(mask, corrp[..., 12] > 0.5), what
            assert torch.equal(inl, inlp), what
            # Rows without a correspondence are zero with d² = 3e38 in both.
            assert torch.equal(corr[..., [0, 1, 2, 13]], corrp[..., [0, 1, 2, 13]]), what
            torch.testing.assert_close(corr[..., 3:12], corrp[..., 3:12],
                                       rtol=2e-3, atol=2e-3)
            unmatched = ~mask & active[:, None]
            assert torch.all(corr[unmatched][:, :13] == 0), what
            assert torch.all(corr[unmatched][:, 13] == 3.0e38), what
            scale = Hp.abs().amax(dim=(1, 2)).clamp(min=1.0)[:, None, None]
            torch.testing.assert_close(H / scale, Hp / scale, rtol=0, atol=5e-4)
            bscale = bp.abs().amax(dim=1).clamp(min=1.0)[:, None]
            torch.testing.assert_close(b / bscale, bp / bscale, rtol=0, atol=5e-4)
            idle = ~active
            assert torch.all(H[idle] == 0) and torch.all(corr[idle] == 0), what
            # Against the brute-force lane kernel it replaced: the same
            # winners on accepted rows, block sums over other groups of rows.
            H1, b1, inl1, corr1 = _gicp_linearize_fleet_brute(tables, uids, Ts, 1.0,
                                                              active, robust, c)
            torch.cuda.synchronize()
            assert torch.equal(mask, corr1[..., 12] > 0.5) and torch.equal(inl, inl1)
            assert torch.equal(corr[mask][:, [0, 1, 2, 13]],
                               corr1[mask][:, [0, 1, 2, 13]]), what
            torch.testing.assert_close(H / scale, H1 / scale, rtol=0, atol=5e-4)

            lambdas = 1e-3 * 10.0 ** torch.arange(10, dtype=torch.float32, device=dev)
            deltas = solve6x6(H.float()[:, None], -b.float()[:, None],
                              lambdas.expand(bsz, 10))
            all_Ts = torch.cat([Ts[:, None], Ts[:, None] @ se3_exp(deltas)], dim=1)
            before = gicp_error_multi_fleet.launches
            got = gicp_error_multi_fleet(corr, tables, uids, all_Ts, robust, c)
            assert gicp_error_multi_fleet.launches == before + 1
            ref = gicp_error_multi_fleet_plain(corr, tables, uids, all_Ts, robust, c)
            old = _gicp_error_multi_fleet_k2(corr, tables, uids, all_Ts, robust, c)
            torch.cuda.synchronize()
            assert got.dtype == torch.float64 and got.shape == (bsz, 11), what
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=0,
                                       msg=lambda m: f"{what}: {m}")
            torch.testing.assert_close(got, old, rtol=1e-5, atol=0,
                                       msg=lambda m: f"{what} (K2's kernel): {m}")
            assert torch.all(got[idle] == 0), what


def test_fleet_kernels_with_many_poses_and_a_far_lane(dev, fleet):
    """K8 above one pose chunk (100 poses), and K7 where the box cull
    leaves most tiles out (a lane shifted 6 m), against their plain
    versions."""
    tables = fleet["gicp"]
    uids, active, Ts = _lanes(dev, 5)
    Ts[1, 0, 3] += 6.0
    live = fleet_live_tiles(tables, uids, Ts, 1.0)
    assert not bool(live[1].all())
    H, b, inl, corr = gicp_linearize_fleet(tables, uids, Ts, 1.0, active)
    Hp, bp, inlp, corrp = gicp_linearize_fleet_plain(tables, uids, Ts, 1.0, active)
    torch.cuda.synchronize()
    assert torch.equal(inl, inlp)
    assert torch.equal(corr[..., [0, 1, 2, 12, 13]], corrp[..., [0, 1, 2, 12, 13]])
    g = torch.Generator().manual_seed(5)
    tw = torch.randn(5, 100, 6, generator=g, dtype=torch.float64) * 0.02
    all_Ts = (Ts.double().cpu()[:, None] @ se3_exp(tw)).float().to(dev)
    for robust, c in ROBUST:
        got = gicp_error_multi_fleet(corr, tables, uids, all_Ts, robust, c)
        ref = gicp_error_multi_fleet_plain(corr, tables, uids, all_Ts, robust, c)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)


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
    # A lane's work depends on nothing of another lane's: one lane and 32
    # give the same results bit for bit.
    one, many = (result_to_numpy(align_fleet(*clouds[dev], init, pair_ids=pair_ids,
                                             num_lanes=nl)) for nl in (1, 32))
    for key in one:
        assert np.array_equal(one[key], many[key]), key


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
        d1, i1 = _nearest_neighbor_v1(tgt, num, q, variant)
        torch.cuda.synchronize()
        assert torch.equal(i, i1) and torch.equal(d, d1), (variant, kind)
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


def _pruned_v1(tgt, num, q, k):
    """K12's first form over the prologue that the wrapper makes."""
    target = pruned_prepare_target(tgt, num)
    return _knn_pruned_v1(target, num, q, pruned_prepare_queries(target, q), k)


# K10 and K12 have list bounds 16, 32 and 64 (the smallest that holds k);
# K11 holds 4 queries a warp up to k = 16, 2 up to 32 and 1 above.
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
            first = {knn: _knn_v1, knn_T: _knn_T_v1, knn_pruned: _pruned_v1}[search]
            d1, i1 = first(tgt, num, q, k)
            torch.cuda.synchronize()
            assert torch.equal(d, d1) and torch.equal(i, i1), what
            if kind == "tiny":
                assert torch.all(d[:, 3:] == 3e38) and torch.all(i[:, 3:] == 0), what


@pytest.mark.parametrize("team", PRUNED_TEAMS)
def test_pruned_walk_at_every_team(dev, team):
    """K12 at each of its teams (queries a block 64 / team) and at 1, 64 and
    every query equals ``knn_plain`` and its plain account, which keeps the
    kernel's team and anchors; one launch a call."""
    for kind in ("scan", "grid", "tiny", "empty"):
        tgt, num, q = _search_clouds(dev, kind)
        target = pruned_prepare_target(tgt, num)
        for nq in (1, 64, q.shape[0]):
            sub = q[:nq]
            queries = pruned_prepare_queries(target, sub)
            for k in (1, 10, 33):
                before = knn_pruned.launches
                d, i = knn_pruned_launch(target, num, sub, queries, k, team=team)
                dp, ip = knn_plain(tgt, num, sub, k)
                torch.cuda.synchronize()
                what = (team, kind, nq, k)
                assert knn_pruned.launches == before + 1, what
                assert torch.equal(d, dp) and torch.equal(i, ip), what
        da, ia = knn_pruned_plain(tgt.cpu(), num.cpu(), q.cpu(), 10, team=team)
        d, i = knn_pruned_launch(target, num, q, queries, 10, team=team)
        assert torch.equal(da, d.cpu()) and torch.equal(ia, i.cpu()), (team, kind)
    # 1,500 points in a 2 m cube: ≈190 rows share each 1 m Morton cell, more
    # than the window, so each reach is taken across its cell's rows.
    rng = np.random.default_rng(3)
    tgt = torch.as_tensor(_padded(rng.uniform(0, 2, (1500, 3)), 1600), device=dev)
    num = torch.tensor(1500, dtype=torch.int32, device=dev)
    for k in (10, 33):
        d, i = knn_pruned(tgt, num, tgt[:, :3], k)
        dp, ip = knn_plain(tgt, num, tgt[:, :3], k)
        assert torch.equal(d, dp) and torch.equal(i, ip), (team, "dense", k)


# SPLIT_BLOCKS_PER_SM (K11: WARP_BLOCKS_PER_SM) = 0 plans one chunk (the
# block writes its results); 10⁶ plans one 256-row ring tile per chunk, the
# most chunks there can be.
@pytest.mark.parametrize("per_sm", [0, 10 ** 6])
def test_split_kernels_at_one_chunk_and_at_many(dev, monkeypatch, per_sm):
    monkeypatch.setattr(knn_cuda, "SPLIT_BLOCKS_PER_SM", per_sm)
    monkeypatch.setattr(knn_cuda, "WARP_BLOCKS_PER_SM", per_sm)
    for kind in ("scan", "grid", "tiny", "empty"):
        tgt, num, q = _search_clouds(dev, kind)
        for nq in (1, 64, q.shape[0]):
            for variant in ("vpu", "mxu"):
                d, i = nearest_neighbor(tgt, num, q[:nq], variant)
                dp, ip = nearest_neighbor_plain(tgt, num, q[:nq], variant)
                torch.cuda.synchronize()
                assert torch.equal(d, dp) and torch.equal(i, ip), (per_sm, kind, nq)
            for k in (1, 10, 33):
                dp, ip = knn_plain(tgt, num, q[:nq], k)
                for search in (knn, knn_T):
                    d, i = search(tgt, num, q[:nq], k)
                    torch.cuda.synchronize()
                    assert torch.equal(d, dp) and torch.equal(i, ip), (
                        search.__name__, per_sm, kind, nq, k)


def test_split_buffers_are_zero_between_launches(dev):
    """K9's keys, K10's bounds and the tickets of K9, K10 and K11 go back
    to 0 in every launch: the same calls again, and calls on other query
    counts in between, give the same results."""
    tgt, num, q = _search_clouds(dev, "scan")
    first = [nearest_neighbor(tgt, num, q, "mxu"), knn(tgt, num, q, 12),
             knn_T(tgt, num, q[:3], 12)]
    for nq in (5, 700, 1234):
        nearest_neighbor(tgt, num, q[:nq])
        knn(tgt, num, q[:nq], 20)
        knn_T(tgt, num, q[:nq], 20)
    again = [nearest_neighbor(tgt, num, q, "mxu"), knn(tgt, num, q, 12),
             knn_T(tgt, num, q[:3], 12)]
    torch.cuda.synchronize()
    for (d, i), (d2, i2) in zip(first, again):
        assert torch.equal(d, d2) and torch.equal(i, i2)
    buf = knn_cuda._buffers[(dev.index if dev.index is not None else 0,
                             torch.cuda.current_stream(dev).cuda_stream)]
    for t in (buf.keys, buf.bounds, buf.tickets):
        assert int(t.abs().sum()) == 0


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


# ---- the map-scale kernels: K4, K5, K6 and K1's score form -----------------

@pytest.fixture(scope="module")
def scan_cloud(dev):
    scans, _ = generate_sequence(n_frames=1, rings=16, azimuth_steps=256)
    pts = torch.as_tensor(_padded(scans[0][:3000], 3100), device=dev)
    return pts, torch.tensor(3000, dtype=torch.int32, device=dev)


# The three list bounds of K4: k ≤ 16, ≤ 32, ≤ 64.
@pytest.mark.parametrize("ks", [(1, 10, 16), (17, 20, 32), (33, 64)])
def test_topk_idx_kernel_matches_plain_and_k3(dev, scan_cloud, ks):
    pts, num = scan_cloud
    for k in ks:
        before = knn_topk_idx.launches
        d, i = knn_topk_idx(pts, num, k)
        dp, ip = knn_topk_idx_plain(pts, num, k)
        torch.cuda.synchronize()
        assert knn_topk_idx.launches == before + 1
        assert torch.equal(d, dp) and torch.equal(i, ip), k
        assert torch.all(d[3000:] == 3.0e38) and torch.all(i[3000:] == 0), k
        # Through the entry: K3's neighbours, the sums in another order.
        m1, m2, cnt = knn_moments(pts, num, k, layout="ti")
        a1, a2, acnt = knn_moments(pts, num, k, layout="t")
        assert torch.equal(cnt, acnt), k
        torch.testing.assert_close(m1, a1, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(m2, a2, rtol=1e-5, atol=1e-4)


def test_topk_idx_kernel_with_fewer_rows_than_k(dev):
    pts = torch.as_tensor(_padded(np.random.default_rng(3).normal(size=(7, 3)), 300),
                          device=dev).float()
    num = torch.tensor(7, dtype=torch.int32, device=dev)
    d, i = knn_topk_idx(pts, num, 10)
    dp, ip = knn_topk_idx_plain(pts, num, 10)
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert torch.all(d[:7, 7:] == 3.0e38) and torch.all(d[:7, :7] < 1e16)


# K5's team walk against its plain version, K3 (bit for bit: the same
# neighbours summed in the same order), its first form and its plain account,
# with and without the cloud's kept sort; below and above 32 neighbours.
@pytest.mark.parametrize("ks", [(1, 10, 20, 32), (33, 64)])
def test_moments_warp_kernel_matches_plain_and_k3(dev, scan_cloud, ks):
    pts, num = scan_cloud
    kept = pruned_prepare_target(pts, num)
    for k in ks:
        before = knn_moments_rows_q.launches
        got = knn_moments_rows_q(pts, num, k)
        ref = knn_moments_rows_q_plain(pts, num, k)
        k3 = knn_moments_rows(pts, num, k)
        torch.cuda.synchronize()
        assert knn_moments_rows_q.launches == before + 1
        assert torch.equal(got[:, 9:11], ref[:, 9:11]), k
        torch.testing.assert_close(got[:, :9], ref[:, :9], rtol=1e-5, atol=1e-4)
        assert torch.equal(got, k3), k
        assert torch.equal(got, knn_moments_rows_q(pts, num, k, target=kept)), k
        assert torch.equal(got, _knn_moments_rows_q_v1(pts, num, k)), k
        walk = knn_moments_walk_plain(pts.cpu(), num.cpu(), k, team=MOMENTS_Q_TEAM)
        assert torch.equal(got[:, 9:11].cpu(), walk[:, 9:11]), k
        assert torch.all(got[3000:] == 0), k


def _far_pair(dev):
    """A target of 5,000 rows spread over 60 m, so that most tiles are out
    of a source block's reach, and 700 shuffled source rows near some."""
    rng = np.random.default_rng(11)
    n, m = 700, 5000
    tp = rng.uniform(-30, 30, size=(m, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0] * 0.3) * 0.5
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
    return tgt, src


@pytest.mark.parametrize("factor", ["gicp", "plane_icp", "icp"])
def test_swept_kernel_matches_plain_and_k1(dev, pair, factor):
    T = pair[2]
    tgt, src = _far_pair(dev)
    tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                          factor, tgt.covs, src.covs, tgt.normals, route="swept")
    assert swept_live_tiles(tables, T, 1.0).float().mean().item() < 0.5
    for robust, c in ROBUST:
        before = gicp_linearize_swept.launches
        H, b, inl, corr = gicp_linearize_tables(tables, T, 1.0, robust, c)
        Hp, bp, inlp, corrp = gicp_linearize_swept_plain(tables, T, 1.0, robust, c)
        H1, b1, inl1, corr1 = gicp_linearize_tables(tables, T, 1.0, robust, c,
                                                    route="listed")
        torch.cuda.synchronize()
        assert gicp_linearize_swept.launches == before + 1
        mask = corr[:, 12] > 0.5
        assert torch.equal(mask, corrp[:, 12] > 0.5) and int(inl) == int(inlp)
        assert torch.equal(corr[:, [0, 1, 2, 13]], corrp[:, [0, 1, 2, 13]])
        torch.testing.assert_close(corr[:, 3:12], corrp[:, 3:12], rtol=2e-3, atol=2e-3)
        assert torch.all(corr[~mask][:, :13] == 0)
        scale = max(1.0, Hp.abs().max().item())
        torch.testing.assert_close(H / scale, Hp / scale, rtol=0, atol=5e-4)
        bscale = max(1.0, bp.abs().max().item())
        torch.testing.assert_close(b / bscale, bp / bscale, rtol=0, atol=5e-4)
        # Against K1 on the same tables: the same winners on accepted rows,
        # the same finalize, float32 block sums over other groups of 64 rows
        # (64·2⁻²⁴ ≈ 4e-6 of the summed magnitudes).
        assert torch.equal(mask, corr1[:, 12] > 0.5) and int(inl) == int(inl1)
        assert torch.equal(corr[mask], corr1[mask])
        torch.testing.assert_close(H / scale, H1 / scale, rtol=0, atol=1e-5)
        torch.testing.assert_close(b / bscale, b1 / bscale, rtol=0, atol=1e-5)


@pytest.mark.parametrize("factor", ["gicp", "plane_icp", "icp"])
def test_score_form_kernel_matches_plain(dev, pair, factor):
    """K1's score form (the box walk) against its plain account (every row:
    masks, μ and d² equal), its brute-force plain version and its first
    form. Those two take the score's winner over every valid row: the walk
    takes the same winner on every row where it is accepted, unless its
    exact d² lies within the score's rounding of the radius, 4·2⁻²³·(|q| +
    |t|)² (the score of a row is off by up to 2·2⁻²³·(|q| + |t|)², twice
    that between two rows)."""
    tgt, src, T = pair
    tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                          factor, tgt.covs, src.covs, tgt.normals)
    n = int(src.num_points)
    q = (src.points[:, :3] @ T[:3, :3].T + T[:3, 3])[:n]
    # The registration's radius, and inf (every tile live: the brute force's
    # winner on every row).
    for (robust, c), r in zip(ROBUST, (1.0, float("inf"), 1.0)):
        before = gicp_linearize_score.launches
        H, b, inl, corr = gicp_linearize_tables(tables, T, r, robust, c,
                                                mxu_dist=True)
        Hw, bw, inlw, corrw = gicp_linearize_score_walk_plain(tables, T, r, robust, c)
        Hp, bp, inlp, corrp = gicp_linearize_score_plain(tables, T, r, robust, c)
        _, _, _, corr1 = _gicp_linearize_score_v1(tables, T, r, robust, c)
        torch.cuda.synchronize()
        assert gicp_linearize_score.launches == before + 1
        mask = corr[:, 12] > 0.5
        assert torch.equal(mask, corrw[:, 12] > 0.5) and int(inl) == int(inlw)
        assert torch.equal(corr[:, [0, 1, 2, 13]], corrw[:, [0, 1, 2, 13]])
        assert torch.all(corr[~mask][:, :13] == 0)
        # The first form keeps every row's winner: its d² decides the rule.
        d_bf = corr1[:n, 13]
        tol = 4.0 * 2.0 ** -23 * (q.norm(dim=1) + corr1[:n, :3].norm(dim=1)) ** 2
        clear = (d_bf - r).abs() > tol
        for ref in (corrp, corr1):
            sel = clear & (ref[:n, 12] > 0.5)
            assert torch.equal(mask[:n][clear], ref[:n, 12][clear] > 0.5)
            assert torch.equal(corr[:n][sel][:, [0, 1, 2, 13]],
                               ref[:n][sel][:, [0, 1, 2, 13]])
        assert abs(int(inl) - int(inlp)) <= int((~clear).sum())
        sel = mask[:n] & clear
        torch.testing.assert_close(corr[:n][sel][:, 3:12], corrp[:n][sel][:, 3:12],
                                   rtol=2e-3, atol=2e-3)
        scale = max(1.0, Hp.abs().max().item())
        torch.testing.assert_close(H / scale, Hp / scale, rtol=0, atol=5e-4)
        bscale = max(1.0, bp.abs().max().item())
        torch.testing.assert_close(b / bscale, bp / bscale, rtol=0, atol=5e-4)


def test_small_registration_swept_route_matches_listed(dev):
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    init = T_gt @ se3_exp(torch.tensor([0.01, -0.02, 0.02, 0.1, -0.15, 0.05],
                                       dtype=torch.float64)).numpy()
    target, tree = preprocess_points(scans[0], device=dev)
    source, _ = preprocess_points(scans[1], device=dev)
    before = (gicp_linearize_swept.launches, gicp_linearize_tables.launches)
    a = result_to_numpy(align_impl(target, source, tree, init, fused_route="swept"))
    assert gicp_linearize_swept.launches == before[0] + a["iterations"] + 1
    assert gicp_linearize_tables.launches == before[1]
    # the tree's kept sort and boxes serve the swept tables: the same result
    # as tables that are sorted and boxed anew
    bare = result_to_numpy(align_impl(target, source, None, init, fused_route="swept"))
    assert np.array_equal(bare["T_target_source"], a["T_target_source"])
    c = result_to_numpy(align_impl(target, source, tree, init))
    dT = np.linalg.inv(c["T_target_source"].astype(np.float64)) @ a["T_target_source"]
    assert np.linalg.norm(dT[:3, 3]) <= 2e-3
    assert np.linalg.norm(dT[[2, 0, 1], [1, 2, 0]]) <= 2 * 0.1 * math.pi / 180.0
    assert abs(a["iterations"] - c["iterations"]) <= 1


# ---- the box walks redesigned: K4 in cull passes, K6 in chunks -------------

def _sheet(dev, m, cap, seed):
    """m points of a wavy sheet (no ties) in a table of cap rows."""
    rng = np.random.default_rng(seed)
    side = math.sqrt(m) * 0.2
    xy = rng.uniform(-side, side, size=(m, 2))
    z = 0.4 * np.sin(0.2 * xy[:, 0]) + 0.02 * rng.normal(size=m)
    pts = torch.as_tensor(_padded(np.c_[xy, z], cap), device=dev).float()
    return pts, torch.tensor(m, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("k", [10, 20, 64])
def test_topk_idx_walk_matches_plain_and_first_form(dev, scan_cloud, k):
    # The scan (one pass) and a sheet of more tiles than a cull pass holds.
    big = _sheet(dev, (CULL_PASS + 40) * TILE_ROWS, (CULL_PASS + 41) * TILE_ROWS, 5)
    for pts, num in (scan_cloud, big):
        target = pruned_prepare_target(pts, num)
        before = knn_topk_idx.launches
        d, i = knn_topk_idx(pts, num, k, target=target)
        d1, i1 = _knn_topk_idx_v1(target, num, k)
        torch.cuda.synchronize()
        assert knn_topk_idx.launches == before + 1
        assert torch.equal(d, d1) and torch.equal(i, i1), k
        rows = torch.arange(0, pts.shape[0], 7, device=dev)
        dp, ip = knn_topk_idx_plain(pts, num, k, rows=rows)
        assert torch.equal(d[rows], dp) and torch.equal(i[rows], ip), k
    pts, num = scan_cloud
    dw, iw = knn_topk_idx_walk_plain(pts, num, k)
    d, i = knn_topk_idx(pts, num, k)
    assert torch.equal(d, dw) and torch.equal(i, iw)


def _wide_pair(dev, m):
    """A target of m rows spread over a plane wider than the source's
    reach, and 2,000 source rows near part of it: many tiles, most of them
    culled, more than one cull pass where m > 65,536."""
    rng = np.random.default_rng(m)
    side = math.sqrt(m) * 0.25
    tp = rng.uniform(-side, side, size=(m, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0] * 0.3) * 0.5
    n = 2000
    sp = tp[rng.permutation(m)[:n]] + rng.normal(scale=0.05, size=(n, 3)).astype(
        np.float32)
    covs = lambda k, cap: np.tile(np.eye(3, dtype=np.float32) * 0.02, (cap, 1, 1))
    normals = np.zeros((m + 20, 4), np.float32)
    normals[:m, 2] = 1.0
    tgt = cloud_from_numpy(_padded(tp, m + 20), m, normals=normals,
                           covs=covs(m, m + 20), device=dev)
    src = cloud_from_numpy(_padded(sp, n + 100), n, covs=covs(n, n + 100), device=dev)
    return tgt, src


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("factor", ["gicp", "plane_icp", "icp"])
def test_swept_chunks_match_first_form_and_split_plain(dev, pair, factor):
    T = pair[2]
    for tgt, src in (_far_pair(dev), _wide_pair(dev, 90_000)):
        tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                              factor, tgt.covs, src.covs, tgt.normals, route="swept")
        live = swept_live_tiles(tables, T, 1.0)
        planned = swept_plan(tables)
        above = int(live.sum(dim=1).max()) + 3
        for robust, c in ((None, 1.0), ("huber", 0.5)):
            old = _gicp_linearize_swept_v1(tables, T, 1.0, robust, c)
            before = gicp_linearize_swept.launches
            new = gicp_linearize_tables(tables, T, 1.0, robust, c)
            torch.cuda.synchronize()
            assert gicp_linearize_swept.launches == before + 1
            assert _same(new, old), (factor, robust)
            for chunks in (1, planned, above):
                got = _gicp_linearize_swept_cuda(tables, T, 1.0, robust, c, chunks)
                ref = gicp_linearize_swept_split_plain(tables, T, 1.0, robust, c,
                                                       chunks=chunks)
                torch.cuda.synchronize()
                assert _same(got, old), (factor, robust, chunks)
                mask = got[3][:, 12] > 0.5
                assert torch.equal(got[3][:, [12, 13]], ref[3][:, [12, 13]])
                assert torch.equal(got[3][mask][:, :3], ref[3][mask][:, :3])
    ws = gicp_fused_cuda._swept_buffers[(dev.index if dev.index is not None else 0,
                                         torch.cuda.current_stream(dev).cuda_stream)]
    assert bool((ws.keys == -1).all()) and bool((ws.tickets == 0).all())


def test_swept_chunks_at_a_pose_without_live_tiles(dev):
    tgt, src = _far_pair(dev)
    tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                          "gicp", tgt.covs, src.covs, route="swept")
    T = torch.eye(4, device=dev)
    T[:3, 3] = torch.tensor([1e4, -3e3, 50.0])
    assert not swept_live_tiles(tables, T, 1.0).any()
    new = gicp_linearize_tables(tables, T, 1.0)
    old = _gicp_linearize_swept_v1(tables, T, 1.0)
    plain = gicp_linearize_swept_plain(tables, T, 1.0)
    torch.cuda.synchronize()
    assert _same(new, old) and _same(new, plain)
    assert int(new[2]) == 0 and not new[3][:, :13].any()
    assert bool((new[3][:, 13] == 3.0e38).all())


# ---- the scan pair's walks: K3 with a team a query, K1 in chunks ------------

def _grid_cloud(dev):
    """3,000 points in 24³ integer cells (every distance ties many times)."""
    rng = np.random.default_rng(24)
    pts = torch.as_tensor(_padded(rng.integers(0, 24, (3000, 3)), 3100),
                          device=dev).float()
    return pts, torch.tensor(3000, dtype=torch.int32, device=dev)


# The three list bounds of K3: k ≤ 16, ≤ 32, ≤ 64.
@pytest.mark.parametrize("ks", [(1, 10, 16), (17, 20, 32), (33, 64)])
def test_moments_walk_kernel_matches_first_form_and_plain(dev, scan_cloud, ks):
    for pts, num in (scan_cloud, _grid_cloud(dev)):
        target = pruned_prepare_target(pts, num)
        for k in ks:
            before = knn_moments_rows.launches
            got = knn_moments_rows(pts, num, k, target=target)
            torch.cuda.synchronize()
            assert knn_moments_rows.launches == before + 1
            # The first form's neighbours summed in its order: every row bit
            # for bit, and the same without the kept sort.
            assert torch.equal(got, _knn_moments_rows_v1(pts, num, k)), k
            assert torch.equal(got, knn_moments_rows(pts, num, k)), k
            # The plain version: the same neighbours (counts, d_k), the sums
            # to their float32 rounding (the kernel's are fused multiply-adds).
            ref = knn_moments_rows_plain(pts, num, k)
            assert torch.equal(got[:, 9:11], ref[:, 9:11]), k
            torch.testing.assert_close(got[:, :9], ref[:, :9], rtol=1e-5, atol=1e-4)
            assert torch.all(got[3000:] == 0), k
    pts, num = scan_cloud
    walk = knn_moments_walk_plain(pts.cpu(), num.cpu(), 10)
    got = knn_moments_rows(pts, num, 10).cpu()
    assert torch.equal(got[:, 9:11], walk[:, 9:11])
    torch.testing.assert_close(got[:, :9], walk[:, :9], rtol=1e-5, atol=1e-4)


def test_moments_walk_kernel_edges(dev):
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(_padded(rng.normal(size=(7, 3)), 300), device=dev).float()
    for valid in (7, 0):
        num = torch.tensor(valid, dtype=torch.int32, device=dev)
        got = knn_moments_rows(pts, num, 10)
        torch.cuda.synchronize()
        assert torch.equal(got, _knn_moments_rows_v1(pts, num, 10)), valid
        assert torch.equal(got[:, 9:11], knn_moments_rows_plain(pts, num, 10)[:, 9:11])
        assert torch.all(got[valid:] == 0)
    with pytest.raises(ValueError, match="target="):
        knn_moments_rows(pts, num, 10, target=pruned_prepare_target(pts[:200], num))


def _listed_checks(tables, T, max_d2, robust, c):
    """K1 on ``tables`` at T: equal to its plain version (masks, inliers,
    every corr row but W exact, W to 2e-3, H and b to 5e-4 scaled), to its
    split plain account at one chunk, the planned count and above the live
    tiles (the same, μ and d² on every row), and to its first form on the
    rows the first form accepts (masks, inliers, μ and d²); one launch a
    call. Returns the kernel's outputs."""
    before = gicp_linearize_tables.launches
    out = gicp_linearize_tables(tables, T, max_d2, robust, c)
    torch.cuda.synchronize()
    assert gicp_linearize_tables.launches == before + 1

    def close(got, ref):
        assert torch.equal(got[3][:, [0, 1, 2, 12, 13]], ref[3][:, [0, 1, 2, 12, 13]])
        assert int(got[2]) == int(ref[2])
        torch.testing.assert_close(got[3][:, 3:12], ref[3][:, 3:12], rtol=2e-3,
                                   atol=2e-3)
        scale = max(1.0, ref[0].abs().max().item())
        torch.testing.assert_close(got[0] / scale, ref[0] / scale, rtol=0, atol=5e-4)
        bscale = max(1.0, ref[1].abs().max().item())
        torch.testing.assert_close(got[1] / bscale, ref[1] / bscale, rtol=0, atol=5e-4)

    close(out, gicp_linearize_listed_plain(tables, T, max_d2, robust, c))
    live = swept_live_tiles(tables, T, max_d2)
    for chunks in (1, swept_plan(tables), int(live.sum(dim=1).max()) + 3):
        got = _gicp_linearize_listed_cuda(tables, T, max_d2, robust, c, chunks)
        close(got, gicp_linearize_swept_split_plain(tables, T, max_d2, robust, c,
                                                   chunks=chunks))
        assert torch.equal(got[3], out[3]) and torch.equal(got[2], out[2]), chunks
    old = _gicp_linearize_v1(tables, T, max_d2, robust, c)
    mask = out[3][:, 12] > 0.5
    assert torch.equal(mask, old[3][:, 12] > 0.5) and int(out[2]) == int(old[2])
    assert torch.equal(out[3][mask][:, [0, 1, 2, 13]], old[3][mask][:, [0, 1, 2, 13]])
    assert not out[3][~mask][:, :13].any() and bool((out[3][~mask][:, 13] == 3e38).all())
    scale = max(1.0, old[0].abs().max().item())
    torch.testing.assert_close(out[0] / scale, old[0] / scale, rtol=0, atol=5e-4)
    return out


@pytest.mark.parametrize("factor", ["gicp", "plane_icp", "icp"])
def test_listed_kernel_matches_plain_split_and_first_form(dev, pair, factor):
    T = pair[2]
    for tgt, src in ((pair[0], pair[1]), _far_pair(dev)):
        tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                              factor, tgt.covs, src.covs, tgt.normals)
        assert tables.route == "listed" and tables.sperm is not None
        for robust, c in ROBUST:
            _listed_checks(tables, T, 1.0, robust, c)
    ws = gicp_fused_cuda._swept_buffers[(dev.index if dev.index is not None else 0,
                                         torch.cuda.current_stream(dev).cuda_stream)]
    assert bool((ws.keys == -1).all()) and bool((ws.tickets == 0).all())


def test_listed_kernel_edges(dev, pair):
    tgt, src, T = pair
    args = (tgt.points, tgt.num_points, src.points, src.num_points, "gicp", tgt.covs,
            src.covs)
    tables = gicp_prepare(*args)
    far = T.clone()
    far[:3, 3] += 1000.0
    out = _listed_checks(tables, far, 1.0, None, 1.0)
    assert int(out[2]) == 0 and not out[0].any()
    out = _listed_checks(tables, T, float("inf"), None, 1.0)
    assert int(out[2]) == int(src.num_points)
    # In the source's row order (blocks of 64 consecutive rows): the same
    # winners, the block sums over other groups of rows.
    rows = gicp_prepare(*args)
    rows.sperm = torch.arange(rows.qtab.shape[0], dtype=torch.int32, device=dev)
    a = _listed_checks(rows, T, 1.0, "huber", 0.5)
    b = gicp_linearize_tables(tables, T, 1.0, "huber", 0.5)
    assert torch.equal(a[3], b[3]) and int(a[2]) == int(b[2])
    for tn, sn in ((0, None), (None, 0)):
        t = gicp_prepare(tgt.points, tgt.num_points if tn is None else
                         torch.zeros_like(tgt.num_points), src.points,
                         src.num_points if sn is None else torch.zeros_like(src.num_points),
                         "gicp", tgt.covs, src.covs)
        out = _listed_checks(t, T, 1.0, None, 1.0)
        assert int(out[2]) == 0 and not out[3][:, :13].any()

