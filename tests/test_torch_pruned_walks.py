"""K12 (the pruned exact kNN) and K1's score form on the box walks that the
port shares, as their plain accounts, on the CPU.

K12 walks the Morton-sorted target in cull passes from each block's anchor
(the box of its median query's insertion position), its queries in the
same Morton order, each query's list seeded with the kth d² over the
sorted rows around it and merged over a team of threads;
``knn_pruned_plain`` follows it and must equal ``knn_plain`` bit for bit
(both round every operation of the difference form and break ties by the
original row) at 1, 64 and every query, k = 1-64, on a downsampled scan
and on a duplicate-heavy grid of 14³ cells, with queries outside the
target's extent and padding rows among them; and ``knn_pallas_pruned`` in
interpret mode on inputs without exact ties (indices equal, d² to rtol
1e-6: XLA on the CPU contracts the distance into fused multiply-adds, and
the Pallas kernel orders ties by the sorted frame's index).

K1's score form deals each source block's live tiles (those within the
rejector radius of the block) to its chunks and ranks every row of a tile
within the radius of the point by the score ‖t‖² − 2 t·q;
``gicp_linearize_score_walk_plain`` follows it. Against the brute-force
``gicp_linearize_score_plain`` it must pick the same winner (μ and d² bit
for bit, masks equal) on every row whose brute-force winner is accepted and
whose exact d² lies farther from the radius than the score's rounding,
4·2⁻²³·(|q| + |t|)²; against the Pallas listed kernel with
``mxu_dist=True`` it meets the bounds of
tests/test_gicp_fused.py::test_mxu_dist_variant_matches_vpu_form.

The walk that K3, K4 and K5 share moved to ``ops/morton_boxes.py``; their
accounts still equal the brute-force plain versions bit for bit. Inputs come
from seeded numpy generators and the repository's synthetic scan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops import gicp_fused_pallas as jfused
from small_gicp_tpu.ops.knn_pallas import knn_pallas_pruned
from small_gicp_tpu.utils.lie import se3_exp as j_se3_exp
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.ops.cov_fused_cuda import (
    MOMENTS_Q_TEAM,
    MOMENTS_TEAM,
    knn_moments_rows_plain,
    knn_moments_walk_plain,
    knn_topk_idx_plain,
    knn_topk_idx_walk_plain,
)
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    gicp_linearize_plain,
    gicp_linearize_score,
    gicp_linearize_score_plain,
    gicp_linearize_score_walk_plain,
    gicp_prepare,
    score_norms,
)
from small_gicp_tpu_torch.ops.knn_cuda import (
    PRUNED_TEAMS,
    knn_plain,
    knn_pruned,
    knn_pruned_plain,
    pruned_plan,
)
from small_gicp_tpu_torch.utils.synthetic import generate_sequence


def _pad4(xyz, cap):
    out = np.full((cap, 4), 1e9, np.float32)
    out[:, 3] = 0.0
    out[:len(xyz), :3] = xyz
    out[:len(xyz), 3] = 1.0
    return out


def _num(n):
    return torch.tensor(n, dtype=torch.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The accounts run many small torch ops; the suite runs several worker
    processes on the same cores, where intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def clouds():
    """(points [cap,4], valid rows, queries [Q,3]) of a downsampled 16-ring
    × 128-step frame (≈1.5k rows), of 2,000 points in 14³ integer cells
    (every distance ties many times) in a 2,100-row table, and of 1,200
    points in a 2 m cube (≈150 rows share each 1 m Morton cell, more than
    the 64-row window: the reach is taken across the cell's rows). The
    queries are every row of the table (padding rows at 1e9 among them) and
    40 points outside the target's extent."""
    scans, _ = generate_sequence(n_frames=1, rings=16, azimuth_steps=128)
    scan = voxelgrid_sampling(scans[0], 0.25, device="cpu")
    rng = np.random.default_rng(24)
    grid = torch.as_tensor(_pad4(rng.integers(0, 14, (2000, 3)).astype(np.float32), 2100))
    dense = torch.as_tensor(_pad4(rng.uniform(0, 2, (1200, 3)).astype(np.float32), 1250))
    out = {}
    for kind, (pts, num) in {"scan": (scan.points, scan.num_points),
                             "grid": (grid, _num(2000)),
                             "dense": (dense, _num(1200))}.items():
        lo, hi = pts[:int(num), :3].amin(0), pts[:int(num), :3].amax(0)
        far = torch.as_tensor(rng.uniform(-1, 1, (40, 3)), dtype=torch.float32)
        outside = torch.where(far < 0, lo - 30 + 20 * far, hi + 30 + 20 * far)
        out[kind] = (pts, num, torch.cat([pts[:, :3], outside]))
    return out


# ---- K12 --------------------------------------------------------------------

# Teams of 1 and 4 threads on the scan, 2 and 8 on the grid, 4 on the dense
# cube; passes of the kernel's 256 boxes, or of 2 boxes so that every block
# walks several passes outwards from its anchor.
@pytest.mark.parametrize("kind,team,cull_pass", [("scan", 1, 256), ("scan", 4, 2),
                                                 ("grid", 2, 2), ("grid", 8, 256),
                                                 ("dense", 4, 2)])
def test_pruned_account_equals_knn_plain_bit_for_bit(clouds, kind, team, cull_pass):
    pts, num, queries = clouds[kind]
    for nq in (1, 64, queries.shape[0]):
        # Queries from the middle of the table first: the first row's
        # neighbours alone would not leave the anchor's pass.
        sub = queries.roll(-queries.shape[0] // 3, dims=0)[:nq]
        for k in (1, 10, 20, 64):
            d, i = knn_pruned_plain(pts, num, sub, k, team=team, cull_pass=cull_pass)
            dp, ip = knn_plain(pts, num, sub, k)
            assert torch.equal(d, dp) and torch.equal(i, ip), (nq, k)
    if kind == "grid":
        # Exact ties are there, and they go to the lower original row.
        tied = dp[:, 1:] == dp[:, :-1]
        assert bool(tied.any()) and bool((ip[:, 1:] > ip[:, :-1])[tied].all())


def test_pruned_account_with_few_or_no_valid_rows():
    pts = torch.as_tensor(_pad4(np.float32([[0, 0, 0], [1, 0, 0], [0, 2, 0]]), 600))
    q = torch.as_tensor(np.float32([[0.1, 0, 0], [5, 5, 5], [1e9, 1e9, 1e9]]))
    # No valid row, one, and fewer than k: empty slots hold 3e38 and index 0.
    for valid in (0, 1, 3):
        for team in PRUNED_TEAMS:
            d, i = knn_pruned_plain(pts, _num(valid), q, 5, team=team)
            dp, ip = knn_plain(pts, _num(valid), q, 5)
            assert torch.equal(d, dp) and torch.equal(i, ip), (valid, team)
        assert bool((d[:, valid:] == 3.0e38).all()) and not i[:, valid:].any()
    assert knn_pruned_plain(pts, _num(3), q[:0], 5)[0].shape == (0, 5)


def test_pruned_account_matches_pallas_interpret():
    """A wavy surface with jittered queries, some beyond its extent: no exact
    ties, so the Pallas kernel's tie order does not show."""
    rng = np.random.default_rng(31)
    m, qn, k = 900, 300, 20
    tp = rng.uniform(-20, 20, size=(m, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0] * 0.4) + 0.05 * rng.normal(size=m)
    qp = tp[rng.permutation(m)[:qn]] + rng.normal(scale=0.05, size=(qn, 3)).astype(
        np.float32)
    qp[:20] += 35.0
    t4, q4 = np.c_[tp, np.ones(m, np.float32)], np.c_[qp, np.ones(qn, np.float32)]
    jd, ji = knn_pallas_pruned(jnp.asarray(t4), jnp.asarray(q4), k, interpret=True)
    for team, cull_pass in ((1, 256), (4, 1)):
        d, i = knn_pruned_plain(torch.as_tensor(t4), _num(m), torch.as_tensor(q4), k,
                                team=team, cull_pass=cull_pass)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=0)
    # The entry point on the CPU is the plain version.
    got = knn_pruned(torch.as_tensor(t4), _num(m), torch.as_tensor(qp), k)
    assert torch.equal(got[0], d) and torch.equal(got[1], i)


def test_pruned_plan_fills_the_card():
    # 132 SMs at 8 blocks each: 1,056 blocks of 64 / team queries.
    assert PRUNED_TEAMS == (2, 4, 8)
    assert pruned_plan(108_043, 132) == 2
    assert pruned_plan(21_366, 132) == 4
    assert pruned_plan(4_096, 132) == 8
    assert pruned_plan(1, 132) == PRUNED_TEAMS[-1]
    assert pruned_plan(21_366, 132, per_sm=2) == 2


# ---- K1's score form --------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The 700 / 900-point pair of tests/test_gicp_fused.py, with 20 padding
    rows behind each cloud."""
    rng = np.random.default_rng(7)
    n, m = 700, 900
    tp = rng.uniform(-8, 8, size=(m, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0]) * 0.5 + 0.05 * rng.normal(size=m)
    sp = tp[rng.permutation(m)[:n]] + rng.normal(scale=0.05, size=(n, 3)).astype(
        np.float32)

    def covs(k):
        a = rng.normal(size=(k, 3, 3)).astype(np.float32) * 0.05
        return np.einsum("nij,nkj->nik", a, a) + np.eye(3, dtype=np.float32) * 0.01

    return dict(tp=_pad4(tp, m + 20), sp=_pad4(sp, n + 20), tc=covs(m + 20),
                sc=covs(n + 20), tn=m, sn=n)


def _tables(pair, factor):
    nrm = np.tile(np.float32([0, 0, 1, 0]), (len(pair["tp"]), 1))
    tgt = cloud_from_numpy(pair["tp"], pair["tn"], covs=pair["tc"], normals=nrm,
                           device="cpu")
    src = cloud_from_numpy(pair["sp"], pair["sn"], covs=pair["sc"], device="cpu")
    return gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points, factor,
                        tgt.covs, src.covs, tgt.normals)


def _T(scale=1.0):
    tw = np.float32([0.02, -0.01, 0.03, 0.05, -0.1, 0.08]) * scale
    return np.array(j_se3_exp(jnp.asarray(tw)))


# The radius of the registration, a small one (most rows rejected, many
# winners near it) and inf (every tile live); factors and robust kernels.
@pytest.mark.parametrize("factor,robust,c", [("gicp", None, 1.0), ("plane_icp", "huber", 0.5),
                                             ("icp", "cauchy", 0.3)])
@pytest.mark.parametrize("max_d2", [1.0, 0.002, float("inf")])
def test_score_walk_account_matches_brute_force(pair, factor, robust, c, max_d2):
    tables = _tables(pair, factor)
    n = pair["sn"]
    for scale in (1.0, 8.0):
        T = torch.as_tensor(_T(scale))
        H, b, inl, corr = gicp_linearize_score_walk_plain(tables, T, max_d2, robust, c)
        Hp, bp, inlp, corrp = gicp_linearize_score_plain(tables, T, max_d2, robust, c)
        # The brute-force winner of every row (the first form's plain version
        # keeps rejected rows' winners) decides where the rule holds.
        _, _, _, corr1 = gicp_linearize_plain(tables, T, max_d2, robust, c, score=True)
        q = tables.qtab[:n, :3] @ T[:3, :3].T.float() + T[:3, 3].float()
        tol = 4.0 * 2.0 ** -23 * (q.norm(dim=1) + corr1[:n, :3].norm(dim=1)) ** 2
        clear = (corr1[:n, 13] - max_d2).abs() > tol
        assert bool(clear.float().mean() > 0.9)
        mask = corr[:n, 12] > 0.5
        assert torch.equal(mask[clear], corrp[:n, 12][clear] > 0.5)
        sel = mask & clear
        assert torch.equal(corr[:n][sel], corrp[:n][sel])
        # Unmatched rows hold zeros and d² = 3e38 in both.
        assert torch.all(corr[:n][~mask][:, :13] == 0)
        assert torch.all(corr[:n][~mask][:, 13] == 3.0e38)
        assert torch.all(corrp[:n][corrp[:n, 12] < 0.5][:, :13] == 0)
        # The sums: float64 over the same float32 rows where the winners
        # agree; a row near the radius may be in one and not the other.
        assert abs(int(inl) - int(inlp)) <= int((~clear).sum())
        if bool(clear.all()):
            assert torch.equal(H, Hp) and torch.equal(b, bp)
        scale_h = max(1.0, Hp.abs().max().item())
        torch.testing.assert_close(H / scale_h, Hp / scale_h, rtol=0, atol=5e-4)


def test_score_walk_account_matches_pallas_mxu_dist(pair):
    T = _T()
    n = pair["sn"]
    sp = pair["sp"][:n]
    ttab, tb, qtab, _, sperm, ttab_T = jfused.gicp_prepare(
        jnp.asarray(pair["tp"][:pair["tn"]]), jnp.asarray(pair["tc"][:pair["tn"]]),
        jnp.asarray(sp), jnp.asarray(pair["sc"][:n]), jnp.asarray(n, jnp.int32))
    jH, _, jinl, corr16 = jfused.gicp_linearize_tables(
        ttab, tb, qtab, jnp.asarray(T), jnp.float32(1.0), ttab_T, interpret=True,
        mxu_dist=True)
    jcorr = np.zeros((n, 16), np.float32)
    jcorr[np.asarray(sperm)] = np.asarray(corr16)[:, :n].T
    H, _, inl, corr = gicp_linearize_score_walk_plain(_tables(pair, "gicp"),
                                                      torch.as_tensor(T), 1.0)
    H, corr = H.numpy(), corr.numpy()[:n]
    # tests/test_gicp_fused.py's bounds: ties at the score's rounding may flip
    # a membership.
    assert int(inl) == int(jinl)
    m0, m1 = jcorr[:, 12] > 0.5, corr[:, 12] > 0.5
    assert (m0 != m1).mean() < 0.01
    scale = max(1.0, np.abs(np.asarray(jH)).max())
    np.testing.assert_allclose(H / scale, np.asarray(jH) / scale, atol=5e-4)
    both = m0 & m1
    np.testing.assert_allclose(corr[both, 13], jcorr[both, 13], atol=1e-4)
    np.testing.assert_allclose(corr[both, 0:3], jcorr[both, 0:3], atol=1e-5)


def test_score_norms_follow_the_sort(pair):
    tables = _tables(pair, "gicp")
    norms = score_norms(tables)
    assert score_norms(tables) is norms  # gathered once per tables
    m = tables.ttab.shape[0]
    orig = tables.tsorted[:, 3].contiguous().view(torch.int32).long()
    assert norms.shape == (-(-m // 256) * 256,)
    assert torch.equal(norms[:m], tables.ttab[orig, 13]) and not norms[m:].any()
    # The entry point on the CPU is the brute-force plain version.
    T = torch.as_tensor(_T())
    got = gicp_linearize_score(tables, T, 1.0)
    want = gicp_linearize_score_plain(tables, T, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---- K3, K4, K5 through the moved walk ---------------------------------------

@pytest.mark.parametrize("cull_pass,k", [(256, 20), (2, 10)])
def test_moved_walk_accounts_equal_brute_force(clouds, cull_pass, k):
    pts, num = clouds["scan"][:2]
    rows = knn_moments_rows_plain(pts, num, k)
    for team in (MOMENTS_TEAM, MOMENTS_Q_TEAM):
        got = knn_moments_walk_plain(pts, num, k, team=team, cull_pass=cull_pass)
        assert torch.equal(got, rows), team
    d, i = knn_topk_idx_walk_plain(pts, num, k, cull_pass)
    dp, ip = knn_topk_idx_plain(pts, num, k)
    assert torch.equal(d, dp) and torch.equal(i, ip)
