"""The two warp-per-query kernels, K11 (``knn_T``, ``csrc/knn.cu``) and K5
(layout "q" of ``knn_moments``, ``csrc/cov_fused.cu``), as their plain
accounts on the CPU.

K11 cuts the valid target rows into chunks; in each chunk a query takes a
bound from the chunk's strided sample (the kth smallest of 32 lanes'
minima), every lane keeps the k first of its rows (every 32nd) within it,
the lanes' lists give the chunk's list, and the chunks' lists are merged
lane by lane. ``knn_T_split_plain`` follows that step by step and must
equal ``knn_plain`` bit for bit at Q = 1, 64 and all rows, k = 1, 10, 20,
64, at several chunk counts, on a synthetic scan and on a duplicate-heavy
grid of integer cells, and ``knn_pallas_T`` in interpret mode on tie-free
inputs (indices exact, d² to rtol 1e-6: the compiled JAX kernel may fuse
a multiply-add, ROADMAP.md C).

K5 walks the cloud's Morton sort in K3's cull passes with ``MOMENTS_Q_TEAM``
lanes a query (``64 // MOMENTS_Q_TEAM`` queries a block);
``knn_moments_walk_plain(team=MOMENTS_Q_TEAM)`` is that account and must
equal the brute-force ``knn_moments_rows_plain`` bit for bit, and the
Pallas ``knn_moments_pallas(layout="q")`` in interpret mode on counts
(exact) and moments (tests/test_torch_cov_layouts.py's tolerances), its kth
distance ``knn_pallas_T``'s. ``knn_moments(layout="q", target=...)`` takes
the KdTree's kept sort and makes none of its own. Inputs come from seeded
numpy generators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.cov_fused_pallas import knn_moments_pallas
from small_gicp_tpu.ops.knn_pallas import knn_pallas_T
from small_gicp_tpu_torch.models.helper import preprocess_points
from small_gicp_tpu_torch.ops import cov_fused_cuda, knn_cuda, morton_boxes
from small_gicp_tpu_torch.ops.cov_fused_cuda import (
    MOMENTS_Q_TEAM,
    knn_moments,
    knn_moments_rows,
    knn_moments_rows_plain,
    knn_moments_walk_plain,
)
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.knn_cuda import (
    knn_plain,
    knn_T,
    knn_T_split_plain,
    warp_block_queries,
    warp_plan,
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
def scans():
    return generate_sequence(n_frames=1, rings=16, azimuth_steps=256)


@pytest.fixture(scope="module")
def clouds(scans):
    """A downsampled 16-ring frame (≈3k rows in a 3,776-row table) and
    2,500 points in 14³ integer cells (every distance ties many times) in a
    2,600-row table."""
    scan = voxelgrid_sampling(scans[0][0], 0.25, device="cpu")
    rng = np.random.default_rng(24)
    grid = _pad4(rng.integers(0, 14, (2500, 3)).astype(np.float32), 2600)
    return {"scan": (scan.points, scan.num_points),
            "grid": (torch.as_tensor(grid), _num(2500))}


# ---- K11 --------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 10, 20, 64])
@pytest.mark.parametrize("kind", ["scan", "grid"])
def test_split_warp_account_equals_plain_bit_for_bit(clouds, kind, k):
    pts, num = clouds[kind]
    m = int(num)
    queries = pts[:m, :3]
    ref = knn_plain(pts, num, queries, k)
    # One chunk, a few, the plan on a card of 132 SMs, and one 256-row ring
    # tile a chunk (the most there can be).
    for nq in (1, 64, m):
        for nsplit in sorted({1, 3, warp_plan(nq, pts.shape[0], k, 132),
                              -(-m // knn_cuda.SPLIT_TILE)}):
            d, i = knn_T_split_plain(pts, num, queries[:nq], k, nsplit)
            assert torch.equal(d, ref[0][:nq]), (nq, nsplit)
            assert torch.equal(i, ref[1][:nq]), (nq, nsplit)


def test_split_warp_account_matches_pallas_T_interpret():
    rng = np.random.default_rng(5)
    m, q, k = 1500, 600, 10
    tp = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
    qp = rng.uniform(-10, 10, (q, 3)).astype(np.float32)
    t4 = np.c_[tp, np.ones(m, np.float32)]
    jd, ji = knn_pallas_T(jnp.asarray(t4), jnp.asarray(qp), k, interpret=True)
    for nsplit in (1, 4):
        d, i = knn_T_split_plain(torch.as_tensor(t4), _num(m), torch.as_tensor(qp), k,
                                 nsplit)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    # The entry point on the CPU is the plain version.
    got = knn_T(torch.as_tensor(t4), _num(m), torch.as_tensor(qp), k)
    assert torch.equal(got[1], i) and torch.equal(got[0], d)


def test_split_warp_account_edges():
    pts = torch.as_tensor(_pad4(np.float32([[0, 0, 0], [1, 0, 0], [0, 2, 0]]), 600))
    q = torch.as_tensor(np.float32([[0.1, 0, 0], [5, 5, 5]]))
    # No valid row, one, and fewer than k: empty slots hold 3e38 and index 0.
    for valid in (0, 1, 3):
        ref = knn_plain(pts, _num(valid), q, 5)
        for nsplit in (1, 2, 3):
            d, i = knn_T_split_plain(pts, _num(valid), q, 5, nsplit)
            assert torch.equal(d, ref[0]) and torch.equal(i, ref[1]), (valid, nsplit)
        assert bool((d[:, valid:] == 3.0e38).all()) and not i[:, valid:].any()
    assert knn_T_split_plain(pts, _num(3), q[:0], 5, 2)[0].shape == (0, 5)


def test_lane_bound_holds_k_rows():
    """The chunk bound is the d² of a real row with at least k rows at or
    below it, so it never cuts a true neighbour."""
    rng = np.random.default_rng(9)
    t = torch.as_tensor(rng.normal(size=(3000, 3)).astype(np.float32))
    q = torch.as_tensor(rng.normal(size=(50, 3)).astype(np.float32))
    d2 = knn_cuda.sq_dists(q, t)
    for k in (1, 10, 32, 33, 64):
        b = knn_cuda._lane_bound(d2, k)
        assert bool(((d2 <= b[:, None]).sum(1) >= k).all()), k
        assert bool((d2 == b[:, None]).any(1).all()), k


def test_warp_plan_fills_the_card_at_few_queries():
    # 96 KB of lane lists a block: k = 10, 8 warps of 4 queries; k = 16, 6
    # of 4; k = 20, 8 of 2; k = 33, 8 of 1; k = 64, 6 of 1.
    assert [warp_block_queries(k) for k in (1, 10, 16, 20, 32, 33, 64)] == [
        32, 32, 24, 16, 12, 8, 6]
    # One query over 21,366 rows: a chunk per 256-row ring tile; many
    # queries: one chunk.
    assert warp_plan(1, 21366, 10, 132) == 84
    assert warp_plan(21366, 21366, 10, 132) == 1
    assert warp_plan(64, 21366, 10, 132) * 2 >= 132


# ---- K5 ---------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 10, 20, 64])
@pytest.mark.parametrize("kind", ["scan", "grid"])
def test_warp_walk_account_equals_plain_bit_for_bit(clouds, kind, k):
    pts, num = clouds[kind]
    got = knn_moments_walk_plain(pts, num, k, team=MOMENTS_Q_TEAM)
    ref = knn_moments_rows_plain(pts, num, k)
    assert torch.equal(got, ref)
    assert bool((got[:int(num), 9] == min(k, int(num))).all())


def test_warp_walk_account_matches_pallas_q_interpret():
    rng = np.random.default_rng(21)
    n, pad, k = 1500, 60, 10
    xy = rng.uniform(-20, 20, size=(n, 2))
    z = 0.4 * np.sin(0.2 * xy[:, 0]) + 0.02 * rng.normal(size=n)
    sheet = _pad4(np.c_[xy, z].astype(np.float32), n + pad)
    jm1, jm2, jc = knn_moments_pallas(jnp.asarray(sheet), jnp.asarray(n, jnp.int32), k,
                                      interpret=True, layout="q")
    rows = knn_moments_walk_plain(torch.as_tensor(sheet), _num(n), k,
                                  team=MOMENTS_Q_TEAM).numpy()
    m2 = rows[:, [3, 4, 5, 4, 6, 7, 5, 7, 8]].reshape(-1, 3, 3)
    # tests/test_torch_cov_layouts.py's tolerances: counts exact, the
    # float32 moment sums to their rounding.
    np.testing.assert_array_equal(rows[:n, 9], np.asarray(jc)[:n])
    np.testing.assert_allclose(rows[:n, 0:3], np.asarray(jm1)[:n], atol=1e-4)
    np.testing.assert_allclose(m2[:n], np.asarray(jm2)[:n], atol=1e-3)
    assert not rows[n:].any()
    # d_k: the kth distance of the Pallas transposed kNN over the same rows.
    jd, _ = knn_pallas_T(jnp.asarray(sheet[:n]), jnp.asarray(sheet[:n, :3]), k,
                         interpret=True)
    np.testing.assert_allclose(rows[:n, 10], np.asarray(jd)[:, k - 1], rtol=1e-6)


@pytest.mark.parametrize("team", [8, 16, 32])
def test_warp_walk_teams_and_edges(team):
    # Fewer valid rows than k, and none: as the brute-force version.
    pts = torch.as_tensor(_pad4(np.float32([[0, 0, 0], [1, 0, 0], [0, 2, 0]]), 8))
    for valid in (3, 1, 0):
        got = knn_moments_walk_plain(pts, _num(valid), 10, team=team)
        assert torch.equal(got, knn_moments_rows_plain(pts, _num(valid), 10)), valid
    assert not got.any()
    # A short cull pass.
    rng = np.random.default_rng(team)
    cloud = torch.as_tensor(_pad4(rng.uniform(-5, 5, (900, 3)).astype(np.float32), 960))
    got = knn_moments_walk_plain(cloud, _num(900), 10, team=team, cull_pass=2)
    assert torch.equal(got, knn_moments_rows_plain(cloud, _num(900), 10))


def test_moments_q_takes_the_kept_sort(scans, monkeypatch):
    sorted_points = []
    real = morton_boxes.pruned_prepare_target

    def counted(points, num_points):
        sorted_points.append(points)
        return real(points, num_points)

    for module in (morton_boxes, cov_fused_cuda):
        monkeypatch.setattr(module, "pruned_prepare_target", counted)
    frames, _ = scans
    cloud, tree = preprocess_points(frames[0], 0.25, 10, device="cpu")
    assert len(sorted_points) == 1 and sorted_points[0] is cloud.points
    kept = tree.pruned_target()
    m_kept = knn_moments(cloud.points, cloud.num_points, 10, layout="q", target=kept)
    r_kept = knn_moments_rows(cloud.points, cloud.num_points, 10, layout="q", target=kept)
    # The wrapper's sort selection, which K5's launch runs: the kept sort as
    # it is, a sort of its own only without it.
    assert cov_fused_cuda._sorted_cloud(cloud.points, cloud.num_points, kept) is kept
    assert len(sorted_points) == 1
    cov_fused_cuda._sorted_cloud(cloud.points, cloud.num_points, None)
    assert len(sorted_points) == 2
    m_bare = knn_moments(cloud.points, cloud.num_points, 10, layout="q")
    assert all(torch.equal(a, b) for a, b in zip(m_kept, m_bare))
    assert torch.equal(r_kept, knn_moments_rows(cloud.points, cloud.num_points, 10))
