"""The scan pair's box walks, K3 (``csrc/cov_fused.cu``) and K1
(``csrc/gicp_listed.cu``), as their plain accounts on the CPU, and the one
Morton sort per cloud that preprocessing and the align share.

K3 walks the cloud's Morton sort in K4's cull passes with a team of
``MOMENTS_TEAM`` threads a query, each member with its own seeded list of
every team-th row of a tile, merges the team's lists and sums the winners'
offsets in slot order; ``knn_moments_walk_plain`` follows it and must equal
the brute-force ``knn_moments_rows_plain`` bit for bit — on a synthetic
scan, on a duplicate-heavy grid of 12³ cells, at k = 1, 10, 20, 64, for
teams of 1 to 8 threads and passes of a few boxes, with fewer valid rows
than k and without any — and the Pallas ``knn_moments_pallas(layout="t")``
in interpret mode at the tolerances of tests/test_torch_preprocess.py.

K1 culls the target's boxes by the rejector radius, deals each source
block's live tiles to chunk blocks and merges their winners by a 64-bit
key (d²'s bits over the original row): ``gicp_linearize_swept_split_plain``
over the listed tables is that account and must equal K1's plain version
``gicp_linearize_listed_plain`` (the CPU side of ``gicp_linearize_tables``)
at one, a few and the planned chunk count, for 3 factors × 3 robust
kernels, and the Pallas listed kernel in interpret mode at the tolerances
of tests/test_torch_gicp.py on a cover of them (each factor and each
robust kernel once: every Pallas configuration costs a second of tracing);
also at a pose with no live tile, with a
radius of inf, with an empty target and without source rows. Inputs come
from seeded numpy generators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.cov_fused_pallas import knn_moments_pallas
from small_gicp_tpu.ops.gicp_fused_pallas import gicp_linearize_pallas
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.models.helper import align, preprocess_points
from small_gicp_tpu_torch.ops import cov_fused_cuda, gicp_fused_cuda, morton_boxes
from small_gicp_tpu_torch.ops.cov_fused_cuda import (
    MOMENTS_TEAM,
    knn_moments,
    knn_moments_rows,
    knn_moments_rows_plain,
    knn_moments_walk_plain,
)
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    gicp_linearize_listed_plain,
    gicp_linearize_swept_split_plain,
    gicp_linearize_tables,
    gicp_prepare,
    swept_chunks,
    swept_live_tiles,
)
from small_gicp_tpu_torch.ops.morton_boxes import pruned_prepare_target
from small_gicp_tpu_torch.utils.lie import se3_exp
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

TWIST = [0.02, -0.01, 0.03, 0.05, -0.1, 0.08]
ROBUST = [(None, 1.0), ("huber", 0.5), ("cauchy", 0.3)]
# The robust kernel each factor is also held against the Pallas kernel with.
PALLAS_ROBUST = {"gicp": None, "plane_icp": "cauchy", "icp": "huber"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain walks run many small torch ops; the suite runs several
    worker processes on the same cores, where intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pad4(xyz, cap):
    out = np.full((cap, 4), 1e9, np.float32)
    out[:, 3] = 0.0
    out[:len(xyz), :3] = xyz
    out[:len(xyz), 3] = 1.0
    return out


@pytest.fixture(scope="module")
def scans():
    return generate_sequence(n_frames=2, rings=16, azimuth_steps=256)


@pytest.fixture(scope="module")
def scan_cloud(scans):
    """A 16-ring frame downsampled at 0.75 m (1,485 rows, six boxes, in a
    3,776-row table)."""
    return voxelgrid_sampling(scans[0][0], 0.75, device="cpu")


def _grid():
    """1,000 points in 12³ integer cells (duplicate points, and every
    distance ties many times) in a 1,100-row table: four boxes."""
    rng = np.random.default_rng(24)
    pts = _pad4(rng.integers(0, 12, (1000, 3)).astype(np.float32), 1100)
    return torch.as_tensor(pts), torch.tensor(1000, dtype=torch.int32)


# ---- K3 ---------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 10, 20, 64])
@pytest.mark.parametrize("kind", ["scan", "grid"])
def test_moments_walk_equals_plain_bit_for_bit(scan_cloud, kind, k):
    pts, num = ((scan_cloud.points, scan_cloud.num_points) if kind == "scan"
                else _grid())
    got = knn_moments_walk_plain(pts, num, k)
    ref = knn_moments_rows_plain(pts, num, k)
    assert torch.equal(got, ref)
    assert bool((got[:int(num), 9] == min(k, int(num))).all())


def test_teams_and_short_passes_give_the_same_rows(scan_cloud):
    pts, num = scan_cloud.points, scan_cloud.num_points
    ref = knn_moments_rows_plain(pts, num, 10)
    target = pruned_prepare_target(pts, num)
    for team, cull_pass in ((1, 256), (2, 256), (8, 256), (MOMENTS_TEAM, 4)):
        got = knn_moments_walk_plain(pts, num, 10, team=team, cull_pass=cull_pass,
                                     target=target)
        assert torch.equal(got, ref), (team, cull_pass)


def test_moments_walk_matches_pallas_interpret(scan_cloud):
    pts, num = scan_cloud.points, scan_cloud.num_points
    n = int(num)
    jm1, jm2, jc = knn_moments_pallas(jnp.asarray(pts.numpy()),
                                      jnp.asarray(n, jnp.int32), 10, interpret=True,
                                      layout="t")
    rows = knn_moments_walk_plain(pts, num, 10)
    m1 = rows[:, 0:3].numpy()
    m2 = rows[:, [3, 4, 5, 4, 6, 7, 5, 7, 8]].reshape(-1, 3, 3).numpy()
    # The tolerances of tests/test_torch_preprocess.py: counts exact, the
    # float32 moment sums to their rounding.
    np.testing.assert_array_equal(rows[:n, 9].numpy(), np.asarray(jc)[:n])
    np.testing.assert_allclose(m1[:n], np.asarray(jm1)[:n], atol=1e-4)
    np.testing.assert_allclose(m2[:n], np.asarray(jm2)[:n], atol=1e-3)
    assert not rows[n:].any()


def test_moments_walk_edges():
    # Fewer valid rows than k: the missing slots count as invalid and d_k is
    # the empty slot's 3e38; no valid row: every row zero.
    pts = torch.as_tensor(_pad4(np.float32([[0, 0, 0], [1, 0, 0], [0, 2, 0]]), 8))
    for num in (3, 0):
        num = torch.tensor(num, dtype=torch.int32)
        got = knn_moments_walk_plain(pts, num, 10)
        assert torch.equal(got, knn_moments_rows_plain(pts, num, 10))
    assert torch.equal(got, torch.zeros_like(got))
    got = knn_moments_walk_plain(pts, torch.tensor(3, dtype=torch.int32), 10)
    assert bool((got[:3, 9] == 3.0).all()) and bool((got[:3, 10] == 3.0e38).all())
    # The entry point on the CPU is the plain version, with or without the
    # cloud's kept sort.
    target = pruned_prepare_target(pts, torch.tensor(3, dtype=torch.int32))
    assert torch.equal(knn_moments_rows(pts, torch.tensor(3, dtype=torch.int32), 10,
                                        target=target), got)


# ---- K1 ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """700 source / 900 target rows (the inputs of tests/test_torch_gicp.py)."""
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
    return dict(tp=_pad4(tp, m + 20), sp=_pad4(sp, n + 12), tn=m, sn=n,
                tc=covs(m, m + 20), sc=covs(n, n + 12), normals=normals)


def _tables(p, factor, tn=None, sn=None):
    tgt = cloud_from_numpy(p["tp"], p["tn"] if tn is None else tn,
                           normals=p["normals"], covs=p["tc"], device="cpu")
    src = cloud_from_numpy(p["sp"], p["sn"] if sn is None else sn, covs=p["sc"],
                           device="cpu")
    return gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points, factor,
                        tgt.covs, src.covs, tgt.normals)


def _T():
    return se3_exp(torch.tensor(TWIST, dtype=torch.float32)).numpy()


def _planned(tables):
    """K1's chunk plan on a card of 132 SMs."""
    return swept_chunks(int(tables.qnum), tables.ttab.shape[0], 132)


def _check_walk(tables, T, max_d2, robust=None, c=1.0, chunk_counts=(1, 3)):
    """K1's walk at each chunk count equal to K1's plain version: masks and
    inliers, every corr row (accepted rows μ, W, d²; the others zero with
    d² = 3e38) and the float64 sums bit for bit."""
    ref = gicp_linearize_listed_plain(tables, T, max_d2, robust, c)
    assert torch.equal(ref[3], gicp_linearize_tables(tables, T, max_d2, robust, c)[3])
    mask = ref[3][:, 12] > 0.5
    assert not ref[3][~mask][:, :13].any() and torch.all(ref[3][~mask][:, 13] == 3e38)
    for chunks in (*chunk_counts, _planned(tables)):
        got = gicp_linearize_swept_split_plain(tables, T, max_d2, robust, c,
                                               chunks=chunks)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), chunks
    return ref


@pytest.mark.parametrize("factor", ["gicp", "plane_icp", "icp"])
def test_listed_walk_matches_plain_and_pallas(pair, factor):
    T = _T()
    tables = _tables(pair, factor)
    gicp = factor == "gicp"
    for robust, c in ROBUST:
        H, b, inl, corr = _check_walk(tables, torch.as_tensor(T), 1.0, robust, c)
        if robust != PALLAS_ROBUST[factor]:
            continue
        jH, jb, jmu, jW, jmask, jsq, _, _ = gicp_linearize_pallas(
            jnp.asarray(pair["tp"]), jnp.asarray(pair["tc"]) if gicp else None,
            jnp.asarray(pair["sp"]), jnp.asarray(pair["sc"]) if gicp else None,
            jnp.asarray(T), jnp.asarray(pair["sn"], jnp.int32),
            jnp.asarray(1.0, jnp.float32), interpret=True, factor=factor,
            target_normals=jnp.asarray(pair["normals"]), robust=robust, robust_c=c)
        corr = corr.numpy()
        mask = corr[:, 12] > 0.5
        # tests/test_torch_gicp.py's tolerances: the mask exact; μ, d², W on
        # inlier rows to float32 rounding; H and b, scaled, to 5e-4.
        np.testing.assert_array_equal(mask, np.asarray(jmask))
        assert int(inl) == int(mask.sum())
        np.testing.assert_allclose(corr[mask, 0:3], np.asarray(jmu)[mask], atol=1e-5)
        np.testing.assert_allclose(corr[mask, 13], np.asarray(jsq)[mask], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(corr[mask, 3:12].reshape(-1, 3, 3),
                                   np.asarray(jW)[mask], rtol=2e-3, atol=2e-3)
        scale = max(1.0, float(np.abs(jH).max()))
        np.testing.assert_allclose(H.numpy() / scale, np.asarray(jH) / scale, atol=5e-4)
        bscale = max(1.0, float(np.abs(jb).max()))
        np.testing.assert_allclose(b.numpy() / bscale, np.asarray(jb) / bscale,
                                   atol=5e-4)


def test_listed_walk_edges(pair):
    T = torch.as_tensor(_T())
    tables = _tables(pair, "gicp")
    # A pose that carries the source 1 km away: no live tile, no inlier.
    far = T.clone()
    far[:3, 3] += 1000.0
    assert not swept_live_tiles(tables, far, 1.0).any()
    H, b, inl, corr = _check_walk(tables, far, 1.0)
    assert int(inl) == 0 and not H.any() and not b.any()
    # A radius of inf culls nothing: every valid row finds its nearest row.
    assert bool(swept_live_tiles(tables, T, float("inf"))[:11].all())
    H, b, inl, corr = _check_walk(tables, T, float("inf"))
    assert int(inl) == pair["sn"]
    # An empty target, and no source rows.
    for tn, sn in ((0, None), (None, 0)):
        t = _tables(pair, "gicp", tn=tn, sn=sn)
        H, b, inl, corr = _check_walk(t, T, 1.0)
        assert int(inl) == 0 and not H.any() and not corr[:, :13].any()


# ---- one sort per cloud -----------------------------------------------------

def test_one_sort_per_cloud(scans, monkeypatch):
    sorted_points = []
    real = morton_boxes.pruned_prepare_target

    def counted(points, num_points):
        sorted_points.append(points)
        return real(points, num_points)

    for module in (morton_boxes, cov_fused_cuda, gicp_fused_cuda):
        monkeypatch.setattr(module, "pruned_prepare_target", counted)
    frames, poses = scans
    target, tree = preprocess_points(frames[0], 0.75, 10, device="cpu")
    source, _ = preprocess_points(frames[1], 0.75, 10, device="cpu")
    sorts = lambda cloud: sum(p is cloud.points for p in sorted_points)  # noqa: E731
    assert sorts(target) == 1 and sorts(source) == 1
    init = np.linalg.inv(poses[0]) @ poses[1]
    res = align(target, source, tree, init_T_target_source=init)
    assert sorts(target) == 1 and sorts(source) == 1 and len(sorted_points) == 2
    # The kept sort changes nothing: the same pose as tables sorted anew.
    again = align(target, source, None, init_T_target_source=init)
    assert sorts(target) == 2
    assert torch.equal(res.T_target_source, again.T_target_source)
    # knn_moments with the cloud's sort is knn_moments without it.
    m_kept = knn_moments(target.points, target.num_points, 10,
                         target=tree.pruned_target())
    m_bare = knn_moments(target.points, target.num_points, 10)
    assert all(torch.equal(a, b) for a, b in zip(m_kept, m_bare))


def test_one_pair_tables_carry_the_sort(pair):
    tables = _tables(pair, "gicp")
    tgt = cloud_from_numpy(pair["tp"], pair["tn"], covs=pair["tc"], device="cpu")
    src = cloud_from_numpy(pair["sp"], pair["sn"], covs=pair["sc"], device="cpu")
    kept = pruned_prepare_target(tgt.points, tables.tnum)
    assert torch.equal(tables.tsorted, kept.tsorted) and torch.equal(tables.tbox,
                                                                     kept.tbox)
    assert tables.sperm.dtype == torch.int32
    given = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points, "gicp",
                         tgt.covs, src.covs, target=kept)
    assert given.tsorted is kept.tsorted and torch.equal(given.sperm, tables.sperm)
    with pytest.raises(ValueError, match="target="):
        gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points, "gicp",
                     tgt.covs, src.covs, target=pruned_prepare_target(
                         src.points, src.num_points))
    # float64 tables keep the brute-force plain version and no sort
    f64 = gicp_prepare(tgt.points.double(), tgt.num_points, src.points.double(),
                       src.num_points, "gicp", tgt.covs.double(), src.covs.double())
    assert f64.tsorted is None and f64.sperm is None
