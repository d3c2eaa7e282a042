"""The box-pruned fleet linearize (K7) on the CPU: the fleet tables' sorted
target rows, boxes and source order against the single-pair prologue, the
exactness of the box cull (``fleet_live_tiles``), the unmatched-row
contract of the plain K7 against K1's brute-force arithmetic, and the plain
K7 against the Pallas ``gicp_linearize_fleet`` in interpret mode.

The problem is tests/test_torch_fleet.py's, rebuilt from
``np.random.default_rng(7)``: two pairs at capacity 640 (600 / 560 target
and 500 / 430 source rows), three lanes, the last inactive.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops import gicp_fused_pallas as jfused
from small_gicp_tpu.point_cloud import PointCloud as JPointCloud
from small_gicp_tpu.utils.lie import se3_exp as j_se3_exp
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.ops import gicp_fused_cuda as fused
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    FACTORS,
    fleet_live_tiles,
    gicp_fleet_prepare,
    gicp_linearize_fleet,
    gicp_prepare,
    swept_live_tiles,
)
from small_gicp_tpu_torch.ops.knn import sq_dists
from small_gicp_tpu_torch.ops.morton_boxes import (
    BLOCK_ROWS,
    TILE_ROWS,
    morton_order,
    pruned_prepare_target,
)
from small_gicp_tpu_torch.point_cloud import stack_clouds

CAP = 640
UIDS = np.array([0, 1, 0], np.int32)
ACTIVE = np.array([True, True, False])
# Lane twists (rx ry rz tx ty tz): near the pairs' alignment, and farther.
TWISTS = {
    "near": [[0.02, -0.01, 0.03, 0.05, -0.1, 0.08], [-0.01, 0.02, 0.0, 0.1, 0.0, -0.05],
             [0.0, 0.0, 0.01, 0.0, 0.2, 0.0]],
    "far": [[0.1, -0.05, 0.2, 1.5, -0.8, 0.3], [-0.15, 0.1, -0.3, -2.0, 1.0, 0.2],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]],
    "shifted": [[0.0, 0.0, 0.0, 6.0, 0.0, 0.0], [0.0, 0.0, 0.5, 0.0, -5.0, 0.0],
                [0.0, 0.0, 0.0, 3.0, 3.0, 0.0]],
}


def _jax_pair(rng, n, m):
    """tests/test_fleet.py::_pair: JAX clouds with covariances."""
    tp = rng.uniform(-8, 8, size=(m, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0]) * 0.5 + 0.05 * rng.normal(size=m)
    sp = tp[rng.permutation(m)[:n]] + rng.normal(scale=0.05, size=(n, 3)).astype(
        np.float32)

    def covs(k):
        a = rng.normal(size=(k, 3, 3)).astype(np.float32) * 0.05
        c = np.einsum("nij,nkj->nik", a, a) + np.eye(3, dtype=np.float32) * 0.01
        return jnp.asarray(np.concatenate([c, np.zeros((CAP - k, 3, 3), np.float32)]))

    target = JPointCloud.from_points(tp).with_capacity(CAP).replace(covs=covs(m))
    source = JPointCloud.from_points(sp).with_capacity(CAP).replace(covs=covs(n))
    return target, source


def _normals(rng):
    nrm = rng.normal(size=(CAP, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    out = np.zeros((CAP, 4), np.float32)
    out[:, :3] = nrm
    return jnp.asarray(out)


def _port(cloud):
    return cloud_from_numpy(
        np.asarray(cloud.points), int(cloud.num_points),
        normals=None if cloud.normals is None else np.asarray(cloud.normals),
        covs=np.asarray(cloud.covs), device="cpu")


@pytest.fixture(scope="module")
def pairs():
    """(JAX targets, JAX sources, port targets, port sources), stacked."""
    rng = np.random.default_rng(7)
    t0, s0 = _jax_pair(rng, 500, 600)
    t1, s1 = _jax_pair(rng, 430, 560)
    t0 = t0.replace(normals=_normals(np.random.default_rng(12)))
    t1 = t1.replace(normals=_normals(np.random.default_rng(13)))
    return ([t0, t1], [s0, s1], stack_clouds([_port(t0), _port(t1)]),
            stack_clouds([_port(s0), _port(s1)]))


def _tables(pairs, factor):
    _, _, tt, ts = pairs
    return gicp_fleet_prepare(tt.points, tt.num_points, ts.points, ts.num_points,
                              factor, tt.covs, ts.covs, tt.normals)


def _poses(kind):
    return torch.stack([torch.as_tensor(np.array(j_se3_exp(jnp.asarray(t, jnp.float32))))
                        for t in TWISTS[kind]])


def _lanes():
    return torch.as_tensor(UIDS), torch.as_tensor(ACTIVE)


@pytest.mark.parametrize("u", [0, 1])
def test_fleet_tables_equal_each_pair_alone(pairs, u):
    _, _, tt, ts = pairs
    tables = _tables(pairs, "gicp")
    alone = pruned_prepare_target(tt.points[u], tt.num_points[u])
    assert torch.equal(tables.tsorted[u], alone.tsorted)
    assert torch.equal(tables.tbox[u], alone.tbox)
    assert tables.tbox.shape == (2, (CAP + TILE_ROWS - 1) // TILE_ROWS, 8)
    valid = torch.arange(CAP) < ts.num_points[u]
    perm = morton_order(ts.points[u, :, :3], valid)[1]
    assert tables.sperm.dtype == torch.int32 and torch.equal(tables.sperm[u].long(), perm)
    # The listed tables are unchanged: K1's, in the clouds' row order.
    listed = gicp_prepare(tt.points[u], tt.num_points[u], ts.points[u], ts.num_points[u],
                          "gicp", tt.covs[u], ts.covs[u])
    assert torch.equal(tables.ttab[u], listed.ttab)
    assert torch.equal(tables.qtab[u], listed.qtab)


def _brute_winners(tables, uids, Ts, max_dist_sq):
    """K1's search per lane: (winner [B,N] original target row, accepted
    [B,N]) over the pair's valid target rows, first minimum on ties."""
    u = uids.long()
    pose = fused._pose12(Ts, torch.float32)
    q = fused._transform_lanes(tables.qtab[u], pose)
    d2 = sq_dists(q, tables.ttab[u][..., :3])  # [B,N,M]
    m = tables.ttab.shape[1]
    d2 = torch.where(torch.arange(m) < tables.tnum[u][:, None, None], d2, 3.0e38)
    best_d, best = torch.min(d2, dim=-1)
    valid = torch.arange(tables.qtab.shape[1]) < tables.qnum[u][:, None]
    return best, valid & (best_d <= max_dist_sq)


@pytest.mark.parametrize("kind", sorted(TWISTS))
def test_pruning_keeps_every_accepted_winner(pairs, kind):
    tables = _tables(pairs, "gicp")
    uids, active = _lanes()
    Ts = _poses(kind)
    for max_dist_sq in (1.0, 4.0):
        live = fleet_live_tiles(tables, uids, Ts, max_dist_sq)
        assert live.shape == (3, CAP // BLOCK_ROWS, (CAP + TILE_ROWS - 1) // TILE_ROWS)
        best, accepted = _brute_winners(tables, uids, Ts, max_dist_sq)
        checked = 0
        for b in range(3):
            u = int(uids[b])
            # sorted position of every original target row, of every source row
            orig = tables.tsorted[u, :, 3].contiguous().view(torch.int32).long()
            tpos = torch.empty_like(orig)
            tpos[orig] = torch.arange(CAP)
            spos = torch.empty(CAP, dtype=torch.int64)
            spos[tables.sperm[u].long()] = torch.arange(CAP)
            rows = accepted[b].nonzero()[:, 0]
            tile = tpos[best[b, rows]] // TILE_ROWS
            block = spos[rows] // BLOCK_ROWS
            assert bool(live[b, block, tile].all()), (kind, max_dist_sq, b)
            checked += len(rows)
        assert checked > 0
        # The plain K7 accepts exactly these rows.
        _, _, inl, corr = gicp_linearize_fleet(tables, uids, Ts, max_dist_sq, active)
        assert torch.equal(corr[..., 12] > 0.5, accepted & active[:, None])
        assert torch.equal(inl, (accepted & active[:, None]).sum(1).double())
    # The cull is not vacuous on this data: the near poses leave some
    # (block, tile) pairs out, the shifted ones more.
    if kind != "far":
        assert not bool(fleet_live_tiles(tables, uids, Ts, 1.0)[active].all())


@pytest.mark.parametrize("factor", FACTORS)
def test_plain_k7_equals_brute_force_on_accepted_rows(pairs, factor):
    tables = _tables(pairs, factor)
    uids, active = _lanes()
    for kind in ("near", "far"):
        Ts = _poses(kind)
        H, b, inl, corr = gicp_linearize_fleet(tables, uids, Ts, 1.0, active, "huber", 0.5)
        u = uids.long()
        old_sums, old = fused._linearize_plain_lanes(
            tables.ttab[u], tables.tnum[u], tables.qtab[u],
            torch.where(active, tables.qnum[u], 0), fused._pose12(Ts, torch.float32),
            1.0, "huber", 0.5, factor)
        oH, ob, oinl = fused._finish(old_sums)
        mask = corr[..., 12] > 0.5
        assert torch.equal(mask, old[..., 12] > 0.5) and int(mask.sum()) > 0
        assert torch.equal(corr[mask], old[mask])
        # Rows with mask = 0 contribute nothing to either: the sums are equal.
        assert torch.equal(H, oH) and torch.equal(b, ob) and torch.equal(inl, oinl)
        unmatched = ~mask & active[:, None]
        assert int(unmatched.sum()) > 0
        assert torch.all(corr[unmatched][:, :13] == 0)
        assert torch.all(corr[unmatched][:, 13] == 3.0e38)
        assert torch.all(corr[unmatched][:, 14:] == 0)
        assert torch.all(corr[~active] == 0) and torch.all(H[~active] == 0)


@pytest.mark.parametrize("factor,robust,c", [("gicp", None, 1.0), ("icp", "huber", 0.5)])
def test_plain_k7_matches_pallas_fleet_interpret(pairs, factor, robust, c):
    jt, js, _, _ = pairs
    gicp = factor == "gicp"
    stack = lambda cl, f: jnp.stack([getattr(x, f) for x in cl])  # noqa: E731
    jtab = jfused.gicp_fleet_prepare(
        stack(jt, "points"), stack(jt, "covs") if gicp else None, stack(js, "points"),
        stack(js, "covs") if gicp else None, stack(js, "num_points"), factor=factor,
        target_normals=stack(jt, "normals"))
    Ts = _poses("near")
    jH, jb, jinl, jcorr16 = jfused.gicp_linearize_fleet(
        *jtab, jnp.asarray(UIDS), jnp.asarray(Ts.numpy()), 1.0, jnp.asarray(ACTIVE),
        interpret=True, robust=robust, robust_c=c, factor=factor)
    uids, active = _lanes()
    H, b, inl, corr = gicp_linearize_fleet(_tables(pairs, factor), uids, Ts, 1.0, active,
                                           robust, c)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    for lane in range(2):
        scale = max(1.0, float(np.abs(np.asarray(jH[lane])).max()))
        np.testing.assert_allclose(H[lane].numpy() / scale, np.asarray(jH[lane]) / scale,
                                   atol=5e-4)
        bscale = max(1.0, float(np.abs(np.asarray(jb[lane])).max()))
        np.testing.assert_allclose(b[lane].numpy() / bscale,
                                   np.asarray(jb[lane]) / bscale, atol=5e-4)
        # JAX's corr rows are in its own Morton order of the lane's source.
        u = int(UIDS[lane])
        sperm = np.asarray(jfused.gicp_prepare(
            jt[u].points, jt[u].covs, js[u].points, js[u].covs, js[u].num_points)[4])
        jcorr = np.zeros((CAP, 16), np.float32)
        jcorr[sperm] = np.asarray(jcorr16[lane])[:, :CAP].T
        got = corr[lane].numpy()
        mask = got[:, 12] > 0.5
        np.testing.assert_array_equal(mask, jcorr[:, 12] > 0.5)
        np.testing.assert_allclose(got[mask, 0:3], jcorr[mask, 0:3], atol=1e-5)
        np.testing.assert_allclose(got[mask, 13], jcorr[mask, 13], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[mask, 3:12], jcorr[mask, 3:12], rtol=2e-3,
                                   atol=2e-3)
    assert torch.all(corr[2] == 0) and torch.all(H[2] == 0)


def test_fleet_live_tiles_are_each_pairs_swept_tiles(pairs):
    _, _, tt, ts = pairs
    tables = _tables(pairs, "gicp")
    uids, _ = _lanes()
    Ts = _poses("shifted")
    live = fleet_live_tiles(tables, uids, Ts, 1.0)
    for b in range(3):
        u = int(uids[b])
        alone = gicp_prepare(tt.points[u], tt.num_points[u], ts.points[u],
                             ts.num_points[u], "gicp", tt.covs[u], ts.covs[u],
                             route="swept")
        assert torch.equal(live[b], swept_live_tiles(alone, Ts[b], 1.0)), b


def test_fleet_tables_without_rows(pairs):
    """A pair without source rows and one without target rows: every
    block stages nothing, every row is unmatched."""
    _, _, tt, ts = pairs
    tables = gicp_fleet_prepare(tt.points, torch.tensor([0, 560], dtype=torch.int32),
                                ts.points, torch.tensor([500, 0], dtype=torch.int32),
                                "icp")
    uids = torch.tensor([0, 1], dtype=torch.int32)
    Ts = _poses("near")[:2]
    assert not fleet_live_tiles(tables, uids, Ts, 1.0).any()
    assert torch.all(tables.tbox[0, :, 0:3] == 3.0e38)
    assert torch.equal(tables.sperm[1].long(), torch.arange(CAP))
    H, b, inl, corr = gicp_linearize_fleet(tables, uids, Ts, 1.0,
                                           torch.ones(2, dtype=torch.bool))
    assert torch.all(inl == 0) and torch.all(H == 0) and torch.all(b == 0)
    assert not corr[..., :13].any() and torch.all(corr[..., 13] == 3.0e38)
