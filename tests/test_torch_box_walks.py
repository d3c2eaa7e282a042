"""The box walks of K4 and K6 (``csrc/cov_fused.cu``, ``csrc/gicp_swept.cu``)
as their plain accounts, on the CPU.

K4 culls its block's boxes in passes (``walk_passes``) at a bound that
tightens after each pass; ``knn_topk_idx_walk_plain`` follows it and must
equal the brute-force ``knn_topk_idx_plain`` bit for bit — on a
duplicate-heavy grid of 24³ cells and on a wavy sheet, for passes of the
kernel's length and of a few boxes, in both visit orders — and the Pallas
index-only kernel ``_make_topk_idx_kernel_T`` in interpret mode on the
tie-free sheet (indices equal; d² to rtol 1e-6, since XLA on the CPU
contracts the distance into fused multiply-adds and the port rounds every
operation).

K6 deals each source block's live tiles to ``chunks`` chunk blocks and
merges their winners by a 64-bit key (d²'s bits over the original row);
``gicp_linearize_swept_split_plain`` follows it and must equal
``gicp_linearize_swept_plain`` for any chunk count — one, a few, more than
a block has live tiles — with blocks without a valid row, an empty target
and rows without a correspondence, and the Pallas ``_fused_kernel`` on
rows it accepts. Inputs come from seeded numpy generators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops import cov_fused_pallas
from small_gicp_tpu.ops import gicp_fused_pallas as jfused
from small_gicp_tpu.utils.lie import se3_exp as j_se3_exp
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.ops.cov_fused_cuda import (
    knn_topk_idx_plain,
    knn_topk_idx_walk_plain,
    walk_passes,
)
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    SWEPT_BLOCKS_PER_SM,
    SWEPT_KEY_NONE,
    gicp_linearize_swept_plain,
    gicp_linearize_swept_split_plain,
    gicp_prepare,
    swept_chunk_tiles,
    swept_chunks,
    swept_key,
    swept_live_tiles,
)
from small_gicp_tpu_torch.ops.morton_boxes import CULL_PASS

TWIST = [0.02, -0.01, 0.03, 0.05, -0.1, 0.08]


def _pad4(xyz, cap):
    out = np.full((cap, 4), 1e9, np.float32)
    out[:, 3] = 0.0
    out[:len(xyz), :3] = xyz
    out[:len(xyz), 3] = 1.0
    return out


def _cloud(kind):
    """(points [cap,4] numpy, valid rows): ``grid`` — 3,000 points in 24³
    integer cells (every distance ties many times) in a 3,100-row table;
    ``sheet`` — the 1,500-point wavy sheet of tests/test_torch_cov_layouts.py
    with 60 padding rows (no ties)."""
    if kind == "grid":
        rng = np.random.default_rng(24)
        return _pad4(rng.integers(0, 24, (3000, 3)).astype(np.float32), 3100), 3000
    rng = np.random.default_rng(21)
    xy = rng.uniform(-20, 20, size=(1500, 2))
    z = 0.4 * np.sin(0.2 * xy[:, 0]) + 0.02 * rng.normal(size=1500)
    return _pad4(np.c_[xy, z].astype(np.float32), 1560), 1500


# ---- K4 ---------------------------------------------------------------------

@pytest.mark.parametrize("k", [10, 20, 64])
@pytest.mark.parametrize("kind", ["grid", "sheet"])
def test_walk_plain_matches_brute_force(kind, k):
    pts, n = _cloud(kind)
    pts, num = torch.as_tensor(pts), torch.tensor(n, dtype=torch.int32)
    d, i = knn_topk_idx_plain(pts, num, k)
    # The kernel's passes, passes of a few boxes (several per block) in
    # both visit orders.
    for cull_pass, outward in ((CULL_PASS, True), (2, True), (3, False)):
        dw, iw = knn_topk_idx_walk_plain(pts, num, k, cull_pass, outward)
        assert torch.equal(dw, d) and torch.equal(iw, i), (cull_pass, outward)
    assert torch.all(d[n:] == 3.0e38) and torch.all(i[n:] == 0)


def test_walk_passes_cover_every_box_once():
    for ntiles in (1, 5, 13, 300):
        for cull_pass in (1, 2, 4, CULL_PASS):
            for outward in (True, False):
                for own in sorted({0, ntiles // 2, ntiles - 1}):
                    passes = walk_passes(own, ntiles, cull_pass, outward)
                    boxes = [t for first, end in passes for t in range(first, end)]
                    assert sorted(boxes) == list(range(ntiles))
                    assert all(0 < end - first <= cull_pass for first, end in passes)
                    # The first pass holds the block's own box, or starts at 0.
                    first, end = passes[0]
                    assert (first <= own < end) if outward else first == 0


def _pallas_topk_idx(pts, n, k, monkeypatch):
    """The Pallas index-only kernel's lists in interpret mode, un-jitted:
    (d² [N,k] as the JAX wrapper forms them from the gathered winners,
    original row indices [N,k]) for the valid rows."""
    calls = []
    real = cov_fused_pallas.pl.pallas_call

    def spy(*args, **kwargs):
        fn = real(*args, **kwargs)

        def run(*operands):
            out = fn(*operands)
            calls.append((operands, out))
            return out
        return run

    monkeypatch.setattr(cov_fused_pallas.pl, "pallas_call", spy)
    cov_fused_pallas.knn_moments_pallas.__wrapped__(
        jnp.asarray(pts), jnp.asarray(n, jnp.int32), k, interpret=True, layout="ti")
    (operands, out), = calls
    t = np.asarray(operands[2])[:3].T  # sorted rows, padded
    q = np.asarray(operands[3])[:3].T[:n]  # sorted queries; the valid ones first
    winners = np.asarray(out)[:k, :n].T.astype(np.int64)
    assert winners.max() < n  # every slot of a valid row holds a valid row
    nb = jnp.asarray(t)[winners] - jnp.asarray(q)[:, None, :]
    d2 = np.asarray(jnp.sum(nb * nb, axis=-1))
    # Sorted position → original row, by the (unique) coordinates.
    where = {tuple(r): j for j, r in enumerate(pts[:n, :3])}
    perm = np.array([where[tuple(r)] for r in q])
    order = np.empty(n, np.int64)
    order[perm] = np.arange(n)
    return d2[order], perm[winners][order]


@pytest.mark.parametrize("k", [10, 20])
def test_walk_plain_matches_pallas_topk_idx_kernel(k, monkeypatch):
    pts, n = _cloud("sheet")
    jd, ji = _pallas_topk_idx(pts, n, k, monkeypatch)
    d, i = knn_topk_idx_walk_plain(torch.as_tensor(pts), torch.tensor(n, dtype=torch.int32),
                                   k)
    np.testing.assert_array_equal(i.numpy()[:n], ji)
    np.testing.assert_allclose(d.numpy()[:n], jd, rtol=1e-6, atol=1e-12)


# ---- K6 ---------------------------------------------------------------------

def _make_pair(seed, n, m, extent):
    rng = np.random.default_rng(seed)
    tp = rng.uniform(-extent, extent, size=(m, 3)).astype(np.float32)
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


@pytest.fixture(scope="module")
def pair():
    # The pair on which tests/test_torch_gicp_swept.py holds K6's plain
    # version to the Pallas kernel (coordinates within 8 m).
    return _make_pair(7, 700, 900, 8.0)


@pytest.fixture(scope="module")
def far_pair():
    # 3,000 target rows over 80 m: most tiles lie beyond a source block's reach.
    return _make_pair(9, 700, 3000, 40.0)


def _T():
    return np.array(j_se3_exp(jnp.asarray(TWIST, jnp.float32)))


def _tables(p, factor, sn=None, tn=None):
    tgt = cloud_from_numpy(p["tp"], p["tn"] if tn is None else tn,
                           normals=p["normals"], covs=p["tc"], device="cpu")
    src = cloud_from_numpy(p["sp"], p["sn"] if sn is None else sn, covs=p["sc"],
                           device="cpu")
    return gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                        factor, tgt.covs, src.covs, tgt.normals, route="swept")


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("chunks", [1, 3, 8, "above"])
def test_split_plain_matches_swept_plain(far_pair, chunks):
    T = torch.as_tensor(_T())
    cases = [("gicp", None, 1.0, {}), ("plane_icp", "cauchy", 0.3, {}),
             ("icp", "huber", 0.5, {}),
             ("gicp", None, 1.0, {"sn": 100}),  # blocks 2-11 hold padding only
             ("gicp", None, 1.0, {"sn": 0}),
             ("gicp", None, 1.0, {"tn": 0})]  # an empty target
    for factor, robust, c, cut in cases:
        tables = _tables(far_pair, factor, **cut)
        live = swept_live_tiles(tables, T, 1.0)
        s = int(live.sum(dim=1).max()) + 5 if chunks == "above" else chunks
        ref = gicp_linearize_swept_plain(tables, T, 1.0, robust, c)
        got = gicp_linearize_swept_split_plain(tables, T, 1.0, robust, c, chunks=s)
        assert _same(got, ref), (factor, robust, cut, s)
        corr = got[3]
        unmatched = corr[:, 12] < 0.5
        assert torch.all(corr[unmatched][:, :13] == 0)
        assert torch.all(corr[unmatched][:, 13] == 3.0e38)
        if not cut:
            assert 0 < int(got[2]) < far_pair["sn"]  # rows without a correspondence


def _jax_swept(p, factor, T, monkeypatch):
    """The Pallas grid-swept kernel over JAX's own tables, un-jitted (the
    listed-route threshold lowered for the call): (H, b, inliers, corr
    [N,16] in original source order)."""
    gicp = factor == "gicp"
    n = p["sp"].shape[0]
    ttab, tb, qtab, _, sperm, ttab_T = jfused.gicp_prepare(
        jnp.asarray(p["tp"]), jnp.asarray(p["tc"]) if gicp else None,
        jnp.asarray(p["sp"]), jnp.asarray(p["sc"]) if gicp else None,
        jnp.asarray(p["sn"], jnp.int32), factor=factor,
        target_normals=jnp.asarray(p["normals"]))
    monkeypatch.setattr(jfused, "_LISTED_MP_CAP", 0)
    H, b, inl, corr16 = jfused.gicp_linearize_tables.__wrapped__(
        ttab, tb, qtab, jnp.asarray(T), jnp.asarray(1.0, jnp.float32), ttab_T,
        interpret=True, factor=factor, robust=None, robust_c=1.0)
    corr = np.zeros((n, 16), np.float32)
    corr[np.asarray(sperm)] = np.asarray(corr16)[:, :n].T
    return np.asarray(H), np.asarray(b), float(inl), corr


@pytest.mark.parametrize("factor", ["gicp", "icp"])
def test_split_plain_matches_pallas_fused_kernel(pair, factor, monkeypatch):
    T = _T()
    jH, jb, jinl, jcorr = _jax_swept(pair, factor, T, monkeypatch)
    H, b, inl, corr = gicp_linearize_swept_split_plain(
        _tables(pair, factor), torch.as_tensor(T), 1.0, chunks=3)
    corr = corr.numpy()
    mask = corr[:, 12] > 0.5
    # The tolerances tests/test_torch_gicp_swept.py holds K6's plain version
    # to on this pair: the mask exact; μ, d², W on accepted rows to float32
    # rounding; H and b, scaled by their largest entry, to 5e-4.
    np.testing.assert_array_equal(mask, jcorr[:, 12] > 0.5)
    assert int(inl) == int(jinl) == int(mask.sum()) > 0
    np.testing.assert_allclose(corr[mask, 0:3], jcorr[mask, 0:3], atol=1e-5)
    np.testing.assert_allclose(corr[mask, 13], jcorr[mask, 13], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(corr[mask, 3:12], jcorr[mask, 3:12], rtol=2e-3, atol=2e-3)
    scale = max(1.0, float(np.abs(jH).max()))
    np.testing.assert_allclose(H.numpy() / scale, jH / scale, atol=5e-4)
    bscale = max(1.0, float(np.abs(jb).max()))
    np.testing.assert_allclose(b.numpy() / bscale, jb / bscale, atol=5e-4)


def test_swept_key_orders_by_d2_then_row():
    d2 = torch.tensor([0.0, -0.0, 0.0, 1e-30, 0.25, 0.25, 0.5, 3.0e38])
    row = torch.tensor([7, 3, 2, 0, 9, 4, 0, 1])
    keys = swept_key(d2, row)
    # -0 counts as +0: (−0, 3) sits between (+0, 2) and (+0, 7).
    assert keys[1] == swept_key(torch.tensor([0.0]), torch.tensor([3]))[0]
    order = torch.argsort(keys)
    assert order.tolist() == [2, 1, 0, 3, 5, 4, 6, 7]
    # The smallest key decodes to the winner; the reset value loses to all.
    assert bool((keys < SWEPT_KEY_NONE).all()) and bool((keys >= 0).all())
    k = keys.min()
    assert float(torch.tensor([int(k) >> 32], dtype=torch.int32).view(torch.float32)) == 0.0
    assert int(k) & 0xFFFFFFFF == 2


def test_chunk_plan_deals_every_live_tile_once(far_pair):
    T = torch.as_tensor(_T())
    live = swept_live_tiles(_tables(far_pair, "gicp"), T, 1.0)
    per_block = live.sum(dim=1)
    assert per_block.max() > 2
    for chunks in (1, 2, 3, 8, int(per_block.max()) + 2):
        owner = swept_chunk_tiles(live, chunks)
        assert owner.shape == live.shape
        assert torch.equal(owner >= 0, live) and int(owner.max()) < chunks
        # Each live tile to exactly one chunk, interleaved: chunk s holds the
        # block's live tiles s, s + chunks, … in ascending order.
        plan = owner[None] == torch.arange(chunks)[:, None, None]
        assert torch.equal(plan.sum(dim=0), live.long())
        for b in range(live.shape[0]):
            tiles = live[b].nonzero()[:, 0]
            assert owner[b, tiles].tolist() == [j % chunks for j in range(len(tiles))]
        counts = plan.sum(dim=2)  # [chunks, blocks]
        want = (per_block[None] - torch.arange(chunks)[:, None] + chunks - 1) // chunks
        assert torch.equal(counts, torch.clamp(want, min=0))
    # The plan: enough blocks to fill the card, no more chunks than tiles.
    assert swept_chunks(20_746, 1_719_957, 132) == -(-SWEPT_BLOCKS_PER_SM * 132 // 325)
    assert swept_chunks(700, 5000, 132) == 20  # capped at the target's tiles
    assert swept_chunks(10 ** 7, 10 ** 7, 132) == 1
    assert swept_chunks(0, 0, 132) == 1
