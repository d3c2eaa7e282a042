"""Port parity of the swept fused linearize (K6): its plain version against
the Pallas grid-swept kernel ``_fused_kernel`` in interpret mode and against
the port's listed route (K1's plain version), the pruning, the contract of
rows without a correspondence, and the routing.

No test of the JAX package reaches ``_fused_kernel`` (it serves targets
above 1,572,864 rows), so the threshold is lowered here for one call of the
un-jitted ``gicp_linearize_tables`` — a jit cache hit would keep the listed
route. Inputs come from seeded numpy generators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops import gicp_fused_pallas as jfused
from small_gicp_tpu.utils.lie import se3_exp as j_se3_exp
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.ops import gicp_fused_cuda as fused
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    gicp_linearize_tables,
    gicp_prepare,
    swept_live_tiles,
)

TWIST = [0.02, -0.01, 0.03, 0.05, -0.1, 0.08]


def _pad(x, cap):
    out = np.full((cap, 4), 1e9, np.float32)
    out[:, 3] = 0.0
    out[:len(x), :3] = x
    out[:len(x), 3] = 1.0
    return out


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
    return dict(tp=_pad(tp, m + 20), sp=_pad(sp, n + 12), tn=m, sn=n,
                tc=covs(m, m + 20), sc=covs(n, n + 12), normals=normals)


@pytest.fixture(scope="module")
def pair():
    return _make_pair(7, 700, 900, 8.0)


@pytest.fixture(scope="module")
def far_pair():
    # The target spreads over 80 m: most of its tiles lie beyond the reach
    # of any one block of source rows.
    return _make_pair(9, 700, 3000, 40.0)


def _T():
    return np.array(j_se3_exp(jnp.asarray(TWIST, jnp.float32)))


def _tables(p, factor, route, sn=None, tn=None):
    tgt = cloud_from_numpy(p["tp"], p["tn"] if tn is None else tn,
                           normals=p["normals"], covs=p["tc"], device="cpu")
    src = cloud_from_numpy(p["sp"], p["sn"] if sn is None else sn, covs=p["sc"],
                           device="cpu")
    return gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                        factor, tgt.covs, src.covs, tgt.normals, route=route)


def _jax_swept(p, factor, robust, c, T, monkeypatch):
    """The Pallas grid-swept kernel over JAX's own tables: (H, b, inliers,
    corr [N,16] in original source order)."""
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
        interpret=True, factor=factor, robust=robust, robust_c=c)
    corr = np.zeros((n, 16), np.float32)
    corr[np.asarray(sperm)] = np.asarray(corr16)[:, :n].T
    return np.asarray(H), np.asarray(b), float(inl), corr


def _check_against_pallas(p, factor, robust, c, monkeypatch):
    T = _T()
    jH, jb, jinl, jcorr = _jax_swept(p, factor, robust, c, T, monkeypatch)
    tables = _tables(p, factor, "swept")
    H, b, inl, corr = gicp_linearize_tables(tables, torch.as_tensor(T), 1.0, robust, c)
    corr = corr.numpy()
    mask, jmask = corr[:, 12] > 0.5, jcorr[:, 12] > 0.5
    # The tolerances tests/test_torch_gicp.py holds K1 to: the mask is exact;
    # μ, d² and W on inlier rows agree to float32 rounding; H and b, scaled by
    # their largest entry, to 5e-4. Rows without a correspondence are not
    # compared: the Pallas kernel leaves them to whatever tile it saw.
    np.testing.assert_array_equal(mask, jmask)
    assert int(inl) == int(jinl) == int(mask.sum())
    np.testing.assert_allclose(corr[mask, 0:3], jcorr[mask, 0:3], atol=1e-5)
    np.testing.assert_allclose(corr[mask, 13], jcorr[mask, 13], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(corr[mask, 3:12], jcorr[mask, 3:12], rtol=2e-3, atol=2e-3)
    scale = max(1.0, float(np.abs(jH).max()))
    np.testing.assert_allclose(H.numpy() / scale, jH / scale, atol=5e-4)
    bscale = max(1.0, float(np.abs(jb).max()))
    np.testing.assert_allclose(b.numpy() / bscale, jb / bscale, atol=5e-4)
    assert H.dtype == torch.float64 and b.dtype == torch.float64


@pytest.mark.parametrize("factor", ["gicp", "plane_icp", "icp"])
def test_swept_plain_matches_pallas_fused_kernel(pair, factor, monkeypatch):
    _check_against_pallas(pair, factor, None, 1.0, monkeypatch)


def test_swept_plain_matches_pallas_fused_kernel_robust(pair, monkeypatch):
    _check_against_pallas(pair, "gicp", "huber", 0.5, monkeypatch)


def _check_against_listed(tables, T, robust=None, c=1.0):
    """K6's plain version against K1's on the same tables."""
    H, b, inl, corr = gicp_linearize_tables(tables, T, 1.0, robust, c)
    H1, b1, inl1, corr1 = gicp_linearize_tables(tables, T, 1.0, robust, c,
                                                route="listed")
    mask = corr[:, 12] > 0.5
    assert torch.equal(mask, corr1[:, 12] > 0.5) and int(inl) == int(inl1)
    assert torch.equal(corr[mask], corr1[mask])  # μ, W, d² bit-equal
    assert torch.all(corr[~mask][:, :13] == 0) and torch.all(corr[~mask][:, 13] == 3.0e38)
    scale = max(1.0, H1.abs().max().item())
    torch.testing.assert_close(H / scale, H1 / scale, rtol=0, atol=1e-6)
    bscale = max(1.0, b1.abs().max().item())
    torch.testing.assert_close(b / bscale, b1 / bscale, rtol=0, atol=1e-6)
    return mask


def test_swept_plain_matches_listed_plain(pair):
    T = torch.as_tensor(_T())
    for factor, robust, c in (("gicp", None, 1.0), ("plane_icp", "cauchy", 0.3),
                              ("icp", "huber", 0.5)):
        mask = _check_against_listed(_tables(pair, factor, "swept"), T, robust, c)
        assert 0 < int(mask.sum()) <= pair["sn"]


def test_far_tiles_are_skipped(far_pair):
    T = torch.as_tensor(_T())
    tables = _tables(far_pair, "gicp", "swept")
    live = swept_live_tiles(tables, T, 1.0)
    assert live.shape == (12, 12)  # 712 source rows / 64, 3,020 target rows / 256
    assert 0.0 < live.float().mean().item() < 1.0
    assert not live[:, -1].all()
    mask = _check_against_listed(tables, T)
    assert int(mask.sum()) > 300  # the pose moves the far rows out of reach
    # A wider rejector keeps more tiles and never fewer.
    assert bool((swept_live_tiles(tables, T, 25.0) | ~live).all())


def test_blocks_without_a_valid_source_row(pair):
    T = torch.as_tensor(_T())
    tables = _tables(pair, "gicp", "swept", sn=100)  # blocks 2-11 hold padding only
    assert not swept_live_tiles(tables, T, 1.0)[2:].any()
    mask = _check_against_listed(tables, T)
    assert int(mask.sum()) <= 100
    tables = _tables(pair, "gicp", "swept", sn=0)
    H, b, inl, corr = gicp_linearize_tables(tables, T, 1.0)
    assert int(inl) == 0 and not corr[:, :13].any()
    assert torch.all(H == 0) and torch.all(b == 0)


def test_empty_target(pair):
    T = torch.as_tensor(_T())
    tables = _tables(pair, "gicp", "swept", tn=0)
    assert not swept_live_tiles(tables, T, 1.0).any()
    H, b, inl, corr = gicp_linearize_tables(tables, T, 1.0)
    assert int(inl) == 0 and not corr[:, :13].any()
    assert torch.all(corr[:, 13] == 3.0e38) and torch.all(H == 0)


def test_corr_rows_stay_in_source_order(pair):
    T = torch.as_tensor(_T())
    base = gicp_linearize_tables(_tables(pair, "gicp", "swept"), T, 1.0)
    perm = np.random.default_rng(3).permutation(pair["sn"])
    shuffled = dict(pair, sp=pair["sp"].copy(), sc=pair["sc"].copy())
    shuffled["sp"][:pair["sn"]] = pair["sp"][perm]
    shuffled["sc"][:pair["sn"]] = pair["sc"][perm]
    tables = _tables(shuffled, "gicp", "swept")
    assert not torch.equal(tables.sperm, torch.arange(len(tables.sperm), dtype=torch.int32))
    H, b, inl, corr = gicp_linearize_tables(tables, T, 1.0)
    assert int(inl) == int(base[2])
    assert torch.equal(corr[:pair["sn"]], base[3][:pair["sn"]][perm])
    assert torch.equal(tables.qtab[:, :3], torch.as_tensor(shuffled["sp"][:, :3]))


def test_routes_by_size_and_by_force(pair, monkeypatch):
    assert fused.LISTED_MP_CAP == 1_572_864
    T = torch.as_tensor(_T())
    auto = _tables(pair, "gicp", None)
    assert auto.route == "listed" and auto.tsorted is None
    monkeypatch.setattr(fused, "LISTED_MP_CAP", 500)
    swept = _tables(pair, "gicp", None)  # 920 target rows > 500
    assert swept.route == "swept" and swept.tbox.shape == (4, 8)
    calls = []
    real = fused.gicp_linearize_swept
    monkeypatch.setattr(fused, "gicp_linearize_swept",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = gicp_linearize_tables(swept, T, 1.0)
    assert calls == [1]
    gicp_linearize_tables(swept, T, 1.0, route="listed")
    assert calls == [1]
    # mxu_dist is ignored on the swept route
    again = gicp_linearize_tables(swept, T, 1.0, mxu_dist=True)
    assert calls == [1, 1] and torch.equal(again[3], out[3])
    with pytest.raises(ValueError, match="route"):
        _tables(pair, "gicp", "dense")
    with pytest.raises(ValueError, match="swept"):
        gicp_linearize_tables(auto, T, 1.0, route="swept")
    # the listed tables are the same on either route
    assert torch.equal(auto.ttab, swept.ttab) and torch.equal(auto.qtab, swept.qtab)
