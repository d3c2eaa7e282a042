"""The map-scale slice as a whole on the CPU: the score form of the fused
linearize against the Pallas ``mxu_dist=True`` branch in interpret mode and
against the difference form, the Morton order against the JAX presort, and
``align_impl`` with the swept route forced against the default route and
against the JAX ``align_impl``.

Inputs: the 700 / 900-point pair of tests/test_gicp_fused.py from a seeded
numpy generator, and a 16-ring × 256-step synthetic scan pair downsampled
by the port at 0.75 m (≈1.5k rows a cloud, in tables of the raw scans'
capacity, so that JAX's compilation cache serves its align); the JAX align
takes the port's preprocessed clouds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_gicp_tpu as sgt
from small_gicp_tpu.models.registration import align_impl as j_align_impl
from small_gicp_tpu.ops import gicp_fused_pallas as jfused
import small_gicp_tpu_torch as pt
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.models.registration import Registration, align_impl
from small_gicp_tpu_torch.ops import gicp_fused_cuda as fused
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    gicp_linearize_score,
    gicp_linearize_tables,
    gicp_prepare,
)
from small_gicp_tpu_torch.ops import morton_boxes
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.utils.lie import rotation_error_deg, se3_exp
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

ROT_EPS = 0.1 * math.pi / 180.0
TRANS_EPS = 1e-3
LEAF = 0.75


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain walks run many small torch ops; the suite runs several
    worker processes on the same cores, where intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    n, m = 700, 900
    tp = rng.uniform(-8, 8, size=(m, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0]) * 0.5 + 0.05 * rng.normal(size=m)
    sp = tp[rng.permutation(m)[:n]] + rng.normal(scale=0.05, size=(n, 3)).astype(
        np.float32)

    def covs(k):
        a = rng.normal(size=(k, 3, 3)).astype(np.float32) * 0.05
        return np.einsum("nij,nkj->nik", a, a) + np.eye(3, dtype=np.float32) * 0.01

    ones = lambda x: np.c_[x, np.ones(len(x), np.float32)]  # noqa: E731
    return dict(tp=ones(tp), sp=ones(sp), tc=covs(m), sc=covs(n), tn=m, sn=n)


def _T():
    return se3_exp(torch.tensor([0.02, -0.01, 0.03, 0.05, -0.1, 0.08],
                                dtype=torch.float32)).numpy()


def _tables(pair, factor="gicp"):
    tgt = cloud_from_numpy(pair["tp"], pair["tn"], covs=pair["tc"], device="cpu")
    src = cloud_from_numpy(pair["sp"], pair["sn"], covs=pair["sc"], device="cpu")
    return gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                        factor, tgt.covs, src.covs)


def _near_exact(H1, i1, c1, H0, i0, c0):
    """The bounds of tests/test_gicp_fused.py::test_mxu_dist_variant_matches_vpu_form:
    ties at the score's rounding may flip a membership."""
    assert i0 == i1
    m0, m1 = c0[:, 12] > 0.5, c1[:, 12] > 0.5
    assert (m0 != m1).mean() < 0.01
    scale = max(1.0, np.abs(H0).max())
    np.testing.assert_allclose(H1 / scale, H0 / scale, atol=5e-4)
    both = m0 & m1
    np.testing.assert_allclose(c1[both, 13], c0[both, 13], atol=1e-4)
    return both


def test_score_form_plain_matches_pallas_mxu_dist(pair):
    T = _T()
    ttab, tb, qtab, _, sperm, ttab_T = jfused.gicp_prepare(
        jnp.asarray(pair["tp"]), jnp.asarray(pair["tc"]), jnp.asarray(pair["sp"]),
        jnp.asarray(pair["sc"]), jnp.asarray(pair["sn"], jnp.int32))
    jH, _, jinl, corr16 = jfused.gicp_linearize_tables(
        ttab, tb, qtab, jnp.asarray(T), jnp.float32(1.0), ttab_T, interpret=True,
        mxu_dist=True)
    n = pair["sn"]
    jcorr = np.zeros((n, 16), np.float32)
    jcorr[np.asarray(sperm)] = np.asarray(corr16)[:, :n].T
    H, b, inl, corr = gicp_linearize_tables(_tables(pair), torch.as_tensor(T), 1.0,
                                            mxu_dist=True)
    both = _near_exact(H.numpy(), float(inl), corr.numpy(), np.asarray(jH), float(jinl),
                       jcorr)
    np.testing.assert_allclose(corr.numpy()[both, 0:3], jcorr[both, 0:3], atol=1e-5)


@pytest.mark.parametrize("factor", ["gicp", "plane_icp", "icp"])
def test_score_form_plain_matches_difference_form(pair, factor):
    T = torch.as_tensor(_T())
    tgt = cloud_from_numpy(pair["tp"], pair["tn"], covs=pair["tc"],
                           normals=np.tile(np.float32([0, 0, 1, 0]), (pair["tn"], 1)),
                           device="cpu")
    src = cloud_from_numpy(pair["sp"], pair["sn"], covs=pair["sc"], device="cpu")
    tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                          factor, tgt.covs, src.covs, tgt.normals)
    # ‖t‖² rides in the table, as the JAX table carries it
    xyz = tables.ttab[:, :3]
    assert torch.equal(tables.ttab[:, 13],
                       xyz[:, 0] * xyz[:, 0] + xyz[:, 1] * xyz[:, 1] + xyz[:, 2] * xyz[:, 2])
    for robust, c in ((None, 1.0), ("huber", 0.5)):
        H0, b0, i0, c0 = gicp_linearize_tables(tables, T, 1.0, robust, c)
        H1, b1, i1, c1 = gicp_linearize_score(tables, T, 1.0, robust, c)
        both = _near_exact(H1.numpy(), float(i1), c1.numpy(), H0.numpy(), float(i0),
                           c0.numpy())
        assert both.sum() > 600
        bscale = max(1.0, b0.abs().max().item())
        torch.testing.assert_close(b1 / bscale, b0 / bscale, rtol=0, atol=5e-4)


def test_morton_order_matches_jax_presort(pair):
    rng = np.random.default_rng(2)
    sp = np.concatenate([pair["sp"], np.full((12, 4), 1e9, np.float32)])
    sp[pair["sn"]:, 3] = 0.0
    sc = np.concatenate([pair["sc"], np.zeros((12, 3, 3), np.float32)])
    tp = pair["tp"][rng.permutation(pair["tn"])]
    want = jfused.morton_presort(jnp.asarray(tp), jnp.asarray(pair["tc"]),
                                 jnp.asarray(sp), jnp.asarray(sc),
                                 jnp.asarray(pair["sn"], jnp.int32))
    t_xyz, s_xyz = torch.as_tensor(tp[:, :3]), torch.as_tensor(sp[:, :3])
    tperm = morton_boxes.morton_order(t_xyz, torch.ones(len(tp), dtype=torch.bool))[1]
    sperm = morton_boxes.morton_order(s_xyz, torch.arange(len(sp)) < pair["sn"])[1]
    got = (tp[tperm.numpy()], pair["tc"][tperm.numpy()], sp[sperm.numpy()],
           sc[sperm.numpy()])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the swept tables carry exactly these orders, whether the target's half
    # is made by gicp_prepare or handed in
    tgt = cloud_from_numpy(tp, pair["tn"], covs=pair["tc"], device="cpu")
    src = cloud_from_numpy(sp, pair["sn"], covs=sc, device="cpu")
    args = (tgt.points, tgt.num_points, src.points, src.num_points, "gicp", tgt.covs,
            src.covs)
    made = gicp_prepare(*args, route="swept")
    kept = gicp_prepare(*args, route="swept",
                        target=morton_boxes.pruned_prepare_target(tgt.points,
                                                                  tgt.num_points))
    assert torch.equal(made.sperm.long(), sperm)
    assert torch.equal(made.tsorted[:, 3].contiguous().view(torch.int32).long(), tperm)
    for name in ("ttab", "qtab", "tsorted", "tbox", "sperm"):
        assert torch.equal(getattr(made, name), getattr(kept, name))
    with pytest.raises(ValueError, match="target="):
        gicp_prepare(*args, route="swept",
                     target=morton_boxes.pruned_prepare_target(src.points,
                                                               src.num_points))


def _errors(T, T_ref):
    T = torch.as_tensor(np.asarray(T, np.float64))
    T_ref = torch.as_tensor(np.asarray(T_ref, np.float64))
    return (float(rotation_error_deg(T_ref[:3, :3], T[:3, :3])),
            float(torch.linalg.vector_norm(T[:3, 3] - T_ref[:3, 3])))


def _agree(a_T, a_it, b_T, b_it):
    d_rot, d_trans = _errors(a_T, b_T)
    assert math.radians(d_rot) <= 2 * ROT_EPS and d_trans <= 2 * TRANS_EPS
    assert abs(int(a_it) - int(b_it)) <= 1


@pytest.fixture(scope="module")
def scan_pair():
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    rng = np.random.default_rng(11)
    tw = np.r_[rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.2]
    init = (T_gt @ se3_exp(torch.as_tensor(tw)).numpy()).astype(np.float32)
    tt, ttree = pt.preprocess_points(scans[0], LEAF, num_neighbors=10, device="cpu")
    ts, _ = pt.preprocess_points(scans[1], LEAF, num_neighbors=10, device="cpu")
    return scans, T_gt, init, (tt, ttree, ts)


def test_align_swept_route_matches_default_and_jax(scan_pair):
    scans, T_gt, init, (tt, ttree, ts) = scan_pair
    swept = align_impl(tt, ts, ttree, init, fused_route="swept")
    listed = align_impl(tt, ts, ttree, init)
    # The JAX align on the port's preprocessed clouds: the same inputs.
    jt, js = (sgt.PointCloud(points=jnp.asarray(c.points.numpy()),
                             num_points=jnp.asarray(int(c.num_points), jnp.int32),
                             covs=jnp.asarray(c.covs.numpy())) for c in (tt, ts))
    jr = j_align_impl(jt, js, sgt.KdTree.build(jt), jnp.asarray(init))
    rot, trans = _errors(swept.T_target_source.numpy(), T_gt)
    assert rot < 2.5 and trans < 0.2 and bool(swept.converged)
    _agree(swept.T_target_source.numpy(), swept.iterations,
           listed.T_target_source.numpy(), listed.iterations)
    _agree(swept.T_target_source.numpy(), swept.iterations,
           np.asarray(jr.T_target_source), jr.iterations)
    assert int(swept.num_inliers) == int(listed.num_inliers)


@pytest.mark.parametrize("kwargs", [
    dict(registration_type="plane_icp"),
    dict(robust_kernel="huber", robust_c=0.5),
    dict(optimizer="gn"),
])
def test_align_swept_route_variants(scan_pair, kwargs):
    _, T_gt, init, (tt, ttree, ts) = scan_pair
    swept = Registration(fused_route="swept", **kwargs).align(tt, ts, ttree, init)
    listed = Registration(**kwargs).align(tt, ts, ttree, init)
    rot, trans = _errors(swept.T_target_source.numpy(), T_gt)
    assert rot < 2.5 and trans < 0.2
    _agree(swept.T_target_source.numpy(), swept.iterations,
           listed.T_target_source.numpy(), listed.iterations)


def test_align_takes_the_swept_route_for_a_large_target(scan_pair, monkeypatch):
    _, _, init, (tt, _, ts) = scan_pair
    calls = {"prepare": 0, "swept": 0, "sort by the tree": 0, "sort by prepare": 0}

    def counted(name, real):
        def call(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return call

    from small_gicp_tpu_torch.models import registration

    monkeypatch.setattr(registration, "gicp_prepare",
                        counted("prepare", fused.gicp_prepare))
    monkeypatch.setattr(fused, "gicp_linearize_swept",
                        counted("swept", fused.gicp_linearize_swept))
    monkeypatch.setattr(morton_boxes, "pruned_prepare_target",
                        counted("sort by the tree", morton_boxes.pruned_prepare_target))
    monkeypatch.setattr(fused, "pruned_prepare_target",
                        counted("sort by prepare", fused.pruned_prepare_target))
    monkeypatch.setattr(fused, "LISTED_MP_CAP", 1000)  # the target has more rows
    tree = KdTree.build(tt)
    res = pt.align(tt, ts, tree, init_T_target_source=init)
    # prepared once before the loop, swept at every linearization
    assert calls["prepare"] == 1 and calls["swept"] == int(res.iterations) + 1
    # a tree over the target keeps its sort and boxes from align to align
    again = pt.align(tt, ts, tree, init_T_target_source=init)
    assert calls["sort by the tree"] == 1 and calls["sort by prepare"] == 0
    assert torch.equal(again.T_target_source, res.T_target_source)
    bare = pt.align(tt, ts, init_T_target_source=init)
    assert calls["sort by the tree"] == 1 and calls["sort by prepare"] == 1
    assert torch.equal(bare.T_target_source, res.T_target_source)
    swept_calls = calls["swept"]
    forced = pt.align(tt, ts, tree, init_T_target_source=init, fused_route="listed")
    assert calls["swept"] == swept_calls
    _agree(res.T_target_source.numpy(), res.iterations,
           forced.T_target_source.numpy(), forced.iterations)
    with pytest.raises(ValueError, match="fused_route"):
        align_impl(tt, ts, tree, init, fused_route="dense")
