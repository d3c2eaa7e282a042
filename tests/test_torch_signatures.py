"""The port's one-call API takes its parameters in the JAX package's
positions and spellings: ``preprocess_points``, ``align``,
``RegistrationSetting``, ``Registration``, ``align_impl``,
``voxelgrid_sampling``, ``estimate_normals``, ``estimate_covariances``,
``estimate_normals_covariances``, ``fleet_prepare``, ``align_fleet``,
``KdTree.knn_search``, ``ProjectiveSearch.build``,
``voxelgrid_sampling_with_covs``, ``odometry_scan_batch`` and
``BatchOdometry.__init__`` list the same parameters with the same defaults, in the same order, apart
from the port's own (``optimizer``, ``device``, ``fused_route``,
``source_rows``), which follow as keywords only; the JAX package's ``num_threads``, ``block_q`` and
``interpret`` are accepted and ignored. The voxel maps' public names
(``GaussianVoxelMap.empty/build/insert``, ``IncrementalVoxelMap.empty/
insert/knn_search``, the three ``IncrementalVoxelMap*`` constructors,
``create_gaussian_voxelmap`` and ``transform_covs``) do the same, with the
dtype defaults in each package's own type (``jnp.float32`` ↔
``torch.float32``) and ``device`` keyword-only after them. Both packages are called positionally and by keyword on a
16-ring × 256-step synthetic scan pair; ``verbose=True`` prints one line
per iteration in each, with the same fields.
"""

import dataclasses
import inspect
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_gicp_tpu as sgt
from small_gicp_tpu.models import helper as j_helper
from small_gicp_tpu.models import registration as j_registration
from small_gicp_tpu.ops import downsampling as j_downsampling
from small_gicp_tpu.ops import normals as j_normals
from small_gicp_tpu.models import voxelmap as j_voxelmap
from small_gicp_tpu import point_cloud as j_point_cloud
from small_gicp_tpu.parallel import fleet as j_fleet
from small_gicp_tpu.models import odometry_scan as j_odometry_scan
from small_gicp_tpu.ops import knn as j_knn
from small_gicp_tpu.ops import projective_search as j_projective
from small_gicp_tpu.ops import voxel_covs as j_voxel_covs
import small_gicp_tpu_torch as pt
from small_gicp_tpu_torch.models import helper as t_helper
from small_gicp_tpu_torch.models import registration as t_registration
from small_gicp_tpu_torch.ops import downsampling as t_downsampling
from small_gicp_tpu_torch.ops import normals as t_normals
from small_gicp_tpu_torch.models import voxelmap as t_voxelmap
from small_gicp_tpu_torch import point_cloud as t_point_cloud
from small_gicp_tpu_torch.parallel import fleet as t_fleet
from small_gicp_tpu_torch.models import odometry_scan as t_odometry_scan
from small_gicp_tpu_torch.ops import knn as t_knn
from small_gicp_tpu_torch.ops import projective_search as t_projective
from small_gicp_tpu_torch.ops import voxel_covs as t_voxel_covs
from small_gicp_tpu_torch.utils.lie import rotation_error_deg, se3_exp
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

PORT_ONLY = {"optimizer", "device", "fused_route", "source_rows"}
ROT_EPS = 0.1 * math.pi / 180.0


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


MODULES = {
    "preprocess_points": (j_helper, t_helper),
    "align": (j_helper, t_helper),
    "Registration": (j_registration, t_registration),
    "align_impl": (j_registration, t_registration),
    "voxelgrid_sampling": (j_downsampling, t_downsampling),
    "estimate_normals": (j_normals, t_normals),
    "estimate_covariances": (j_normals, t_normals),
    "estimate_normals_covariances": (j_normals, t_normals),
    "fleet_prepare": (j_fleet, t_fleet),
    "align_fleet": (j_fleet, t_fleet),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_parameters_mirror_the_jax_package(name):
    j_mod, t_mod = MODULES[name]
    j_fn, t_fn = getattr(j_mod, name), getattr(t_mod, name)
    _mirrors(name, _params(j_fn.__init__ if name == "Registration" else j_fn),
             _params(t_fn.__init__ if name == "Registration" else t_fn))


# The windowed search, the voxel covariances, the projective searcher and the
# batched odometry: (JAX module, port module) of each dotted name.
A9_NAMES = {
    "KdTree.knn_search": (j_knn, t_knn),
    "ProjectiveSearch.build": (j_projective, t_projective),
    "voxelgrid_sampling_with_covs": (j_voxel_covs, t_voxel_covs),
    "odometry_scan_batch": (j_odometry_scan, t_odometry_scan),
    "BatchOdometry.__init__": (j_odometry_scan, t_odometry_scan),
}


@pytest.mark.parametrize("name", list(A9_NAMES))
def test_a9_parameters_mirror_the_jax_package(name):
    j_mod, t_mod = A9_NAMES[name]
    _mirrors(name, _params(_resolve(j_mod, name)), _params(_resolve(t_mod, name)))


def _mirrors(name, j_params, t_params):
    """The port's parameters are the JAX package's, in its positions, kinds
    and defaults, then the port's own as keywords only."""
    j_names = [p.name for p in j_params]
    # The port's own parameters trail the JAX package's, keyword-only.
    own = [p for p in t_params if p.name not in j_names]
    assert {p.name for p in own} <= PORT_ONLY, name
    assert all(p.kind is p.KEYWORD_ONLY for p in own), name
    assert t_params[:len(j_params)] == t_params[:len(t_params) - len(own)], name
    shared = t_params[:len(j_params)]
    assert [p.name for p in shared] == j_names, name
    for jp, tp in zip(j_params, shared):
        assert tp.kind is jp.kind, (name, jp.name)
        if isinstance(jp.default, float):
            assert tp.default == pytest.approx(jp.default, rel=1e-12), (name, jp.name)
        else:
            assert tp.default == jp.default, (name, jp.name)


VOXEL_NAMES = {
    "GaussianVoxelMap.empty": j_voxelmap, "GaussianVoxelMap.build": j_voxelmap,
    "GaussianVoxelMap.insert": j_voxelmap, "IncrementalVoxelMap.empty": j_voxelmap,
    "IncrementalVoxelMap.insert": j_voxelmap, "IncrementalVoxelMap.knn_search": j_voxelmap,
    "IncrementalVoxelMapNormal": j_voxelmap, "IncrementalVoxelMapCov": j_voxelmap,
    "IncrementalVoxelMapNormalCov": j_voxelmap, "create_gaussian_voxelmap": j_helper,
    "transform_covs": j_point_cloud,
}
_T_MODULE = {j_voxelmap: t_voxelmap, j_helper: t_helper, j_point_cloud: t_point_cloud}


def _resolve(mod, dotted):
    obj = mod
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("name", list(VOXEL_NAMES))
def test_voxel_map_parameters_mirror_the_jax_package(name):
    j_mod = VOXEL_NAMES[name]
    j_params = _params(_resolve(j_mod, name))
    t_params = _params(_resolve(_T_MODULE[j_mod], name))
    own = t_params[len(j_params):]
    assert [p.name for p in own] in ([], ["device"]), name
    assert all(p.kind is p.KEYWORD_ONLY for p in own), name
    assert [p.name for p in t_params[:len(j_params)]] == [p.name for p in j_params], name
    for jp, tp in zip(j_params, t_params):
        assert tp.kind is jp.kind, (name, jp.name)
        if jp.name == "dtype":
            assert jp.default == jnp.float32 and tp.default == torch.float32, name
        else:
            assert tp.default == jp.default, (name, jp.name)


def test_registration_setting_mirrors_the_jax_package():
    j_fields = [(f.name, f.default) for f in dataclasses.fields(sgt.RegistrationSetting)]
    t_fields = [(f.name, f.default) for f in dataclasses.fields(pt.RegistrationSetting)]
    assert [n for n, _ in t_fields] == [n for n, _ in j_fields]
    for (n, jd), (_, td) in zip(j_fields, t_fields):
        assert td == pytest.approx(jd, rel=1e-12) if isinstance(jd, float) else td == jd, n
    # Positionally: num_threads is the 7th field, verbose the 9th.
    s = pt.RegistrationSetting("icp", 1.0, 0.5, 2.0, 0.01, 0.02, 8, 5, True)
    assert (s.num_threads, s.max_iterations, s.verbose) == (8, 5, True)


@pytest.fixture(scope="module")
def scan_pair():
    scans, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    rng = np.random.default_rng(5)
    tw = np.r_[rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.2]
    init = (T_gt @ se3_exp(torch.as_tensor(tw)).numpy()).astype(np.float32)
    return scans, T_gt, init


def test_preprocess_points_positional_num_threads(scan_pair):
    """The 4th positional argument is num_threads in both: it does not cap
    the cloud (it did, as max_points, before)."""
    scans, _, _ = scan_pair
    jc, _ = sgt.preprocess_points(scans[0], 0.25, 10, 4)
    tc, _ = pt.preprocess_points(scans[0], 0.25, 10, 4, device="cpu")
    assert int(tc.num_points) == int(jc.num_points) > 1000
    capped, _ = pt.preprocess_points(scans[0], 0.25, 10, 4, 500, device="cpu")
    assert int(capped.num_points) <= 500


def _pose_errors(T, T_ref):
    T = torch.as_tensor(np.asarray(T, np.float64))
    T_ref = torch.as_tensor(np.asarray(T_ref, np.float64))
    return (math.radians(float(rotation_error_deg(T_ref[:3, :3], T[:3, :3]))),
            float(torch.linalg.vector_norm(T[:3, 3] - T_ref[:3, 3])))


LM_LINE = re.compile(r"^iter=\d+ e=\S+ new_e=\S+ lambda=\S+ dr=\S+ dt=\S+$")
GN_LINE = re.compile(r"^iter=\d+ e=\S+ gn_lambda=\S+ dr=\S+ dt=\S+$")


def _lines(text, pattern):
    lines = [ln for ln in text.splitlines() if ln.startswith("iter=")]
    assert lines and all(pattern.match(ln) for ln in lines), lines
    return lines


def test_align_by_keyword_and_verbose_in_both(scan_pair, capfd):
    scans, T_gt, init = scan_pair
    kw = dict(init_T_target_source=init, verbose=True, num_threads=4,
              rotation_epsilon=0.5 * ROT_EPS, translation_epsilon=5e-4,
              voxel_resolution=1.0)
    jr = sgt.align(scans[0], scans[1], **kw)
    j_out = capfd.readouterr().out
    tr = pt.align(scans[0], scans[1], device="cpu", **kw)
    t_out = capfd.readouterr().out
    # One line per executed iteration in each package, the same fields.
    assert len(_lines(j_out, LM_LINE)) == int(jr.iterations) + 1
    assert len(_lines(t_out, LM_LINE)) == int(tr.iterations) + 1
    d_rot, d_trans = _pose_errors(tr.T_target_source.numpy(), jr.T_target_source)
    assert d_rot <= 2 * ROT_EPS and d_trans <= 2e-3
    assert abs(int(jr.iterations) - int(tr.iterations)) <= 1


def test_align_positionally_in_both(scan_pair):
    """Every JAX parameter by position: target, source, tree, init, type,
    voxel_resolution, downsampling_resolution, max_correspondence_distance,
    num_threads, max_iterations, rotation_eps, translation_eps, verbose,
    max_points."""
    scans, T_gt, init = scan_pair
    args = (None, init, "gicp", 1.0, 0.25, 1.0, 4, 20, ROT_EPS, 1e-3, False, None)
    jr = sgt.align(scans[0], scans[1], *args)
    tr = pt.align(scans[0], scans[1], *args, device="cpu")
    d_rot, d_trans = _pose_errors(tr.T_target_source.numpy(), jr.T_target_source)
    assert d_rot <= 2 * ROT_EPS and d_trans <= 2e-3
    rot, trans = _pose_errors(tr.T_target_source.numpy(), T_gt)
    assert math.degrees(rot) < 2.5 and trans < 0.2


@pytest.fixture(scope="module")
def preprocessed(scan_pair):
    scans, _, _ = scan_pair
    jt, jtree = sgt.preprocess_points(scans[0], 0.25, 10)
    js, _ = sgt.preprocess_points(scans[1], 0.25, 10)
    tt, ttree = pt.preprocess_points(scans[0], 0.25, 10, device="cpu")
    ts, _ = pt.preprocess_points(scans[1], 0.25, 10, device="cpu")
    return (jt, jtree, js), (tt, ttree, ts)


def test_registration_positionally_in_both(scan_pair, preprocessed, capfd):
    """verbose sits before solve_dtype; GN prints its fixed damping."""
    _, T_gt, init = scan_pair
    (jt, jtree, js), (tt, ttree, ts) = preprocessed
    args = ("gicp", "gn", None, 1.0, 20, 10, 1.0, ROT_EPS, 1e-3, None, None, True,
            "float64")
    jreg, treg = j_registration.Registration(*args), t_registration.Registration(*args)
    assert treg.verbose is True and treg.solve_dtype == "float64"
    assert (jreg.verbose, jreg.solve_dtype) == (treg.verbose, treg.solve_dtype)
    jr = jreg.align(jt, js, jtree, init)
    j_out = capfd.readouterr().out
    tr = treg.align(tt, ts, ttree, init)
    t_out = capfd.readouterr().out
    assert len(_lines(j_out, GN_LINE)) == int(jr.iterations) + 1
    assert len(_lines(t_out, GN_LINE)) == int(tr.iterations) + 1
    d_rot, d_trans = _pose_errors(tr.T_target_source.numpy(), jr.T_target_source)
    assert d_rot <= 2 * ROT_EPS and d_trans <= 2e-3


def test_align_impl_positionally_in_both(scan_pair, preprocessed):
    """Every parameter up to solve_dtype by position, psum_axis among them."""
    _, _, init = scan_pair
    (jt, jtree, js), (tt, ttree, ts) = preprocessed
    args = ("gicp", "lm", None, 1.0, 20, 10, 1.0, ROT_EPS, 1e-3, 1e-3, 10.0, 1e-6,
            None, 1e9, False, "auto", None, "same")
    jr = j_registration.align_impl(jt, js, jtree, init, *args)
    tr = t_registration.align_impl(tt, ts, ttree, init, *args)
    d_rot, d_trans = _pose_errors(tr.T_target_source.numpy(), jr.T_target_source)
    assert d_rot <= 2 * ROT_EPS and d_trans <= 2e-3
    assert abs(int(jr.iterations) - int(tr.iterations)) <= 1
    # The port's psum_axis is a mesh (tests/test_torch_sharding.py), not a name.
    with pytest.raises(TypeError, match="psum_axis must be a 1-D DeviceMesh"):
        t_registration.align_impl(tt, ts, ttree, init, psum_axis="points")


def test_ops_positionally_in_both(scan_pair):
    """voxelgrid_sampling(pts, 0.25, None, 1) and estimate_covariances(c,
    tree, 10, 4): num_threads, not the device or a TypeError."""
    scans, _, _ = scan_pair
    # float64, as tests/test_torch_preprocess.py compares the covariances:
    # in float32 the two searches may order near-tied kth neighbours apart.
    frame = scans[0].astype(np.float64)
    jd = j_downsampling.voxelgrid_sampling(frame, 0.25, None, 1)
    td = t_downsampling.voxelgrid_sampling(frame, 0.25, None, 1, device="cpu")
    n = int(jd.num_points)
    assert int(td.num_points) == n > 1000
    np.testing.assert_allclose(td.points.numpy(), np.asarray(jd.points), atol=1e-9)
    jc = j_normals.estimate_covariances(jd, None, 10, 4)
    tc = t_normals.estimate_covariances(td, pt.KdTree.build(td), 10, 4)
    np.testing.assert_allclose(tc.covs.numpy(), np.asarray(jc.covs), atol=1e-6)
    for name in ("estimate_normals", "estimate_normals_covariances"):
        out = getattr(t_normals, name)(td, None, 10, 4)
        assert out.normals is not None and out.num_points is td.num_points


def test_fleet_positionally(preprocessed):
    """fleet_prepare(t, s, 512) and align_fleet's 13th-15th positions
    (block_q, prepared, interpret) as in the JAX package."""
    _, (tt, _, ts) = preprocessed
    by_position = t_fleet.fleet_prepare(tt, ts, 512)
    by_keyword = t_fleet.fleet_prepare(tt, ts, registration_type="gicp")
    assert by_position.factor == "gicp"
    assert torch.equal(by_position.ttab, by_keyword.ttab)
    init = np.stack([np.eye(4, dtype=np.float32)] * 2)
    init[1, :3, 3] = [0.05, -0.05, 0.02]
    args = (init, None, 2, 20, 10, 1.0, ROT_EPS, 1e-3, 1e-3, 10.0, 512, by_position,
            None)
    a = t_fleet.align_fleet(None, None, *args)
    b = t_fleet.align_fleet(None, None, init, prepared=by_keyword, num_lanes=2)
    assert torch.equal(a.T_target_source, b.T_target_source)
    assert torch.equal(a.iterations, b.iterations)
