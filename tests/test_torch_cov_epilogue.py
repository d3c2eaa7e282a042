"""K3's epilogue against the torch epilogue it replaces on the card.

``_estimate_impl`` (``ops/normals.py``) finishes the covariance stage inside
K3's launch (``cov_fused_cuda.knn_normals_covs``) where it takes K3 on the
card, and with torch ops (``normals._torch_epilogue``) everywhere else. The
two must give the same normals and covariances bit for bit, so that every
cloud, and every registration over it, is the one the torch epilogue gives.

CPU tests: every caller of ``_estimate_impl`` still takes the torch
epilogue on the CPU, counted once a cloud, with the outputs of the torch
epilogue over ``knn_moments``. Card tests (``cuda`` marker; they skip
without a card): the kernel's normals and covariances against the torch
epilogue over K3's moment rows of the same cloud and sort, with
``torch.equal``, on the synthetic HDL-64 world's scans at k = 10 and 20,
padding rows, live rows between sentinel rows, rows of fewer than 5
neighbours, near-isotropic, collinear and planar patches. This file
imports neither JAX nor the JAX package; on the card:

    python -m pytest --noconftest -q tests/test_torch_cov_epilogue.py
"""

import numpy as np
import pytest
import torch

from small_gicp_tpu_torch.models.helper import preprocess_points
from small_gicp_tpu_torch.models.odometry_scan import _frame_cloud
from small_gicp_tpu_torch.ops import cov_fused_cuda
from small_gicp_tpu_torch.ops.cov_fused_cuda import knn_moments, knn_normals_covs
from small_gicp_tpu_torch.ops.normals import (
    _estimate_impl,
    _torch_epilogue,
    estimate_covariances,
    estimate_normals,
    estimate_normals_covariances,
)
from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.utils import profiling
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

NEEDS = [(True, True), (True, False), (False, True)]


def _padded(x, cap, lead=0):
    """[cap,4] float32: ``lead`` sentinel rows, then the rows of ``x``
    (w = 1), then sentinel rows."""
    out = np.full((cap, 4), 1e9, np.float32)
    out[:, 3] = 0.0
    out[lead:lead + len(x), :3] = x
    out[lead:lead + len(x), 3] = 1.0
    return out


def _counters(fn):
    profiling.reset()
    with profiling.tracing():
        out = fn()
    got = profiling.collected()["counters"]
    profiling.reset()
    return out, got.get("covs.torch_epilogue", 0), got.get("covs.fused_epilogue", 0)


def _yardstick(points, num, k, need_normals, need_covs, target=None):
    return _torch_epilogue(points, num, *knn_moments(points, num, k, target=target),
                           need_normals, need_covs)


# ------------------------------------------------------------ the CPU ----

@pytest.fixture(scope="module")
def scan():
    scans, _ = generate_sequence(n_frames=1, rings=16, azimuth_steps=256)
    pts = _padded(scans[0][:1500], 1540)
    return torch.as_tensor(pts), torch.tensor(1500, dtype=torch.int32)


@pytest.mark.parametrize("need", NEEDS)
def test_cpu_estimate_takes_the_torch_epilogue(scan, need):
    points, num = scan
    (normals, covs), torch_n, fused_n = _counters(
        lambda: _estimate_impl(points, num, 10, *need))
    assert (torch_n, fused_n) == (1, 0)
    want = _yardstick(points, num, 10, *need)
    for got, ref in zip((normals, covs), want):
        assert (got is None) == (ref is None)
        assert got is None or torch.equal(got, ref)


@pytest.mark.parametrize("caller", ["normals_covariances", "normals", "covariances",
                                    "preprocess", "odometry_frame"])
def test_cpu_callers_count_the_torch_epilogue_once_a_cloud(scan, caller):
    points, num = scan
    cloud = PointCloud(points=points, num_points=num)
    calls = {
        "normals_covariances": lambda: [estimate_normals_covariances(cloud, num_neighbors=10)
                                        for _ in range(2)],
        "normals": lambda: [estimate_normals(cloud, num_neighbors=10)],
        "covariances": lambda: [estimate_covariances(cloud, num_neighbors=10)
                                for _ in range(3)],
        "preprocess": lambda: [preprocess_points(cloud, 0.25, num_neighbors=10)[0]
                               for _ in range(2)],
        "odometry_frame": lambda: [_frame_cloud(points, num, 0.25, 1540, 20, "gicp")],
    }
    clouds, torch_n, fused_n = _counters(calls[caller])
    assert (torch_n, fused_n) == (len(clouds), 0)
    c = clouds[0]
    k = 20 if caller == "odometry_frame" else 10
    want = _yardstick(c.points, c.num_points, k, c.normals is not None, c.covs is not None)
    for got, ref in zip((c.normals, c.covs), want):
        assert got is None or torch.equal(got, ref)


def test_cpu_other_routes_count_the_torch_epilogue(scan):
    points, num = scan
    for mode, k, pts in (("window", 10, points), ("exact", 65, points),
                         ("exact", 10, points.double())):
        _, torch_n, fused_n = _counters(
            lambda: _estimate_impl(pts, num, k, True, True, neighbor_mode=mode))
        assert (torch_n, fused_n) == (1, 0), (mode, k, pts.dtype)


def test_fused_epilogue_needs_an_output(scan):
    points, num = scan
    with pytest.raises(ValueError, match="normals, covs or both"):
        knn_normals_covs(points, num, 10, False, False)


# ----------------------------------------------------------- the card ----

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _assert_same(points, num, k, target=None):
    """Every output mode of the kernel against the torch epilogue over K3's
    rows of the same cloud and sort: equal bit for bit, no row apart."""
    for need in NEEDS:
        got = knn_normals_covs(points, num, k, *need, target=target)
        want = _yardstick(points, num, k, *need, target=target)
        for name, g, w in zip(("normals", "covs"), got, want):
            assert (g is None) == (w is None)
            if g is None:
                continue
            apart = int((g.view(torch.int32) != w.view(torch.int32)).flatten(1).any(1)
                        .sum())
            assert torch.equal(g, w), (f"{name} at k = {k}, {need}: {apart} of "
                                       f"{g.shape[0]} rows differ")


@pytest.fixture(scope="module")
def hdl64(dev):
    """Three frames of the synthetic HDL-64 world (64 rings × 1800 steps,
    ≈108k returns) downsampled at 0.25 m, each with its tree."""
    from small_gicp_tpu_torch.utils.synthetic import generate_sequence_device

    frames, counts, _ = generate_sequence_device(n_frames=3, rings=64,
                                                 azimuth_steps=1800, device=dev)
    out = []
    for f in range(frames.shape[0]):
        raw = PointCloud(points=frames[f].contiguous(), num_points=counts[f])
        out.append(preprocess_points(raw, 0.25, num_neighbors=10))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 20])
def test_hdl64_scans_equal_the_torch_epilogue(dev, hdl64, k):
    for cloud, tree in hdl64:
        assert int(cloud.num_points) > 10_000
        _assert_same(cloud.points, cloud.num_points, k, target=tree.pruned_target())
        _assert_same(cloud.points, cloud.num_points, k)  # the sort made in the call


@pytest.mark.cuda
def test_card_routing_takes_the_fused_epilogue(dev, hdl64):
    cloud, tree = hdl64[0]
    down, torch_n, fused_n = _counters(
        lambda: estimate_normals_covariances(cloud, tree, num_neighbors=10))
    assert (torch_n, fused_n) == (0, 1)
    want = _yardstick(cloud.points, cloud.num_points, 10, True, True,
                      target=tree.pruned_target())
    assert torch.equal(down.normals, want[0]) and torch.equal(down.covs, want[1])
    before = cov_fused_cuda.knn_moments_rows.launches
    (nrm, covs), torch_n, fused_n = _counters(lambda: _estimate_impl(
        cloud.points, cloud.num_points, 20, False, True))
    assert (torch_n, fused_n) == (0, 1) and nrm is None and covs.shape[1:] == (3, 3)
    assert cov_fused_cuda.knn_moments_rows.launches == before + 1
    # float64, k > 64 and the windowed lists keep the torch epilogue.
    part = cloud.points[:3000].contiguous()
    num = torch.tensor(3000, dtype=torch.int32, device=dev)
    for pts, k, mode in ((part.double(), 10, "exact"), (part, 65, "exact"),
                         (part, 10, "window")):
        _, torch_n, fused_n = _counters(lambda: _estimate_impl(
            pts, num, k, True, True, neighbor_mode=mode))
        assert (torch_n, fused_n) == (1, 0), (pts.dtype, k, mode)


@pytest.mark.cuda
def test_card_map_scale_layout_keeps_the_torch_epilogue(dev, hdl64, monkeypatch):
    cloud, tree = hdl64[0]
    monkeypatch.setattr(cov_fused_cuda, "TI_MIN_ROWS", 1000)
    _, torch_n, fused_n = _counters(lambda: estimate_covariances(cloud, tree,
                                                                 num_neighbors=10))
    assert (torch_n, fused_n) == (1, 0)


def _cloud(dev, xyz, cap, lead=0, num=None):
    pts = torch.as_tensor(_padded(np.asarray(xyz, np.float32), cap, lead), device=dev)
    return pts, torch.tensor(len(xyz) if num is None else num, dtype=torch.int32,
                             device=dev)


@pytest.mark.cuda
def test_padding_and_rows_of_few_neighbours(dev):
    rng = np.random.default_rng(11)
    xyz = rng.normal(size=(300, 3)) * [4.0, 2.0, 0.3] + [20.0, -5.0, 1.0]
    for k in (3, 4, 5, 10, 33):  # below 5 neighbours every row is invalid
        _assert_same(*_cloud(dev, xyz, 337), k)
    for m in (1, 4, 5, 6):  # fewer live rows than k
        _assert_same(*_cloud(dev, xyz[:m], 70), 10)
    _assert_same(*_cloud(dev, xyz, 300), 10)  # no padding row
    _assert_same(*_cloud(dev, xyz, 400, num=0), 10)  # no live row
    # Live rows between sentinel rows: rows at or past num_points are
    # invalid whatever their neighbours.
    _assert_same(*_cloud(dev, xyz, 330, lead=10, num=300), 10)


@pytest.mark.cuda
def test_near_isotropic_patches(dev):
    g = np.stack(np.meshgrid(*[np.arange(-1.0, 2.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    patches = [g, g * 0.1 + [1000.0, -700.0, 3.0], g * 0.25 + [40.0, 40.0, 40.0],
               np.concatenate([g, -g[::-1]]) * 0.5 + [-60.0, 10.0, 0.0]]
    # Clusters far apart: each query's 27 neighbours are its own cube.
    xyz = np.concatenate([p + [300.0 * i, 0.0, 0.0] for i, p in enumerate(patches)])
    _assert_same(*_cloud(dev, xyz, len(xyz) + 9), 27)
    _assert_same(*_cloud(dev, xyz, len(xyz) + 9), 10)
    for p in patches[:3]:
        _assert_same(*_cloud(dev, p, 30), 27)


@pytest.mark.cuda
def test_collinear_and_planar_patches(dev):
    rng = np.random.default_rng(12)
    t = np.sort(rng.uniform(-3.0, 3.0, 400))
    line = np.stack([t, 2.0 * t, -t], 1) + [50.0, 20.0, 1.5]
    exact_line = np.stack([np.arange(200.0) * 0.25, np.zeros(200), np.zeros(200)], 1)
    uv = rng.uniform(-5.0, 5.0, size=(600, 2))
    plane = np.stack([uv[:, 0], uv[:, 1], 0.3 * uv[:, 0] - 0.1 * uv[:, 1] + 2.0], 1)
    flat = np.concatenate([uv, np.zeros((600, 1))], 1)
    for xyz in (line, exact_line, plane, flat):
        for k in (10, 20):
            _assert_same(*_cloud(dev, xyz, len(xyz) + 40), k)
