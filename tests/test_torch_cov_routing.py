"""Routing of the port's ``knn_moments``: the automatic layout by cloud
size, the errors of ``knn_moments_pallas``, small clouds and padding, and
``estimate_covariances`` through the map-scale layout against the JAX
estimator. Inputs come from seeded numpy generators.
"""

import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.normals import estimate_covariances as j_estimate_covariances
from small_gicp_tpu.point_cloud import PointCloud as JCloud
from small_gicp_tpu_torch.interop import cloud_from_numpy
from small_gicp_tpu_torch.ops import cov_fused_cuda, normals
from small_gicp_tpu_torch.ops.cov_fused_cuda import (
    auto_layout,
    knn_moments,
    knn_moments_rows,
    knn_topk_idx,
)
from small_gicp_tpu_torch.ops.normals import estimate_covariances
from small_gicp_tpu_torch.utils.synthetic import generate_sequence


def _cloud(n, pad, seed=5):
    rng = np.random.default_rng(seed)
    pts = np.full((n + pad, 4), 1e9, np.float32)
    pts[:, 3] = 0.0
    pts[:n, :3] = rng.uniform(-5, 5, size=(n, 3))
    pts[:n, 3] = 1.0
    return pts


def test_auto_layout_follows_the_jax_thresholds():
    assert cov_fused_cuda.TI_MIN_ROWS == 262_144
    assert cov_fused_cuda.MAX_ROWS == 1_048_576
    assert auto_layout(262_144) == "t" and auto_layout(262_145) == "ti"


def test_auto_layout_takes_the_index_kernel_above_the_threshold(monkeypatch):
    pts = torch.as_tensor(_cloud(400, 20))
    num = torch.tensor(400, dtype=torch.int32)
    calls = []
    real = cov_fused_cuda.knn_topk_idx
    monkeypatch.setattr(cov_fused_cuda, "knn_topk_idx",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    small = knn_moments(pts, num, 10)
    assert not calls  # 420 rows: layout "t"
    monkeypatch.setattr(cov_fused_cuda, "TI_MIN_ROWS", 100)
    large = knn_moments(pts, num, 10)
    assert calls == [1]
    assert torch.equal(small[2], large[2])
    torch.testing.assert_close(small[0], large[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(small[1], large[1], rtol=1e-5, atol=1e-4)


def test_errors_match_the_jax_entry():
    pts = torch.as_tensor(_cloud(50, 4))
    num = torch.tensor(50, dtype=torch.int32)
    for layout in (None, "t", "ti", "q"):
        with pytest.raises(ValueError, match="k<=64"):
            knn_moments(pts, num, 65, layout=layout)
    with pytest.raises(ValueError, match="unknown layout"):
        knn_moments(pts, num, 10, layout="x")
    with pytest.raises(ValueError, match="layout"):
        knn_moments_rows(pts, num, 10, layout="ti")
    big = torch.zeros((1_048_577, 4))
    for layout in (None, "t", "ti", "q"):
        with pytest.raises(ValueError, match="1048576"):
            knn_moments(big, num, 10, layout=layout)
    with pytest.raises(ValueError, match="1048576"):  # as the JAX estimator does
        normals._estimate_impl(big, num, 10, False, True, neighbor_mode="fused")


@pytest.mark.parametrize("layout", ["ti", "q"])
def test_fewer_valid_rows_than_k(layout):
    pts = np.zeros((8, 4), np.float32)
    pts[:3, :3] = [[0, 0, 0], [1, 0, 0], [0, 2, 0]]
    pts[:3, 3] = 1.0
    pts[3:, :3] = 1e9
    P, num = torch.as_tensor(pts), torch.tensor(3, dtype=torch.int32)
    m1, m2, c = knn_moments(P, num, 5, layout=layout)
    assert c.tolist() == [3, 3, 3, 0, 0, 0, 0, 0]
    np.testing.assert_allclose(m1[0].numpy(), [1, 2, 0])
    np.testing.assert_allclose(torch.diagonal(m2[0]).numpy(), [1, 4, 0])
    assert torch.all(m1[3:] == 0) and torch.all(m2[3:] == 0)
    if layout == "ti":
        d, i = knn_topk_idx(P, num, 5)
        assert torch.all(d[:3, 3:] == 3.0e38) and torch.all(i[:3, 3:] == 0)
        assert torch.all(d[3:] == 3.0e38)
    # no valid row at all
    m1, m2, c = knn_moments(P, torch.tensor(0, dtype=torch.int32), 5, layout=layout)
    assert not c.any() and not m1.any() and not m2.any()


def test_estimate_covariances_through_the_map_scale_layout(monkeypatch):
    scans, _ = generate_sequence(n_frames=1, rings=16, azimuth_steps=256)
    frame = scans[0][:2500]
    jc = j_estimate_covariances(JCloud.from_points(frame), num_neighbors=10)
    monkeypatch.setattr(cov_fused_cuda, "TI_MIN_ROWS", 1000)
    calls = []
    real = cov_fused_cuda.knn_topk_idx
    monkeypatch.setattr(cov_fused_cuda, "knn_topk_idx",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tc = estimate_covariances(cloud_from_numpy(np.asarray(jc.points), len(frame),
                                               device="cpu"), num_neighbors=10)
    assert calls == [1]
    # The same neighbours; the regularised covariances agree to 1e-3 except
    # where two eigenvalues of a neighbourhood nearly tie.
    diff = np.abs(tc.covs.numpy() - np.asarray(jc.covs)).max(axis=(1, 2))
    assert (diff <= 1e-3).mean() >= 0.99
    assert np.median(diff) <= 1e-5
