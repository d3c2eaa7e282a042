"""Port parity of the covariance layouts: the plain versions of K4 (layout
"ti", neighbour indices + torch moment sums) and K5 (layout "q") against
``knn_moments_pallas`` in interpret mode, and the port's three layouts
against each other.

Inputs: 1,500 points of a wavy sheet from a seeded numpy generator, with 60
padding rows, as tests/test_normals.py makes them (coordinates are
continuous, so no two neighbours tie).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.cov_fused_pallas import knn_moments_pallas
from small_gicp_tpu_torch.ops.cov_fused_cuda import (
    knn_moments,
    knn_moments_rows,
    knn_topk_idx,
)

N, PAD = 1500, 60


@pytest.fixture(scope="module")
def sheet():
    rng = np.random.default_rng(21)
    xy = rng.uniform(-20, 20, size=(N, 2))
    z = 0.4 * np.sin(0.2 * xy[:, 0]) + 0.02 * rng.normal(size=N)
    pts = np.c_[xy[:, 0], xy[:, 1], z, np.ones(N)].astype(np.float32)
    pts = np.concatenate([pts, np.full((PAD, 4), 1e9, np.float32)])
    pts[N:, 3] = 0.0
    return pts


def _port(sheet, k, layout):
    return knn_moments(torch.as_tensor(sheet), torch.tensor(N, dtype=torch.int32), k,
                       layout=layout)


def _check_against_pallas(sheet, k, layout):
    jm1, jm2, jc = knn_moments_pallas(jnp.asarray(sheet), jnp.asarray(N, jnp.int32), k,
                                      interpret=True, layout=layout)
    m1, m2, c = _port(sheet, k, layout)
    # The same exact-kNN membership, so counts agree exactly and the float32
    # moment sums to their rounding (the bounds of tests/test_normals.py).
    np.testing.assert_array_equal(c.numpy()[:N], np.asarray(jc)[:N])
    np.testing.assert_allclose(m1.numpy()[:N], np.asarray(jm1)[:N], atol=1e-4)
    np.testing.assert_allclose(m2.numpy()[:N], np.asarray(jm2)[:N], atol=1e-3)
    assert torch.all(c[N:] == 0) and torch.all(m1[N:] == 0) and torch.all(m2[N:] == 0)


@pytest.mark.parametrize("k", [1, 10, 20, 64])
def test_topk_idx_plain_matches_pallas_ti(sheet, k):
    _check_against_pallas(sheet, k, "ti")


@pytest.mark.parametrize("k", [1, 10, 20, 64])
def test_moments_q_plain_matches_pallas_q(sheet, k):
    _check_against_pallas(sheet, k, "q")


def test_topk_idx_neighbour_sets_match_brute_force(sheet):
    pts = torch.as_tensor(sheet)
    d, i = knn_topk_idx(pts, torch.tensor(N, dtype=torch.int32), 10)
    assert d.shape == (N + PAD, 10) and i.dtype == torch.int32
    xyz = sheet[:N, :3].astype(np.float64)
    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    want = np.argsort(d2, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(np.sort(i.numpy()[:N], axis=1), np.sort(want, axis=1))
    assert torch.all(i[:N, 0] == torch.arange(N))  # each row finds itself first
    assert torch.all(d[:N, 1:] >= d[:N, :-1])
    # padding rows: empty lists
    assert torch.all(d[N:] == 3.0e38) and torch.all(i[N:] == 0)


def test_three_layouts_choose_the_same_neighbours(sheet):
    pts, num = torch.as_tensor(sheet), torch.tensor(N, dtype=torch.int32)
    for k in (1, 10, 20):
        t1, t2, tc = _port(sheet, k, "t")
        i1, i2, ic = _port(sheet, k, "ti")
        q1, q2, qc = _port(sheet, k, "q")
        assert torch.equal(tc, ic) and torch.equal(tc, qc)
        # "q" forms K3's rows; "ti" sums the same offsets in another order.
        assert torch.equal(t1, q1) and torch.equal(t2, q2)
        torch.testing.assert_close(i1, t1, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(i2, t2, rtol=1e-5, atol=1e-4)
        d, _ = knn_topk_idx(pts, num, k)
        rows = knn_moments_rows(pts, num, k)
        assert torch.equal(d[:N, k - 1], rows[:N, 10])  # the same kth distance
