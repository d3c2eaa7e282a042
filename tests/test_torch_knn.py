"""Port parity of the kNN search kernels (K10, K11, K12).

The plain PyTorch versions run on the CPU against the Pallas kernels in
interpret mode, on the inputs of ``tests/test_knn_pallas.py``. Both sides
compute d² in difference form in float32 and break ties to the lower
index, so the indices are compared with ``array_equal``. The distances
are held to rtol 1e-6: XLA on the CPU contracts dx·dx + dy·dy + dz·dz into
fused multiply-adds, the port rounds every operation on its own, and the
two differ by an ulp or two (exactly equal on integer coordinates).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.knn_pallas import knn_pallas, knn_pallas_pruned, knn_pallas_T
from small_gicp_tpu_torch.ops.knn_cuda import (
    knn,
    knn_plain,
    knn_pruned,
    knn_pruned_plain,
    knn_T,
)


def _pad4(xyz, capacity):
    out = np.full((capacity, 4), 1e9, np.float32)
    out[:, 3] = 0.0
    out[:len(xyz), :3] = xyz
    out[:len(xyz), 3] = 1.0
    return out


def _num(n):
    return torch.tensor(n, dtype=torch.int32)


def _assert_same(got, want, what=""):
    (d, i), (jd, ji) = got, want
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji), err_msg=what)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=0,
                               err_msg=what)


@pytest.mark.parametrize("k", [2, 5, 20, 64])
def test_plain_knn_matches_pallas_interpret(k):
    rng = np.random.default_rng(k)
    tgt = rng.uniform(-50, 50, (700, 3)).astype(np.float32)
    qry = rng.uniform(-50, 50, (300, 3)).astype(np.float32)
    t4, q4 = _pad4(tgt, 768), _pad4(qry, 300)
    want = knn_pallas(jnp.asarray(t4), jnp.asarray(q4), k, block_q=128, block_m=256,
                      interpret=True)
    got = knn_plain(torch.as_tensor(t4), _num(700), torch.as_tensor(q4), k)
    _assert_same(got, want)
    assert got[1].dtype == torch.int32
    # The wrapper on a CPU tensor is the plain version.
    d, i = knn(torch.as_tensor(t4), _num(700), torch.as_tensor(q4)[:, :3], k)
    assert torch.equal(d, got[0]) and torch.equal(i, got[1])


def test_plain_knn_duplicates_tie_order():
    rng = np.random.default_rng(12)
    base = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    tgt = np.concatenate([base, base])  # duplicate at i and i + 64
    t4, q4 = _pad4(tgt, 128), _pad4(base, 64)
    want = knn_pallas(jnp.asarray(t4), jnp.asarray(q4), 2, block_q=64, block_m=64,
                      interpret=True)
    got = knn_plain(torch.as_tensor(t4), _num(128), torch.as_tensor(q4), 2)
    _assert_same(got, want)
    np.testing.assert_array_equal(got[1].numpy()[:, 0], np.arange(64))
    np.testing.assert_array_equal(got[1].numpy()[:, 1], np.arange(64) + 64)


@pytest.mark.parametrize("shape", [(3000, 2300, 20), (1000, 1000, 10)])
def test_plain_knn_T_matches_knn_and_pallas_T(shape):
    """The warp-per-query wrapper and the thread-per-query one share one
    plain version; it must equal ``knn_pallas_T`` bit for bit, tie-heavy
    integer grid included."""
    m, q, k = shape
    rng = np.random.default_rng(m)
    if m == 1000:
        tp = rng.integers(0, 8, (m, 3)).astype(np.float32)
        qp = tp[:q]
    else:
        tp = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
        qp = rng.uniform(-10, 10, (q, 3)).astype(np.float32)
    t4 = np.c_[tp, np.ones(m, np.float32)]
    want = knn_pallas_T(jnp.asarray(t4), jnp.asarray(qp), k, interpret=True)
    tt, tq = torch.as_tensor(t4), torch.as_tensor(qp)
    got = knn_T(tt, _num(m), tq, k)
    _assert_same(got, want)
    d, i = knn(tt, _num(m), tq, k)
    assert torch.equal(d, got[0]) and torch.equal(i, got[1])


def test_plain_pruned_matches_pallas_interpret_coherent():
    rng = np.random.default_rng(31)
    m, qn, k = 1500, 700, 10
    tp = rng.uniform(-20, 20, size=(m, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0] * 0.4) + 0.05 * rng.normal(size=m)
    qp = tp[rng.permutation(m)[:qn]] + rng.normal(scale=0.05, size=(qn, 3)).astype(
        np.float32)
    t4, q4 = np.c_[tp, np.ones(m, np.float32)], np.c_[qp, np.ones(qn, np.float32)]
    want = knn_pallas_pruned(jnp.asarray(t4), jnp.asarray(q4), k, interpret=True)
    got = knn_pruned_plain(torch.as_tensor(t4), _num(m), torch.as_tensor(q4), k)
    _assert_same(got, want)
    d, i = knn_plain(torch.as_tensor(t4), _num(m), torch.as_tensor(q4), k)
    assert torch.equal(d, got[0]) and torch.equal(i, got[1])


def test_plain_pruned_matches_pallas_interpret_duplicates_and_padding():
    rng = np.random.default_rng(32)
    base = rng.uniform(-3, 3, size=(40, 3)).astype(np.float32)
    tp = np.concatenate([base, base, base])  # every point three times
    t4 = _pad4(tp, 160)  # padded target
    q = base[:16] + 0.01
    q4 = np.c_[q, np.ones(16, np.float32)]
    want = knn_pallas_pruned(jnp.asarray(t4), jnp.asarray(q4), 6, interpret=True)
    got = knn_pruned(torch.as_tensor(t4), _num(120), torch.as_tensor(q4), 6)
    _assert_same(got, want)


def test_plain_pruned_equals_plain_knn_on_tie_heavy_grid():
    """Equidistant distinct rows: the pruned search orders ties by the
    original index, not by the position in its Morton-sorted frame."""
    rng = np.random.default_rng(33)
    tp = rng.integers(0, 8, (2000, 3)).astype(np.float32)
    t4 = torch.as_tensor(_pad4(tp, 2100))
    q = torch.as_tensor(tp[:900])
    for k in (2, 10, 20):
        d, i = knn_plain(t4, _num(2000), q, k)
        dp, ip = knn_pruned_plain(t4, _num(2000), q, k)
        assert torch.equal(i, ip) and torch.equal(d, dp), k
        # Exact ties are there, and they go to the lower index.
        tied = d[:, 1:] == d[:, :-1]
        assert bool(tied.any()) and bool((i[:, 1:] > i[:, :-1])[tied].all())
