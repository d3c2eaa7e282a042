"""Port parity of the 1-NN search kernel (K9) and of the Morton codes.

The plain PyTorch version of K9, both variants, runs on the CPU against
``nearest_neighbor_pallas`` in Pallas interpret mode on the five cases of
``tests/test_knn_pallas.py``: indices equal, d² to rtol 1e-4 / atol 1e-4
(that file's tolerance; the centre is a float32 sum taken in another order
by the two frameworks, and the score form recomputes d² uncentred).
``morton_codes32`` must be integer-equal to the JAX function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.knn_pallas import nearest_neighbor_pallas
from small_gicp_tpu.ops.knn_window import morton_codes32 as j_morton
from small_gicp_tpu_torch.ops.knn_cuda import (
    nearest_neighbor,
    nearest_neighbor_plain,
    target_centre,
)
from small_gicp_tpu_torch.ops.knn_window import morton_codes32


def _pad4(xyz, capacity):
    out = np.full((capacity, 4), 1e9, np.float32)
    out[:, 3] = 0.0
    out[:len(xyz), :3] = xyz
    out[:len(xyz), 3] = 1.0
    return out


def _case(name):
    """(target xyz, query xyz, target capacity, block_q, block_m)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name in ("1000x700", "513x513", "64x2000"):
        n, q = map(int, name.split("x"))
        tgt = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
        qry = rng.uniform(-50, 50, (q, 3)).astype(np.float32)
        return tgt, qry, (n + 255) // 256 * 256, 256, 512
    if name == "duplicates":
        base = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
        qry = base + rng.normal(scale=1e-4, size=base.shape).astype(np.float32)
        return np.concatenate([base, base]), qry, 256, 128, 256
    tgt = rng.uniform(995, 1005, (512, 3)).astype(np.float32)  # far from origin
    qry = tgt[:256] + rng.normal(scale=0.01, size=(256, 3)).astype(np.float32)
    return tgt, qry, 512, 128, 256


@pytest.mark.parametrize(
    "name", ["1000x700", "513x513", "64x2000", "duplicates", "far_from_origin"])
def test_plain_nn_matches_pallas_interpret(name):
    tgt, qry, cap, block_q, block_m = _case(name)
    t4, q4 = _pad4(tgt, cap), _pad4(qry, len(qry))
    num = torch.tensor(len(tgt), dtype=torch.int32)
    for variant in ("vpu", "mxu"):
        jd, ji = nearest_neighbor_pallas(
            jnp.asarray(t4), jnp.asarray(q4), block_q=block_q, block_m=block_m,
            interpret=True, variant=variant)
        d, i = nearest_neighbor_plain(torch.as_tensor(t4), num, torch.as_tensor(q4),
                                      variant)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji), err_msg=variant)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4,
                                   err_msg=variant)
        # On a CPU tensor the wrapper runs the plain version.
        dw, iw = nearest_neighbor(torch.as_tensor(t4), num, torch.as_tensor(q4)[:, :3],
                                  variant)
        assert torch.equal(iw, i) and torch.equal(dw, d)
    if name == "duplicates":
        np.testing.assert_array_equal(i.numpy(), np.arange(100))


def test_nn_edge_cases():
    rng = np.random.default_rng(4)
    tgt = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    t4 = torch.as_tensor(_pad4(tgt, 64))
    q = torch.as_tensor(tgt[:7] + 0.01)
    for variant in ("vpu", "mxu"):
        # num_points below the capacity: rows beyond it are never returned.
        d, i = nearest_neighbor_plain(t4, torch.tensor(20, dtype=torch.int32), q,
                                      variant)
        assert i.dtype == torch.int32 and int(i.max()) < 20
        ref = ((q[:, None, :] - t4[None, :20, :3]) ** 2).sum(-1).min(dim=1)
        assert torch.equal(i.long(), ref.indices)
        torch.testing.assert_close(d, ref.values, rtol=1e-4, atol=1e-5)
        # Empty target, and no query.
        d, i = nearest_neighbor_plain(t4, torch.tensor(0, dtype=torch.int32), q,
                                      variant)
        assert torch.all(d == 3e38) and torch.all(i == 0)
        d, i = nearest_neighbor_plain(t4[:0], torch.tensor(0, dtype=torch.int32), q,
                                      variant)
        assert torch.all(d == 3e38) and torch.all(i == 0)
        d, i = nearest_neighbor_plain(t4, torch.tensor(40, dtype=torch.int32), q[:0],
                                      variant)
        assert d.shape == (0,) and i.shape == (0,)
    with pytest.raises(ValueError, match="variant"):
        nearest_neighbor(t4, torch.tensor(40, dtype=torch.int32), q, "tensor")
    # The centre ignores padding rows.
    np.testing.assert_allclose(target_centre(t4).numpy(), tgt.mean(0), atol=1e-5)


@pytest.mark.parametrize("origin", ["default", "min_corner"])
def test_morton_codes32_match_jax(origin):
    rng = np.random.default_rng(8)
    pts = rng.uniform(-80, 80, (3000, 3)).astype(np.float32)
    pts[:5] = [[np.nan, 0, 0], [np.inf, 1, 1], [1e9, 1e9, 1e9], [-1e9, 0, 5e3],
               [0, 0, -np.inf]]
    pts[5:40] = rng.uniform(-2000, 2000, (35, 3))  # beyond the 1024 cells: clamped
    org = None if origin == "default" else pts[40:].min(0)
    for cell in (1.0, 0.25):
        want = np.asarray(j_morton(jnp.asarray(pts), cell,
                                   origin=None if org is None else jnp.asarray(org)))
        got = morton_codes32(torch.as_tensor(pts), cell,
                             origin=None if org is None else torch.as_tensor(org))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0]) == 2 ** 31 - 1 and int(got[2]) != 2 ** 31 - 1
