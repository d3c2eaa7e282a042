"""The merge rules of the split K9 and K10 (``csrc/knn.cu``), on the CPU.

The kernels cut the target rows into chunks (``split_plan``,
``split_chunk``) and merge the chunks' results in the launch: K9 by the
smallest orderable 64-bit key (rank bits above the row), K10 by merging
the chunks' (d², row) lists, each cut by a sampled kth bound.
``nearest_neighbor_split_plain`` and ``knn_split_plain`` are the plain
account of that; for every plan — one chunk, many, chunks with no valid
row, chunks smaller than k — they must equal ``nearest_neighbor_plain`` and
``knn_plain`` bit for bit, on duplicate-heavy grids and padding rows, with
negative score-form ranks. Against the Pallas kernels in interpret mode:
indices equal, d² to rtol 1e-6 (XLA on the CPU contracts the distance into
fused multiply-adds; the port rounds every operation), only slots with
d² < 1e16 (the JAX kernels' empty slots hold sentinel rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.ops.knn_pallas import knn_pallas, nearest_neighbor_pallas
from small_gicp_tpu_torch.ops import knn_cuda
from small_gicp_tpu_torch.ops.knn_cuda import (
    KNN_BLOCK_QUERIES,
    NN1_BLOCK_QUERIES,
    SPLIT_TILE,
    _from_orderable,
    _orderable,
    knn_least_rows,
    knn_plain,
    knn_split_plain,
    nearest_neighbor_plain,
    nearest_neighbor_split_plain,
    split_chunk,
    split_plan,
    target_centre,
)


def _pad4(xyz, capacity):
    out = np.full((capacity, 4), 1e9, np.float32)
    out[:, 3] = 0.0
    out[:len(xyz), :3] = xyz
    out[:len(xyz), 3] = 1.0
    return out


def _cloud(kind):
    """(target [cap,4], num_points, queries [Q,3]): ``grid`` — 1,500 points
    on a 6³ integer grid (every distance ties many times), 1,400 of them
    valid in a 1,700-row table, queried off and on the grid; ``scan`` — a
    coherent sheet of 2,000 points in a 2,100-row table with 300 jittered
    queries; ``tiny`` — 3 valid rows."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "grid":
        tp = rng.integers(0, 6, (1500, 3)).astype(np.float32)
        qp = np.concatenate([tp[:100], rng.uniform(-1, 7, (200, 3))]).astype(np.float32)
        return torch.as_tensor(_pad4(tp, 1700)), 1400, torch.as_tensor(qp)
    tp = rng.uniform(-20, 20, (2000, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0] * 0.4) + 0.05 * rng.normal(size=2000)
    qp = (tp[rng.permutation(2000)[:300]]
          + rng.normal(scale=0.05, size=(300, 3))).astype(np.float32)
    n = 3 if kind == "tiny" else 2000
    return torch.as_tensor(_pad4(tp[:n], 2100)), n, torch.as_tensor(qp)


def test_split_plan_fills_the_card_and_covers_the_capacity():
    sms = 132
    for nq, mcap, block in ((1, 21366, KNN_BLOCK_QUERIES), (64, 21366, KNN_BLOCK_QUERIES),
                            (4096, 21366, NN1_BLOCK_QUERIES),
                            (21366, 108043, KNN_BLOCK_QUERIES), (108043, 108043, 128),
                            (5, 0, NN1_BLOCK_QUERIES)):
        nsplit = split_plan(nq, mcap, block, sms)
        qblocks = -(-nq // block)
        assert 1 <= nsplit <= max(1, -(-mcap // SPLIT_TILE)), (nq, mcap)
        # Enough blocks, unless the chunks are down to one ring stage.
        assert (qblocks * nsplit >= knn_cuda.SPLIT_BLOCKS_PER_SM * sms
                or nsplit == max(1, -(-mcap // SPLIT_TILE))), (nq, mcap)
        # No more chunks than it takes.
        assert nsplit == 1 or qblocks * (nsplit - 1) < knn_cuda.SPLIT_BLOCKS_PER_SM * sms
    # The queries alone fill the card: one chunk.
    assert split_plan(10 ** 6, 108043, KNN_BLOCK_QUERIES, sms) == 1


@pytest.mark.parametrize("m", [0, 1, 255, 256, 1400, 21366])
def test_split_chunk_cuts_the_valid_rows(m):
    for nsplit in (1, 2, 7, 84, 423):
        chunk = split_chunk(m, nsplit)
        assert chunk % SPLIT_TILE == 0 and chunk * nsplit >= m
        assert chunk == SPLIT_TILE or (chunk - SPLIT_TILE) * nsplit < m
        least = split_chunk(m, nsplit, least=4 * SPLIT_TILE)
        assert least == max(chunk, 4 * SPLIT_TILE)


def test_knn_least_rows_only_where_the_queries_fill_the_card():
    sms, k = 132, 20
    few = (knn_cuda.FILLED_BLOCKS_PER_SM * sms - 1) * KNN_BLOCK_QUERIES
    assert knn_least_rows(1, k, sms) == SPLIT_TILE
    assert knn_least_rows(few, k, sms) == SPLIT_TILE
    many = knn_least_rows(few + 1, k, sms)
    assert many % SPLIT_TILE == 0 and many >= k * knn_cuda.KNN_ROWS_PER_K


def test_orderable_keys_sort_as_the_floats():
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.normal(size=500) * 10.0 ** rng.integers(-30, 30, 500),
                        [0.0, 1e-45, -1e-45, 3e38, -3e38]]).astype(np.float32)
    t = torch.as_tensor(v)
    o = _orderable(t)
    assert bool(((o >= 0) & (o < 2 ** 32)).all())
    assert torch.equal(_from_orderable(o), t)
    order = torch.argsort(o, stable=True)
    assert torch.equal(t[order], torch.sort(t, stable=True).values)
    # -0 maps below +0; the kernel and the plain account add +0 first.
    z = torch.tensor([-0.0, 0.0])
    assert int(_orderable(z)[0]) < int(_orderable(z)[1])
    assert int(_orderable(z + 0.0)[0]) == int(_orderable(z + 0.0)[1])


# (chunks, tile): one chunk; two; many; chunks of 4 rows (k above a chunk's
# rows); more chunks than valid rows (most chunks empty).
PLANS = [(1, SPLIT_TILE), (2, SPLIT_TILE), (7, SPLIT_TILE), (60, 4), (2500, 1)]


@pytest.mark.parametrize("kind", ["grid", "scan", "tiny"])
@pytest.mark.parametrize("nsplit,tile", PLANS)
def test_knn_split_merge_equals_knn_plain(kind, nsplit, tile):
    tgt, n, q = _cloud(kind)
    num = torch.tensor(n, dtype=torch.int32)
    for k in (1, 5, 20, 64):
        want = knn_plain(tgt, num, q, k)
        for shared, least in ((False, None), (True, None), (True, 8 * tile)):
            got = knn_split_plain(tgt, num, q, k, nsplit, tile, shared, least)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (
                kind, nsplit, k, shared, least)
        if kind == "tiny":
            assert torch.all(want[0][:, 3:] == 3e38) and torch.all(want[1][:, 3:] == 0)


def test_knn_split_bound_cuts_the_chunk_lists():
    """The sampled bound leaves each chunk's list short of k where the
    chunk lies far from the query, and the merge is still exact."""
    tgt, n, q = _cloud("scan")
    num = torch.tensor(n, dtype=torch.int32)
    m, k = n, 10
    chunk = split_chunk(m, 4)
    d2 = knn_cuda._masked_sq_dists(q, tgt[:chunk, :3], torch.ones(chunk, dtype=torch.bool))
    bound = knn_cuda._sampled_bound(d2, k)
    assert bool((bound < 3e38).all())
    assert float((d2 <= bound[:, None]).sum(1).float().mean()) < chunk / 4
    want = knn_plain(tgt, num, q, k)
    got = knn_split_plain(tgt, num, q, k, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["grid", "scan", "tiny"])
@pytest.mark.parametrize("nsplit,tile", PLANS)
def test_nn1_split_keys_equal_nearest_neighbor_plain(kind, nsplit, tile):
    tgt, n, q = _cloud(kind)
    num = torch.tensor(n, dtype=torch.int32)
    for variant in ("vpu", "mxu"):
        want = nearest_neighbor_plain(tgt, num, q, variant)
        got = nearest_neighbor_split_plain(tgt, num, q, variant, nsplit, tile=tile)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (
            kind, nsplit, variant)


def test_nn1_split_ranks_negative_score_form():
    """The centred score |t|² − 2 q·t is negative wherever q lies nearer a
    row than the centre: the keys must order those ranks too."""
    tgt, n, q = _cloud("scan")
    num = torch.tensor(n, dtype=torch.int32)
    c = target_centre(tgt)
    tc, qc = tgt[:n, :3] - c, q - c
    score = (tc * tc).sum(1)[None, :] - 2.0 * (qc @ tc.T)
    assert float((score.amin(1) < 0).float().mean()) > 0.9
    want = nearest_neighbor_plain(tgt, num, q, "mxu")
    for nsplit in (3, 40):
        got = nearest_neighbor_split_plain(tgt, num, q, "mxu", nsplit, tile=8)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["grid", "scan"])
def test_split_plain_matches_pallas_interpret(kind):
    tgt, n, q = _cloud(kind)
    num = torch.tensor(n, dtype=torch.int32)
    # The Pallas kernels take the valid rows (and their own padding).
    t4 = jnp.asarray(_pad4(tgt[:n, :3].numpy(), -(-n // 256) * 256))
    q4 = jnp.asarray(_pad4(q.numpy(), len(q)))
    # On the integer grid every d² is exact in both frameworks, so the many
    # ties go to the lower row in both.
    for k in (1, 10):
        jd, ji = knn_pallas(t4, q4, k, block_q=128, block_m=256, interpret=True)
        d, i = knn_split_plain(tgt, num, q, k, 5, tile=64)
        ok = d < 1e16
        np.testing.assert_array_equal(i.numpy()[ok.numpy()], np.asarray(ji)[ok.numpy()])
        np.testing.assert_allclose(d.numpy()[ok.numpy()], np.asarray(jd)[ok.numpy()],
                                   rtol=1e-6)
    if kind == "grid":  # K9 centres the grid: the ties round apart
        return
    for variant in ("vpu", "mxu"):
        jd, ji = nearest_neighbor_pallas(t4, q4, block_q=128, block_m=256,
                                         interpret=True, variant=variant)
        d, i = nearest_neighbor_split_plain(tgt, num, q, variant, 5, tile=64)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        # The centre is a float32 sum taken in another order by the two
        # frameworks (tests/test_torch_knn_kernels.py's tolerance).
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
