"""The port's voxel maps (``small_gicp_tpu_torch/models/voxelmap.py``) and
voxel-key helpers against the JAX package on the CPU.

The same numpy-seeded streams go into both packages' ``GaussianVoxelMap``
and ``IncrementalVoxelMap``: a sensor moving along x, dense patches (the
0.1 m dedup and the cell cap), repeated points, an empty insert, a short
LRU horizon (eviction and slot reuse) and too few slots for some inserts
(overflow). Tolerances:
  * keys, slots, occupancy, stamps, counters and the directory's live
    entries equal (the JAX directory sort leaves the order of free entries
    open, so those are not compared);
  * payload rows of live slots within rtol 1e-6 and atol 1e-6 (float32
    means of ~10 m coordinates: 1-2 ulp; both packages round the float64
    run sums once);
  * NN and kNN indices, found flags equal; d² within rtol 1e-6 (XLA on the
    CPU may contract the sums into FMAs, the port does not);
  * ``_fine_hash``, ``unpack_key``, ``neighbor_offsets``, ``segment_ids``
    bit for bit; ``transform_covs`` within rtol 1e-6.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from small_gicp_tpu.models import voxelmap as jv
from small_gicp_tpu.ops import voxel_keys as jk
from small_gicp_tpu.point_cloud import PointCloud as JCloud, transform_covs as j_tcovs
from small_gicp_tpu_torch.models import voxelmap as tv
from small_gicp_tpu_torch.ops import voxel_keys as tk
from small_gicp_tpu_torch.point_cloud import PointCloud as TCloud, transform_covs as t_tcovs

CPU = "cpu"


def _frame(rng, i, n, dtype=np.float32, dense=True):
    """A sensor frame of ``n`` points at x ≈ 3·i: a ground sheet, a wall and
    (``dense``) a patch of near-duplicates; covariances symmetric
    positive."""
    x0 = 3.0 * i
    p = np.empty((n, 3))
    a = n // 2
    p[:a] = np.c_[rng.uniform(x0 - 6, x0 + 6, a), rng.uniform(-6, 6, a),
                  rng.normal(-1.5, 0.03, a)]
    b = n - a
    p[a:] = np.c_[rng.uniform(x0 - 6, x0 + 6, b), np.full(b, 4.0) + rng.normal(0, 0.03, b),
                  rng.uniform(-1.5, 2.0, b)]
    if dense:
        p[:60] = np.array([x0 + 0.35, 0.45, -1.4]) + rng.normal(0, 0.02, (60, 3))
    c = rng.normal(size=(n, 3, 3)) * 0.05
    c = c @ c.transpose(0, 2, 1) + 1e-3 * np.eye(3)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return p.astype(dtype), c.astype(dtype), nrm.astype(dtype)


def _clouds(p, c, nrm, cap):
    """The same padded cloud for both packages."""
    n = len(p)
    dt = p.dtype
    P = np.full((cap, 4), 1e9, dt)
    P[:, 3] = 0.0
    P[:n, :3], P[:n, 3] = p, 1.0
    C = np.zeros((cap, 3, 3), dt)
    C[:n] = c
    N = np.zeros((cap, 4), dt)
    N[:n, :3] = nrm
    j = JCloud(points=jnp.asarray(P), num_points=jnp.asarray(n, jnp.int32),
               normals=jnp.asarray(N), covs=jnp.asarray(C))
    t = TCloud(points=torch.as_tensor(P), num_points=torch.tensor(n, dtype=torch.int32),
               normals=torch.as_tensor(N), covs=torch.as_tensor(C))
    return j, t


def _stream(dtype=np.float32, frames=12, seed=3):
    """Frames of 300-1,500 points; frame 5 is empty (num_points 0) and
    frame 9 repeats frame 8's points."""
    rng = np.random.default_rng(seed)
    out, prev = [], None
    for i in range(frames):
        n = 0 if i == 5 else int(rng.integers(300, 1500))
        p, c, nrm = _frame(rng, min(i, 8), max(n, 100), dtype)
        if i == 9:
            p, c, nrm = prev
        if n == 0:
            p, c, nrm = p[:0], c[:0], nrm[:0]
        out.append(_clouds(p, c, nrm, 1600))
        prev = (p, c, nrm)
    return out


def _eq(a, b, what):
    a, b = np.asarray(a), b.cpu().numpy()
    assert a.shape == b.shape and np.array_equal(a, b), what


def _check_common(j, t, live_slots):
    """Slot tables, counters and the live directory entries equal."""
    _eq(j.vox_keys, t.vox_keys, "vox_keys")
    for name in ("num_voxels", "lru_counter"):
        _eq(getattr(j, name), getattr(t, name), name)
    nv = int(j.num_voxels)
    _eq(j.dir_keys[:nv], t.dir_keys[:nv], "directory keys")
    _eq(j.dir_vals[:nv], t.dir_vals[:nv], "directory values")
    assert bool((t.dir_keys[nv:] == tk.INVALID_KEY).all())
    assert t.leaf_size.dtype == t.payload.dtype
    return live_slots


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gaussian_inserts_match_jax(dtype):
    """An LRU horizon of 3 on every 2nd insert evicts the frames left
    behind; 256 slots overflow on the larger frames; the empty insert leaves
    the map as it was, clock included."""
    kw = dict(lru_horizon=3, lru_clear_cycle=2)
    jm = jv.GaussianVoxelMap.empty(1.0, 256, jnp.dtype(dtype), **kw)
    tm = tv.GaussianVoxelMap.empty(1.0, 256, getattr(torch, np.dtype(dtype).name),
                                   **kw, device=CPU)
    seen_kill = seen_full = False
    prev_keys = None
    for i, (jc, tc) in enumerate(_stream(dtype)):
        before = tm
        jm, tm = jm.insert(jc), tm.insert(tc)
        live = np.array(jm.valid_mask())
        _check_common(jm, tm, live)
        _eq(jm.lru[live], tm.lru[torch.as_tensor(live)], "stamps")
        np.testing.assert_allclose(tm.payload.numpy()[live], np.asarray(jm.payload)[live],
                                   rtol=1e-6, atol=1e-6)
        if i == 5:  # empty insert: nothing changes
            assert torch.equal(tm.payload, before.payload)
            assert int(tm.lru_counter) == int(before.lru_counter)
        keys = set(np.asarray(jm.vox_keys)[live].tolist())
        if prev_keys is not None and prev_keys - keys and i % 2 == 1:
            seen_kill = True
        seen_full |= int(jm.num_voxels) == jm.capacity
        prev_keys = keys
        # The old map is untouched by the insert.
        assert before.payload is not tm.payload
    assert seen_kill and seen_full
    # Views, accessors and the cloud view.
    assert len(tm) == int(jm.num_voxels) and int(tm.size()) == int(jm.size())
    np.testing.assert_allclose(tm.voxel_points(), jm.voxel_points(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.voxel_covs(), jm.voxel_covs(), rtol=1e-6, atol=1e-6)
    assert torch.equal(tm.counts, tm.payload[:, 13])
    jc, tc = jv.voxelmap_as_cloud(jm), tv.voxelmap_as_cloud(tm)
    _eq(jc.num_points, tc.num_points, "as_cloud num_points")
    np.testing.assert_allclose(tc.points.numpy(), np.asarray(jc.points), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tc.covs.numpy(), np.asarray(jc.covs), rtol=1e-6, atol=1e-6)
    assert tc.normals is None


def test_gaussian_build_and_transform_match_jax():
    """``build`` (capacity from the cloud) and ``insert`` with T, float64."""
    rng = np.random.default_rng(8)
    p, c, nrm = _frame(rng, 0, 1400, np.float64)
    jc, tc = _clouds(p, c, nrm, 1500)
    jm, tm = jv.GaussianVoxelMap.build(jc, 0.5), tv.GaussianVoxelMap.build(tc, 0.5)
    assert tm.capacity == jm.capacity == 1504 and tm.payload.device.type == "cpu"
    th = np.r_[0.1, -0.05, 0.3]
    c3, s3 = np.cos(th), np.sin(th)
    R = (np.array([[1, 0, 0], [0, c3[0], -s3[0]], [0, s3[0], c3[0]]])
         @ np.array([[c3[1], 0, s3[1]], [0, 1, 0], [-s3[1], 0, c3[1]]])
         @ np.array([[c3[2], -s3[2], 0], [s3[2], c3[2], 0], [0, 0, 1]]))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, [0.7, -1.3, 0.2]
    jm, tm = jm.insert(jc, jnp.asarray(T)), tm.insert(tc, torch.as_tensor(T))
    live = np.array(jm.valid_mask())
    _check_common(jm, tm, live)
    np.testing.assert_allclose(tm.payload.numpy()[live], np.asarray(jm.payload)[live],
                               rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="covariances"):
        tv.GaussianVoxelMap.build(tc.replace(covs=None), 1.0)


def _ivm_pair(kind, dtype=np.float32, **kw):
    make = {"plain": "IncrementalVoxelMap", "normal": "IncrementalVoxelMapNormal",
            "cov": "IncrementalVoxelMapCov", "normal_cov": "IncrementalVoxelMapNormalCov"}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, np.dtype(dtype).name)
    if kind == "plain":
        return (jv.IncrementalVoxelMap.empty(1.0, 512, jdt, **kw),
                tv.IncrementalVoxelMap.empty(1.0, 512, tdt, **kw, device=CPU))
    return (getattr(jv, make[kind])(1.0, 512, dtype=jdt, **kw),
            getattr(tv, make[kind])(1.0, 512, dtype=tdt, **kw, device=CPU))


@pytest.mark.parametrize("kind", ["plain", "normal", "cov", "normal_cov"])
def test_incremental_inserts_match_jax(kind):
    """Cell cap 4 (dense patches exceed it), the 0.1 m dedup against stored
    points and within each insert, LRU 3/2, 256 slots (overflow), the
    repeated frame (every point a duplicate), the empty insert."""
    jm, tm = _ivm_pair(kind, cell_capacity=4, lru_horizon=3, lru_clear_cycle=2,
                       voxel_capacity=256)
    T = None
    seen = dict(cap=False, full=False, dedup=False)
    for i, (jc, tc) in enumerate(_stream()):
        stored = int(tm.num_points_stored)
        jm, tm = jm.insert(jc, T), tm.insert(tc, T)
        live_slots = np.array(jm.vox_keys) != jk.INVALID_KEY
        _check_common(jm, tm, live_slots)
        _eq(jm.occ, tm.occ, "occupancy")
        _eq(jm.num_points_stored, tm.num_points_stored, "num_points_stored")
        _eq(jm.stamps[live_slots], tm.stamps[torch.as_tensor(live_slots)], "stamps")
        live = np.asarray(jm.valid_points_mask())
        assert np.array_equal(live, tm.valid_points_mask().numpy())
        np.testing.assert_allclose(tm.payload.numpy()[live], np.asarray(jm.payload)[live],
                                   rtol=1e-6, atol=1e-6)
        _eq(jm.point_keys, tm.point_keys, "point_keys")
        seen["cap"] |= bool((tm.occ == 4).any())
        seen["full"] |= int(tm.num_voxels) == tm.voxel_capacity
        if i == 9:  # the repeated frame adds nothing where its voxels survive
            seen["dedup"] = int(tm.num_points_stored) - stored < int(tc.num_points) // 4
    assert all(seen.values()), seen
    assert tm.capacity == 256 * 4 and tm.voxel_capacity == 256
    assert len(tm) == int(jm.num_voxels) and int(tm.num_points()) == int(jm.num_points())
    for acc in ("voxel_points", "voxel_normals", "voxel_covs"):
        a, b = getattr(jm, acc)(), getattr(tm, acc)()
        assert (a is None) == (b is None), acc
        if a is not None:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    jc, tc = jv.ivm_as_cloud(jm), tv.ivm_as_cloud(tm)
    _eq(jc.num_points, tc.num_points, "as_cloud num_points")
    for f in ("points", "normals", "covs"):
        a, b = getattr(jc, f), getattr(tc, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


def test_incremental_insert_with_transform_float64():
    rng = np.random.default_rng(12)
    jm, tm = _ivm_pair("normal_cov", np.float64, cell_capacity=6)
    T = np.eye(4)
    T[:3, :3] = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    T[:3, 3] = [2.5, -0.5, 0.1]
    for i in range(3):
        p, c, nrm = _frame(rng, i, 900, np.float64)
        jc, tc = _clouds(p, c, nrm, 1000)
        jm, tm = jm.insert(jc, jnp.asarray(T)), tm.insert(tc, torch.as_tensor(T))
    live = np.asarray(jm.valid_points_mask())
    _eq(jm.vox_keys, tm.vox_keys, "vox_keys")
    _eq(jm.occ, tm.occ, "occupancy")
    np.testing.assert_allclose(tm.payload.numpy()[live], np.asarray(jm.payload)[live],
                               rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def filled():
    """Both packages' maps after a 6-frame stream (Gaussian 512 slots,
    incremental 512 × 10 with covariances), and 300 queries near and away
    from the points."""
    jg = jv.GaussianVoxelMap.empty(1.0, 512)
    tg = tv.GaussianVoxelMap.empty(1.0, 512, device=CPU)
    ji, ti = _ivm_pair("cov")
    for jc, tc in _stream(frames=6, seed=5):
        jg, tg = jg.insert(jc), tg.insert(tc)
        ji, ti = ji.insert(jc), ti.insert(tc)
    rng = np.random.default_rng(6)
    p, _, _ = _frame(rng, 2, 300, np.float32, dense=False)
    q = (p + rng.normal(0, 0.4, p.shape)).astype(np.float32)
    q[-20:] = rng.uniform(100, 120, (20, 3))  # nothing near
    return jg, tg, ji, ti, q


@pytest.mark.parametrize("offsets", [1, 7, 27])
def test_gaussian_nearest_neighbor_matches_jax(filled, offsets):
    jg, tg, _, _, q = filled
    a = jg.set_search_offsets(offsets).nearest_neighbor_search(jnp.asarray(q))
    b = tg.set_search_offsets(offsets).nearest_neighbor_search(torch.as_tensor(q))
    _eq(a[2], b[2], "found")
    found = np.asarray(a[2])
    assert found[:-20].mean() > 0.5 and not found[-20:].any()
    _eq(np.asarray(a[1])[found], b[1][torch.as_tensor(found)], "voxel slots")
    assert b[1].dtype == torch.int32
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=1e-6)


@pytest.mark.parametrize("offsets", [1, 7, 27])
@pytest.mark.parametrize("k", [1, 5, 300])
def test_incremental_knn_matches_jax(filled, offsets, k):
    """k = 300 lies above K·C at every offset count: the slots past the
    candidates hold 1e18 and row 0 in both."""
    _, _, ji, ti, q = filled
    jm, tm = ji.set_search_offsets(offsets), ti.set_search_offsets(offsets)
    a, b = jm.knn_search(jnp.asarray(q), k), tm.knn_search(torch.as_tensor(q), k)
    _eq(a[2], b[2], "found")
    _eq(a[1], b[1], "rows")
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=1e-6)
    if k == 1:
        a, b = jm.nearest_neighbor_search(jnp.asarray(q)), tm.nearest_neighbor_search(
            torch.as_tensor(q))
        _eq(a[1], b[1], "1-NN rows")
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=1e-6)


def test_fine_hash_is_bit_equal():
    rng = np.random.default_rng(2)
    xyz = np.concatenate([rng.uniform(-300, 300, (500, 3)),
                          rng.normal(0, 0.05, (100, 3))]).astype(np.float32)
    keys = tk.voxel_keys(torch.as_tensor(xyz), 1.0)
    for leaf in (0.1, 0.05, 0.3):
        fl = np.sqrt(np.float32(leaf * leaf)).astype(np.float32)
        a = jv._fine_hash(jnp.asarray(xyz), jnp.asarray(fl), jnp.asarray(keys.numpy()))
        b = tv._fine_hash(torch.as_tensor(xyz), torch.tensor(fl), keys)
        _eq(a, b, f"fine hash at {leaf}")


def test_voxel_key_helpers_match_jax():
    rng = np.random.default_rng(4)
    coords = rng.integers(-(1 << 20), 1 << 20, (400, 3)).astype(np.int32)
    keys = jk.pack_coords(jnp.asarray(coords))
    _eq(jk.unpack_key(keys), tk.unpack_key(torch.as_tensor(np.asarray(keys))), "unpack_key")
    assert np.array_equal(tk.unpack_key(tk.pack_coords(torch.as_tensor(coords))).numpy(),
                          coords)
    for k in (1, 7, 27):
        _eq(jk.neighbor_offsets(k), tk.neighbor_offsets(k), f"offsets {k}")
    with pytest.raises(ValueError):
        tk.neighbor_offsets(9)
    raw = np.sort(np.concatenate([rng.integers(0, 40, 300),
                                  np.full(30, np.iinfo(np.int64).max)]).astype(np.int64))
    a = jk.segment_ids(jnp.asarray(raw))
    b = tk.segment_ids(torch.as_tensor(raw))
    for x, y, name in zip(a, b, ("valid", "seg_first", "seg_id", "num")):
        _eq(x, y, name)


def test_transform_covs_matches_jax():
    rng = np.random.default_rng(7)
    c = rng.normal(size=(50, 3, 3))
    c = (c @ c.transpose(0, 2, 1)).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    T[:3, :3] = q.astype(np.float32)
    a = j_tcovs(jnp.asarray(T), jnp.asarray(c))
    b = t_tcovs(torch.as_tensor(T), torch.as_tensor(c))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)


def test_maps_default_to_the_card_and_check_their_settings():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tv.GaussianVoxelMap.empty(1.0, 64)
        with pytest.raises(RuntimeError, match="CUDA"):
            tv.IncrementalVoxelMapCov(1.0, 64)
    with pytest.raises(ValueError, match="cell_capacity"):
        tv.IncrementalVoxelMap.empty(1.0, 64, cell_capacity=256, device=CPU)
    with pytest.raises(ValueError, match="2\\^23"):
        tv.IncrementalVoxelMap.empty(1.0, 1 << 23, device=CPU)
    m = tv.GaussianVoxelMap.empty(1.0, 60, device=CPU)
    assert m.capacity == 64 and m.set_lru(5, 2).lru_horizon == 5
    with pytest.raises(ValueError, match="num_offsets"):
        m.set_search_offsets(9)
    i = tv.IncrementalVoxelMapNormalCov(0.5, 20, device=CPU)
    assert (i.has_normals, i.has_covs, i.voxel_capacity, i.payload.shape[1]) == (
        True, True, 24, 17)
