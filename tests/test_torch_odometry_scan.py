"""The chunked odometry engines of the port (``JitOdometry``,
``odometry_scan_step``, ``odometry_scan_step_s2s``) against the JAX
package's on the CPU.

The frames and parameters are those of ``tests/test_odometry_scan.py`` (5
frames of ≈2,500 points, 0.15 m a frame; 4,096-row capacities, a map of
8,192 rows, k = 10, 0.3 m / 1.0 m) and the JAX calls repeat that file's,
so that JAX's persistent compilation cache serves them. Trajectories agree
within ``atol=1e-3`` a pose entry (the JAX package's own tolerance between
its two paths: f32 reduction order can flip a knife-edge LM accept), and
the final maps hold the same voxel keys. Padded frames are exact no-ops and
the first frame against an empty map keeps the guess bit for bit; chunked
feeding and ``feed_preloaded`` equal one ``feed`` within rtol 1e-5 / atol
1e-6, as in JAX. The "voxel" and "knn_window" covariance modes and
``BatchOdometry`` (each lane equal to ``JitOdometry`` alone within rtol
1e-5 / atol 1e-6, and to the JAX batch within 1e-3) are held the same way.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.models.odometry import OdometryParams as JParams
from small_gicp_tpu.models.odometry_scan import (
    BatchOdometry as JBatch,
    JitOdometry as JJit,
    stack_frames as j_stack_frames,
)
from small_gicp_tpu.ops.normals import _estimate_impl as j_estimate
from small_gicp_tpu_torch.models import odometry_scan as osc
from small_gicp_tpu_torch.models.odometry import OdometryParams
from small_gicp_tpu_torch.models.odometry_scan import (
    BatchOdometry,
    JitOdometry,
    make_initial_carry,
)
from small_gicp_tpu_torch.models.registration import align_impl
from small_gicp_tpu_torch.models.voxelmap import (
    GaussianVoxelMap,
    IncrementalVoxelMap,
    ivm_as_cloud,
)
from small_gicp_tpu_torch.ops.voxel_keys import INVALID_KEY
from small_gicp_tpu_torch.point_cloud import PointCloud

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines run many small torch ops; the suite runs several worker
    processes on the same cores, where intra-op threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPE = dict(num_neighbors=10, downsampling_resolution=0.3, voxel_resolution=1.0,
             max_scan_points=4096, max_downsampled=4096, map_capacity=8192)
PARAMS = OdometryParams(**SHAPE)
J_PARAMS = JParams(**SHAPE)


def _frames(n_frames=5, step=0.15, seed=3):
    """``tests/test_odometry_scan.py``'s frames: a wavy ground and two walls
    seen from a sensor moving +x."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-8, 8, size=(1700, 2))
    ground = np.c_[g[:, 0], g[:, 1], 0.3 * np.sin(0.7 * g[:, 0]) + 0.2 * np.cos(0.9 * g[:, 1])]
    w1 = rng.uniform(-8, 8, size=(400, 2))
    wall1 = np.c_[w1[:, 0], np.full(400, -8.0) + 0.05 * np.sin(w1[:, 0]), 1 + w1[:, 1] * 0.2]
    w2 = rng.uniform(-8, 8, size=(400, 2))
    wall2 = np.c_[np.full(400, 8.0) + 0.05 * np.cos(w2[:, 0]), w2[:, 0], 1 + w2[:, 1] * 0.2]
    world = np.concatenate([ground, wall1, wall2])
    return [
        (world - [step * i, 0, 0] + rng.normal(scale=0.005, size=world.shape)
         ).astype(np.float32)
        for i in range(n_frames)
    ]


def _live_keys(vm) -> set:
    keys = np.asarray(vm.vox_keys.cpu() if isinstance(vm.vox_keys, torch.Tensor)
                      else vm.vox_keys)
    return set(keys[keys != INVALID_KEY].tolist())


def _same_model(jm, tm):
    """Final models: the voxel maps' key sets and counts, or the scan-to-scan
    previous clouds' counts."""
    if isinstance(tm, PointCloud):
        assert int(tm.num_points) == int(jm.num_points)
        return
    assert int(tm.num_voxels) == int(jm.num_voxels)
    assert _live_keys(tm) == _live_keys(jm)
    if isinstance(tm, IncrementalVoxelMap):
        assert int(tm.num_points_stored) == int(jm.num_points_stored)


# The JAX calls of tests/test_odometry_scan.py: (engine, frames, chunk_frames).
CASES = {
    "gicp_model": (5, 8),
    "gicp_model_fused": (5, 8),
    "vgicp_model": (5, 8),
    "plane_icp_model_fused": (5, 8),
    "gicp_scan": (4, 4),
}


@pytest.mark.parametrize("engine", sorted(CASES))
def test_trajectory_matches_jax(engine):
    n, chunk = CASES[engine]
    frames = _frames(n)
    j = JJit(J_PARAMS, engine=engine, chunk_frames=chunk)
    j_poses = j.feed(frames)
    t = JitOdometry(PARAMS, engine=engine, chunk_frames=chunk, device="cpu")
    t_poses = t.feed(frames)
    assert t_poses.shape == (n, 4, 4) and t_poses.dtype == np.float32
    np.testing.assert_allclose(t_poses, j_poses, atol=1e-3)
    _same_model(j.carry[2], t.carry[2])
    # and it tracks the true motion (the JAX tests' bound)
    assert abs(t_poses[-1, 0, 3] - 0.15 * (n - 1)) < 0.05


def _carry_tensors(carry):
    T_world, T_delta, model, is_first = carry
    fields = [getattr(model, f.name) for f in dataclasses.fields(model)]
    return [T_world, T_delta, is_first] + [f for f in fields if isinstance(f, torch.Tensor)]


@pytest.mark.parametrize("engine", ["gicp_model_fused", "vgicp_model", "gicp_scan"])
def test_padded_frames_are_exact_noops(engine):
    frames = _frames(2)
    odo = JitOdometry(PARAMS, engine=engine, chunk_frames=2, device="cpu")
    odo.feed(frames)
    before = [x.clone() for x in _carry_tensors(odo.carry)]
    pts, counts = osc.stack_frames([], 3, PARAMS.max_scan_points, PARAMS.dtype)
    poses = odo._run_chunk(torch.from_numpy(pts), torch.from_numpy(counts))
    after = _carry_tensors(odo.carry)
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert all(torch.equal(p, before[0]) for p in poses)


@pytest.mark.parametrize("engine", ["gicp_model", "gicp_model_fused", "vgicp_model",
                                    "vgicp_model_fused", "plane_icp_model_fused",
                                    "gicp_scan"])
def test_first_frame_against_empty_model(engine):
    """The first frame meets a map (or previous cloud) with no live row:
    every correspondence masks out, the LM accepts a zero step, and the
    align returns its guess bit for bit; the step keeps T_world."""
    p = PARAMS
    carry, rtype = make_initial_carry(p, engine, device="cpu")
    pts, counts = osc.stack_frames(_frames(1), 1, p.max_scan_points, p.dtype)
    frame, count = torch.from_numpy(pts)[0], torch.from_numpy(counts)[0]
    model_rtype = rtype or osc._model_rtype_for(engine)
    cloud = osc._frame_cloud(frame, count, p.downsampling_resolution, p.max_downsampled,
                             p.num_neighbors, model_rtype)
    target = carry[2]
    if osc._model_nn_for(engine) == "bruteforce" and not engine.endswith("_scan"):
        target = (ivm_as_cloud(target) if isinstance(target, IncrementalVoxelMap)
                  else osc.voxelmap_as_cloud(target))
    guess = torch.tensor([[1.0, 0.0, 0.0, 0.3], [0.0, 1.0, 0.0, -0.2],
                          [0.0, 0.0, 1.0, 0.1], [0.0, 0.0, 0.0, 1.0]])
    res = align_impl(target, cloud, None, guess, registration_type=model_rtype,
                     source_rows=cloud.capacity)
    assert torch.equal(res.T_target_source, guess)
    assert int(res.num_inliers) == 0 and bool(res.converged)
    if engine.endswith("_scan"):
        carry, T = osc.odometry_scan_step_s2s(carry, frame, count, 0.3, 1.0, 4096, 10, rtype)
    else:
        carry, T = osc.odometry_scan_step(carry, frame, count, 0.3, 1.0, 4096, 10,
                                          model_nn=osc._model_nn_for(engine),
                                          model_rtype=model_rtype)
    assert torch.equal(T, torch.eye(4)) and not bool(carry[3])


def test_chunked_matches_single_feed_and_preloaded():
    frames = _frames(6)
    poses_a = JitOdometry(PARAMS, chunk_frames=4, device="cpu").feed(frames)
    b = JitOdometry(PARAMS, chunk_frames=4, device="cpu")
    b.feed(frames[:3])
    poses_b_tail = b.feed(frames[3:])
    np.testing.assert_allclose(poses_a[-1], poses_b_tail[-1], rtol=1e-5, atol=1e-6)
    c = JitOdometry(PARAMS, chunk_frames=4, device="cpu")
    fd, cd = c.preload(frames)
    assert fd.shape == (8, 4096, 4) and cd.tolist()[6:] == [0, 0]
    poses_c = c.feed_preloaded(fd, cd)
    assert poses_c.shape == (6, 4, 4) and len(c.chunk_times_ms) == 2
    np.testing.assert_allclose(poses_a, poses_c, rtol=1e-5, atol=1e-6)


def test_max_frame_motion_clamp():
    """The case ``tests/test_odometry_scan.py:237`` builds: with a 0.15 m a
    frame motion established, a frame that jumps 0.45 m is accepted at a
    band of 1.0 and rejected at 0.2 (the pose coasts on the prediction)."""
    frames = _frames(3)
    p = OdometryParams(num_neighbors=10, downsampling_resolution=0.3,
                       max_scan_points=2048, max_downsampled=2048, map_capacity=16384)

    def step(carry, f, band):
        pts, cnt = osc.stack_frames([f], 1, p.max_scan_points, p.dtype)
        return osc.odometry_scan_step(
            carry, torch.from_numpy(pts)[0], torch.from_numpy(cnt)[0],
            downsampling_resolution=p.downsampling_resolution,
            max_downsampled=p.max_downsampled, num_neighbors=10, max_frame_motion=band)

    def run(band):
        carry, _ = make_initial_carry(p, "gicp_model", device="cpu")
        for f in frames:
            carry, pose = step(carry, f, band)
        jumped = frames[-1] - np.asarray([0.45, 0, 0], np.float32)
        carry, pose = step(carry, jumped, band)
        return float(pose[0, 3])

    base = 0.15 * 2
    assert abs(run(1.0) - (base + 0.45)) < 0.05
    assert abs(run(0.2) - (base + 0.15)) < 0.05


def test_model_prepared_rows_sufficient_budget_equals_none():
    frames = _frames(4)
    base = dict(max_scan_points=4096, max_downsampled=4096, map_capacity=16384,
                voxel_resolution=1.0, num_neighbors=10, downsampling_resolution=0.3)
    t0 = JitOdometry(OdometryParams(**base), "gicp_model_fused", chunk_frames=4,
                     device="cpu").feed(frames)
    t1 = JitOdometry(OdometryParams(**base, model_prepared_rows=8192), "gicp_model_fused",
                     chunk_frames=4, device="cpu").feed(frames)
    assert np.abs(t1 - t0).max() < 1e-3


@pytest.mark.parametrize("mode", ["voxel", "knn_window"])
def test_covariance_modes(mode):
    """"voxel" (27-voxel moments) and "knn_window" (windowed kNN lists)
    against the JAX package's ``JitOdometry`` in the same mode (its calls of
    ``tests/test_odometry_scan.py:116``): poses within 1e-3, the same map
    keys, and the trajectory of "knn" within 2e-3 as JAX bounds it."""
    frames = _frames(5)
    j = JJit(J_PARAMS, covariance_mode=mode)
    j_poses = j.feed(frames)
    t = JitOdometry(PARAMS, covariance_mode=mode, device="cpu")
    t_poses = t.feed(frames)
    np.testing.assert_allclose(t_poses, j_poses, atol=1e-3)
    _same_model(j.carry[2], t.carry[2])
    exact = JitOdometry(PARAMS, covariance_mode="knn", device="cpu").feed(frames)
    assert abs(t_poses[-1, 0, 3] - 0.6) < 0.05
    assert np.max(np.abs(t_poses - exact)) < 2e-3
    if mode == "knn_window":
        # Point-to-plane normals through the window mode, against the JAX
        # estimator on the same downsampled rows (within 1e-4 where both
        # packages find a normal).
        pts = torch.from_numpy(j_stack_frames(frames[:1], 1, 4096, "float32")[0][0])
        cloud = osc._frame_cloud(pts, torch.tensor(len(frames[0]), dtype=torch.int32), 0.3,
                                 4096, 10, "plane_icp", mode)
        want, _ = j_estimate(jnp.asarray(cloud.points.numpy()), jnp.int32(cloud.num_points),
                             10, True, False, neighbor_mode="window", window_cell=0.3)
        got, want = cloud.normals.numpy(), np.asarray(want)
        both = (np.abs(got).sum(1) > 0) & (np.abs(want).sum(1) > 0)
        assert both.sum() > 500 and np.mean(np.abs(got - want).max(1)[both] <= 1e-4) > 0.99


def test_knn_fused_equals_knn():
    """"knn_fused" equals "knn": both reach the moments kernel's account."""
    frames = _frames(3)
    a = JitOdometry(PARAMS, chunk_frames=3, covariance_mode="knn", device="cpu").feed(frames)
    b = JitOdometry(PARAMS, chunk_frames=3, covariance_mode="knn_fused",
                    device="cpu").feed(frames)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        JitOdometry(PARAMS, chunk_frames=1, covariance_mode="exact",
                    device="cpu").feed(frames[:1])


def test_batch_odometry_matches_lanes_and_jax():
    """``BatchOdometry`` of ``tests/test_odometry_scan.py:128``'s three lanes
    (one shorter): each lane equal to ``JitOdometry`` alone within rtol 1e-5
    / atol 1e-6, the padded tail repeating the lane's last pose, and the
    JAX package's batch within 1e-3."""
    seqs = [_frames(4, step=0.15, seed=3), _frames(4, step=0.10, seed=7),
            _frames(2, step=0.20, seed=11)]
    batch = BatchOdometry(3, PARAMS, device="cpu")
    poses = batch.feed(seqs)
    assert poses.shape == (3, 4, 4, 4) and poses.dtype == np.float32
    for lane, seq in enumerate(seqs):
        solo = JitOdometry(PARAMS, chunk_frames=4, device="cpu").feed(seq)
        np.testing.assert_allclose(poses[lane, :len(seq)], solo, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(poses[2, 2:], np.repeat(poses[2, 1:2], 2, axis=0))
    np.testing.assert_allclose(poses, JBatch(3, J_PARAMS).feed(seqs), atol=1e-3)
    with pytest.raises(TypeError, match="mesh must be a 1-D DeviceMesh"):
        BatchOdometry(2, PARAMS, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="expected 3 sequences"):
        batch.feed(seqs[:2])


def test_batch_odometry_scan_to_scan():
    """``tests/test_odometry_scan.py:151``: two equal gicp_scan lanes equal
    each other, ``JitOdometry`` alone and the JAX package's batch."""
    seq = _frames(3)
    poses = BatchOdometry(2, PARAMS, engine="gicp_scan", device="cpu").feed([seq, seq])
    np.testing.assert_array_equal(poses[0], poses[1])
    solo = JitOdometry(PARAMS, engine="gicp_scan", chunk_frames=3, device="cpu").feed(seq)
    np.testing.assert_allclose(poses[0], solo, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(poses, JBatch(2, J_PARAMS, engine="gicp_scan").feed([seq, seq]),
                               atol=1e-3)


def test_stack_frames_equals_jax():
    frames = _frames(2)
    frames[1] = np.concatenate([frames[1], frames[1]])  # past the capacity: cut
    for dtype in ("float32", "float64"):
        got = osc.stack_frames(frames, 3, 4096, dtype)
        want = j_stack_frames(frames, 3, 4096, dtype)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_construction_warnings_and_engines():
    with pytest.warns(UserWarning, match="max_frame_motion"):
        JitOdometry(dataclasses.replace(PARAMS, max_frame_motion=0.5), "gicp_scan",
                    device="cpu")
    with pytest.warns(UserWarning, match="model_prepared_rows"):
        JitOdometry(dataclasses.replace(PARAMS, model_prepared_rows=1024), "gicp_model",
                    device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        JitOdometry(dataclasses.replace(PARAMS, max_frame_motion=0.5,
                                        model_prepared_rows=1024),
                    "gicp_model_fused", device="cpu")
    for engine in osc.MODEL_ENGINES + osc.SCAN_ENGINES:
        carry, rtype = make_initial_carry(PARAMS, engine, device="cpu")
        model = carry[2]
        if engine.startswith("vgicp"):
            assert isinstance(model, GaussianVoxelMap) and rtype is None
        elif engine.endswith("_scan"):
            assert isinstance(model, PointCloud) and rtype == engine[:-5]
            assert int(model.num_points) == 0 and model.capacity == 4096
        else:
            assert isinstance(model, IncrementalVoxelMap) and rtype is None
            assert model.voxel_capacity == 2048
            assert model.has_normals == engine.startswith("plane")
    with pytest.raises(ValueError):
        make_initial_carry(PARAMS, "small_gicp", device="cpu")


def test_voxelgrid_run_sums_equal_first_form():
    """Every frame's voxelgrid takes its float64 run sums along the last dim
    of the [4,N] transpose; on the CPU both forms are sequential sums and
    equal bit for bit, on the card within one float32 ulp (chip_smoke.py
    phase 5)."""
    from small_gicp_tpu_torch.ops import downsampling

    pts, counts = osc.stack_frames(_frames(2), 2, 4096, "float32")
    for f, c in zip(torch.from_numpy(pts), torch.from_numpy(counts)):
        new = downsampling._voxelgrid_sampling_impl(f, c, 0.3, 4096)
        saved = downsampling._run_sums
        downsampling._run_sums = downsampling._run_sums_v1
        try:
            old = downsampling._voxelgrid_sampling_impl(f, c, 0.3, 4096)
        finally:
            downsampling._run_sums = saved
        assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
        assert new[0].is_contiguous() and 0 < int(new[1]) < int(c)
