"""The streaming odometry engines of the port, their utilities and the
``odometry_benchmark`` CLI, against the JAX package on the CPU.

The frames and parameters are those of ``tests/test_odometry.py`` (5 frames
of 2,500 points, 0.15 m a frame, 4,096-row capacities, a map of 8,192
rows, k = 10, 0.3 m / 1.0 m); the projective engine takes
``tests/test_projective_search.py:107``'s frames. Every engine runs in both
packages: trajectories within ``atol=1e-3`` a pose entry, and the model engines' final maps with
the same voxel keys. The utilities compare exactly (``stack_frames``,
``write_trajectory``'s bytes, ``Summarizer``'s string, ``compact_cloud``)
or within 1e-9 (APE, RPE) and 1e-6 (``orthonormalize``).
"""

import dataclasses
import io
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.models.odometry import (
    OdometryParams as JParams,
    create_odometry as j_create,
    write_trajectory as j_write_trajectory,
)
from small_gicp_tpu.point_cloud import PointCloud as JCloud, compact_cloud as j_compact
from small_gicp_tpu.utils import metrics as j_metrics
from small_gicp_tpu.utils.benchmark import Summarizer as JSummarizer
from small_gicp_tpu.utils.lie import orthonormalize as j_orthonormalize
from small_gicp_tpu_torch.apps import odometry_benchmark
from small_gicp_tpu_torch.models.odometry import (
    ENGINES,
    OdometryParams,
    create_odometry,
    write_trajectory,
)
from small_gicp_tpu_torch.models.voxelmap import IncrementalVoxelMapCov, ivm_as_cloud
from small_gicp_tpu_torch.ops.voxel_keys import INVALID_KEY
from small_gicp_tpu_torch.point_cloud import (
    PAD_SENTINEL,
    PointCloud,
    compact_cloud,
    live_rows,
)
from small_gicp_tpu_torch.utils import metrics
from small_gicp_tpu_torch.utils.benchmark import Stopwatch, Summarizer
from small_gicp_tpu_torch.utils.io import (
    list_kitti_scans,
    read_kitti_bin,
    read_pose_matrix,
    write_kitti_bin,
)
from small_gicp_tpu_torch.utils.lie import orthonormalize, se3_exp

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


def _make_frames(n_frames=5, step=0.15, n=2500, seed=3):
    """``tests/test_odometry.py``'s frames and ground truth: a wavy ground
    and two walls seen from a sensor moving +x."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-8, 8, size=(n - 800, 2))
    ground = np.c_[g[:, 0], g[:, 1], 0.3 * np.sin(0.7 * g[:, 0]) + 0.2 * np.cos(0.9 * g[:, 1])]
    w1 = rng.uniform(-8, 8, size=(400, 2))
    wall1 = np.c_[w1[:, 0], np.full(400, -8.0) + 0.05 * np.sin(w1[:, 0]), 1 + w1[:, 1] * 0.2]
    w2 = rng.uniform(-8, 8, size=(400, 2))
    wall2 = np.c_[np.full(400, 8.0) + 0.05 * np.cos(w2[:, 0]), w2[:, 0], 1 + w2[:, 1] * 0.2]
    world = np.concatenate([ground, wall1, wall2])
    frames, gt = [], []
    for i in range(n_frames):
        x = step * i
        local = world - [x, 0.0, 0.0]
        local = local + rng.normal(scale=0.005, size=local.shape)
        frames.append(local.astype(np.float32))
        T = np.eye(4)
        T[0, 3] = x
        gt.append(T)
    return frames, np.stack(gt)


# The projective engine runs on its own frames (test_projective_engine_matches_jax).
STREAMING = sorted(e for e in ENGINES if e != "small_gicp_projective")


@pytest.mark.parametrize("engine", STREAMING)
def test_streaming_engine_matches_jax(engine):
    frames, gt = _make_frames()
    j = j_create(engine, J_PARAMS)
    j_poses = j.estimate(frames)
    t = create_odometry(engine, PARAMS, device="cpu")
    t_poses = t.estimate(frames)
    assert t_poses.shape == (5, 4, 4) and t_poses.dtype == np.float32
    np.testing.assert_allclose(t_poses, j_poses, atol=1e-3)
    assert np.linalg.norm(t_poses[-1, :3, 3] - gt[-1, :3, 3]) < 0.05
    assert np.linalg.norm(t_poses[-1, :3, :3] - np.eye(3)) < 0.02
    if hasattr(j, "voxelmap"):
        keys = t.voxelmap.vox_keys.numpy()
        j_keys = np.asarray(j.voxelmap.vox_keys)
        assert int(t.voxelmap.num_voxels) == int(j.voxelmap.num_voxels)
        assert set(keys[keys != INVALID_KEY]) == set(j_keys[j_keys != INVALID_KEY])
    assert t.report().startswith("registration_time_stats=")
    assert t.report().endswith(" [msec/scan]") and t.reg_times.count == 5


def test_projective_engine_matches_jax():
    """``small_gicp_projective`` on ``tests/test_projective_search.py:107``'s
    frames and parameters: the trajectory within 1e-3 of the JAX engine's,
    tracking the 0.3 m steps."""
    rng = np.random.default_rng(0)
    base = rng.uniform(-20, 20, size=(4000, 3)).astype(np.float32)
    base[:, 2] = np.clip(base[:, 2], -3.0, 3.0)
    scans = [base - np.array([0.3 * i, 0.0, 0.0], np.float32)
             + rng.normal(scale=0.005, size=base.shape).astype(np.float32) for i in range(4)]
    shape = dict(max_scan_points=4096, max_downsampled=4096, map_capacity=4096,
                 downsampling_resolution=0.3)
    j_poses = j_create("small_gicp_projective", JParams(**shape)).estimate(scans)
    t = create_odometry("small_gicp_projective", OdometryParams(**shape), device="cpu")
    t_poses = t.estimate(scans)
    assert "small_gicp_projective" in ENGINES and t.reg_times.count == 4
    np.testing.assert_allclose(t_poses, j_poses, atol=1e-3)
    assert abs(t_poses[-1][0, 3] - 0.9) < 0.1
    with pytest.raises(ValueError, match="unknown engine"):
        create_odometry("small_gicp_fast", PARAMS, device="cpu")


def test_motion_clamp_and_warning():
    """The streaming model engines clamp as the chunked path does
    (``tests/test_odometry.py:61``); the others warn at construction."""
    odom = create_odometry("small_gicp_model",
                           dataclasses.replace(PARAMS, max_frame_motion=0.5), device="cpu")
    odom.T_world = torch.eye(4)
    odom.T_delta = torch.eye(4)
    odom.T_delta[0, 3] = 0.2
    pred = odom.T_world @ odom.T_delta
    ok_pose = torch.eye(4)
    ok_pose[0, 3] = 0.3
    assert torch.equal(odom._motion_clamp(ok_pose), ok_pose)
    bad_pose = torch.eye(4)
    bad_pose[0, 3] = 1.5
    assert torch.equal(odom._motion_clamp(bad_pose), pred)
    odom.T_delta = torch.eye(4)
    assert torch.equal(odom._motion_clamp(bad_pose), bad_pose)
    with pytest.warns(UserWarning, match="max_frame_motion"):
        create_odometry("small_gicp", dataclasses.replace(PARAMS, max_frame_motion=0.5),
                        device="cpu")
    with pytest.warns(UserWarning, match="max_frame_motion"):
        create_odometry("small_vgicp", dataclasses.replace(PARAMS, max_frame_motion=0.5),
                        device="cpu")


def test_write_trajectory_bytes(tmp_path):
    rng = np.random.default_rng(5)
    poses = se3_exp(torch.as_tensor(rng.normal(size=(4, 6)) * 0.7)).numpy()
    for dtype in (np.float32, np.float64):
        write_trajectory(str(tmp_path / "t.txt"), poses.astype(dtype))
        j_write_trajectory(str(tmp_path / "j.txt"), poses.astype(dtype))
        assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    loaded = metrics.load_kitti_trajectory(str(tmp_path / "t.txt"))
    np.testing.assert_allclose(loaded, poses, atol=1e-8)
    np.testing.assert_array_equal(loaded, j_metrics.load_kitti_trajectory(
        str(tmp_path / "t.txt")))


def test_summarizer_and_stopwatch():
    s, js = Summarizer(), JSummarizer()
    assert str(s) == str(js) == "0.000 +- 0.000 (median=0.000)"
    for v in (3.25, 1.0, 7.125, 0.5, 2.0):
        s.push(v)
        js.push(v)
    assert str(s) == str(js) and s.count == js.count == 5
    w = Stopwatch()
    assert w.lap() >= 0.0 and w.msec() >= 0.0


def test_trajectory_metrics_match_jax():
    rng = np.random.default_rng(11)
    gt = se3_exp(torch.as_tensor(np.cumsum(rng.normal(size=(40, 6)) * 0.1, 0))).numpy()
    noise = se3_exp(torch.as_tensor(rng.normal(size=(40, 6)) * 0.01)).numpy()
    est = np.einsum("fij,fjk->fik", gt, noise)
    T = se3_exp(torch.as_tensor([0.1, -0.2, 0.3, 1.0, 2.0, -0.5], dtype=torch.float64)).numpy()
    np.testing.assert_allclose(metrics.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3]),
                               j_metrics.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3]),
                               atol=1e-12)
    for align in (True, False):
        got = metrics.ape_translation(T @ est, gt, align=align)
        want = j_metrics.ape_translation(T @ est, gt, align=align)
        np.testing.assert_allclose(got, want, atol=1e-9)
    for delta in (1, 10, 100):
        np.testing.assert_allclose(metrics.rpe_translation(est, gt, delta),
                                   j_metrics.rpe_translation(est, gt, delta), atol=1e-9)
    assert metrics.ape_translation(T @ gt, gt)[0] < 1e-9


def test_orthonormalize_matches_jax():
    rng = np.random.default_rng(2)
    T = se3_exp(torch.as_tensor(rng.normal(size=(6, 6)), dtype=torch.float32))
    T[:, :3, :3] += torch.as_tensor(rng.normal(size=(6, 3, 3)) * 1e-4, dtype=torch.float32)
    got = orthonormalize(T)
    want = np.asarray(j_orthonormalize(jnp.asarray(T.numpy())))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(got[:, :3, 3].numpy(), T[:, :3, 3].numpy())
    R = got[:, :3, :3].double()
    err = (R.transpose(-1, -2) @ R - torch.eye(3, dtype=torch.float64)).abs().max()
    assert float(err) < 1e-6
    assert torch.equal(orthonormalize(torch.eye(4)), torch.eye(4))


def _same_compact(t: PointCloud, j: JCloud):
    assert int(t.num_points) == int(j.num_points)
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
    for name in ("normals", "covs"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compact_cloud_matches_jax():
    """On the cloud of ``tests/test_odometry_scan.py:280`` and on an
    incremental map's cloud view, where the JAX liveness (w > 0.5) and the
    search's ``live_rows`` take the same rows."""
    pts = np.full((16, 4), PAD_SENTINEL, np.float32)
    pts[:, 3] = 0.0
    for i, xyz in [(3, (1, 2, 3)), (7, (4, 5, 6)), (12, (7, 8, 9))]:
        pts[i, :3] = xyz
        pts[i, 3] = 1.0
    covs = np.zeros((16, 3, 3), np.float32)
    covs[3, 0, 0], covs[7, 1, 1], covs[12, 2, 2] = 3, 7, 12
    t = PointCloud(points=torch.from_numpy(pts), num_points=torch.tensor(3, dtype=torch.int32),
                   covs=torch.from_numpy(covs))
    j = JCloud(points=jnp.asarray(pts), num_points=jnp.asarray(3), covs=jnp.asarray(covs))
    for rows in (8, 2):
        _same_compact(compact_cloud(t, rows), j_compact(j, rows))
    out = compact_cloud(t, 2)
    np.testing.assert_array_equal(out.points[:, 0].numpy(), [1, 4])

    frames, gt = _make_frames(n_frames=3)
    vm = IncrementalVoxelMapCov(1.0, 4096, voxel_capacity=512, device="cpu")
    rng = np.random.default_rng(0)
    for f, T in zip(frames, gt):
        cloud = PointCloud.from_points(f, device="cpu")
        cloud = cloud.replace(covs=torch.as_tensor(
            np.tile(np.eye(3, dtype=np.float32), (cloud.capacity, 1, 1))
            * rng.uniform(0.5, 2.0, size=(cloud.capacity, 1, 1)).astype(np.float32)))
        vm = vm.insert(cloud, torch.as_tensor(T, dtype=torch.float32))
    view = ivm_as_cloud(vm)
    n_live = int(view.num_points)
    assert 0 < n_live < view.capacity
    assert torch.equal(view.points[:, 3] > 0.5, live_rows(view.points, view.num_points))
    jview = JCloud(points=jnp.asarray(view.points.numpy()),
                   num_points=jnp.asarray(view.num_points.numpy()),
                   covs=jnp.asarray(view.covs.numpy()))
    for rows in (n_live + 100, n_live // 2):
        got = compact_cloud(view, rows)
        _same_compact(got, j_compact(jview, rows))
    got = compact_cloud(view, n_live + 100)
    live = view.points[:, 3] > 0.5
    assert torch.equal(got.points[:n_live], view.points[live])
    assert torch.equal(got.covs[:n_live], view.covs[live])


def test_kitti_io(tmp_path):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    for i in (2, 0, 1):
        write_kitti_bin(str(tmp_path / f"{i:06d}.bin"), pts + i)
    (tmp_path / "notes.txt").write_text("x")
    paths = list_kitti_scans(str(tmp_path))
    assert [p.rsplit("/", 1)[1] for p in paths] == ["000000.bin", "000001.bin", "000002.bin"]
    np.testing.assert_array_equal(read_kitti_bin(paths[1]), pts + 1)
    raw = np.fromfile(paths[0], np.float32).reshape(-1, 4)
    assert np.all(raw[:, 3] == 0.0)
    T = se3_exp(torch.as_tensor([0.1, 0.2, 0.3, 1.0, 2.0, 3.0], dtype=torch.float64)).numpy()
    np.savetxt(tmp_path / "T4.txt", T)
    np.savetxt(tmp_path / "T3.txt", T[:3])
    np.testing.assert_allclose(read_pose_matrix(str(tmp_path / "T4.txt")), T, atol=1e-15)
    np.testing.assert_allclose(read_pose_matrix(str(tmp_path / "T3.txt")), T, atol=1e-15)
    np.savetxt(tmp_path / "bad.txt", T[:2])
    with pytest.raises(ValueError):
        read_pose_matrix(str(tmp_path / "bad.txt"))


JAX_CLI_KEYS = ["dataset_path", "output_path", "registration_engine", "num_threads",
                "num_neighbors", "downsampling_resolution", "voxel_resolution",
                "num_frames", "registration_time_stats", "saved"]


@pytest.mark.parametrize("engine", ["small_gicp", "gicp_model_fused"])
def test_cli_on_two_bin_frames(tmp_path, engine):
    """The CLI reads two ``.bin`` frames, prints the JAX CLI's lines
    (``small_gicp_tpu/apps/odometry_benchmark.py:116-172``) and writes a
    two-line trajectory that agrees with the engine run directly."""
    frames, _ = _make_frames(n_frames=2)
    data = tmp_path / "scans"
    data.mkdir()
    for i, f in enumerate(frames):
        write_kitti_bin(str(data / f"{i:06d}.bin"), f)
    out = tmp_path / "traj.txt"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = odometry_benchmark.main([str(data), str(out), "--engine", engine,
                                      "--device", "cpu", "--num_neighbors", "10",
                                      "--downsampling_resolution", "0.3",
                                      "--voxel_resolution", "1.0",
                                      "--max_scan_points", "4096",
                                      "--max_downsampled", "4096",
                                      "--map_capacity", "8192"])
    assert rc == 0
    lines = buf.getvalue().splitlines()
    assert [ln.split("=", 1)[0] for ln in lines] == JAX_CLI_KEYS
    assert f"registration_engine={engine}" in lines and "num_frames=2" in lines
    assert lines[-2].endswith("[msec/scan]") or "[msec/scan] (steady-state" in lines[-2]
    traj = metrics.load_kitti_trajectory(str(out))
    assert traj.shape == (2, 4, 4)
    assert abs(traj[1, 0, 3] - 0.15) < 0.05
    with pytest.raises(SystemExit):
        odometry_benchmark.main([str(tmp_path), str(out), "--device", "cpu"])
