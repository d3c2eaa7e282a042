"""The port's remaining utilities and apps against the JAX package on the
CPU: ``utils/io``'s PLY reader (with normals) and writer read across with
JAX's, ``utils/profiling`` (``host_fingerprint`` equal to JAX's,
``StageTimer``, ``trace``, ``nan_guard``, ``enable_compilation_cache``),
``utils/synthetic``'s ``world_arrays`` (equal) and
``generate_sequence_device`` (JAX's ``jax.random`` stream has no
bit-equal torch counterpart, so held by statistics on a 16-ring × 256-step
sequence: returns a frame within 3 %, the range histogram within 0.02 a
bin, the ground share within 0.02, the poses equal to
``loop_trajectory``'s), and each app's ``main()`` in process at a small
size: ``dump_synthetic_kitti`` → ``odometry_benchmark`` →
``odometry_accuracy``, ``plot_odometry`` (Agg, a PNG),
``downsampling_benchmark`` and ``synthetic_odometry_benchmark``.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from small_gicp_tpu.utils import io as j_io
from small_gicp_tpu.utils import profiling as j_profiling
from small_gicp_tpu.utils import synthetic as j_synthetic
from small_gicp_tpu_torch import _build, native
from small_gicp_tpu_torch.apps import (
    downsampling_benchmark,
    dump_synthetic_kitti,
    odometry_accuracy,
    odometry_benchmark,
    plot_odometry,
    synthetic_odometry_benchmark,
)
from small_gicp_tpu_torch.point_cloud import PAD_SENTINEL, PointCloud
from small_gicp_tpu_torch.utils import io as t_io
from small_gicp_tpu_torch.utils import profiling, synthetic
from small_gicp_tpu_torch.utils.metrics import load_kitti_trajectory


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    assert rc in (0, None) or isinstance(rc, dict), out.getvalue()
    return out.getvalue()


def test_ply_read_write_across_packages(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    nrm = rng.normal(size=(40, 3)).astype(np.float32)
    mine, theirs = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    t_io.write_ply(mine, pts, nrm)
    j_io.write_ply(theirs, pts, nrm)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    xyz, n = t_io.read_ply(theirs, return_normals=True)
    assert np.array_equal(xyz, pts) and np.array_equal(n, nrm)
    jx, jn = j_io.read_ply(mine, return_normals=True)
    assert np.array_equal(jx, xyz) and np.array_equal(jn, n)
    t_io.write_ply(mine, pts)
    xyz, n = t_io.read_ply(mine, return_normals=True)
    assert n is None and np.array_equal(xyz, t_io.read_ply(mine))
    # ascii with the normals' columns in another order, as JAX reads it
    ascii_path = tmp_path / "a.ply"
    rows = "\n".join(f"{a} {b} {c} 7 {d} {e} {f}" for (a, b, c), (d, e, f)
                     in zip(pts[:5].tolist(), nrm[:5].tolist()))
    ascii_path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 5\nproperty float x\nproperty float y\n"
        "property float z\nproperty uchar tag\nproperty float nx\nproperty float ny\n"
        "property float nz\nend_header\n" + rows + "\n")
    got = t_io.read_ply(str(ascii_path), return_normals=True)
    want = j_io.read_ply(str(ascii_path), return_normals=True)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_host_fingerprint_and_compilation_cache(tmp_path, monkeypatch):
    assert profiling.host_fingerprint() == j_profiling.host_fingerprint()
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    before = (_build.BUILD_DIR, native.BUILD_DIR)
    profiling.enable_compilation_cache()
    assert (_build.BUILD_DIR, native.BUILD_DIR) == before
    profiling.enable_compilation_cache(str(tmp_path))
    root = tmp_path / profiling.host_fingerprint()
    assert _build.BUILD_DIR == root / "kernels" and native.BUILD_DIR == root / "native"
    assert native.library_path().parent == root / "native"


def test_stage_timer_trace_and_nan_guard(tmp_path):
    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("cloud") as box:
            box["cloud"] = PointCloud.from_points(np.ones((4, 3), np.float32),
                                                  device="cpu")
        with timer.stage("empty"):
            pass
    assert list(timer.stages) == ["cloud", "empty"]
    assert timer.stages["cloud"].count == 3
    lines = timer.report().splitlines()
    assert len(lines) == 2 and lines[0].startswith("cloud=") and lines[0].endswith(
        " [msec]")

    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])

    x = torch.tensor([1.0, -1.0])
    with pytest.raises(FloatingPointError, match="NaN"):
        with profiling.nan_guard():
            torch.sqrt(x)
    with profiling.nan_guard(False):
        assert bool(torch.isnan(torch.sqrt(x)).any())
    with profiling.nan_guard():
        assert torch.equal(torch.sqrt(x.abs()), torch.ones(2))


def test_world_arrays_equal_jax():
    world = synthetic.make_world(seed=3)
    for a, b in zip(synthetic.world_arrays(world),
                    j_synthetic.world_arrays(j_synthetic.make_world(seed=3))):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def _stats(frames, counts, max_range=75.0):
    """Returns a frame, the range histogram and the share of ground hits."""
    hist, ground = [], []
    for f, n in zip(frames, counts):
        p = f[:n, :3]
        r = np.linalg.norm(p, axis=1)
        hist.append(np.histogram(r, bins=8, range=(0, max_range))[0] / n)
        ground.append(np.mean(p[:, 2] < -1.2))  # the sensor rides ≈1.8 m up
    return np.mean(counts), np.mean(hist, 0), np.mean(ground)


@pytest.mark.parametrize("knobs", [{}, {"dropout": 0.2, "n_dynamic": 6, "noise": 0.05}])
def test_generate_sequence_device_statistics(knobs):
    kw = dict(n_frames=3, rings=16, azimuth_steps=256, pad_frames_to=4, **knobs)
    frames, counts, poses = synthetic.generate_sequence_device(**kw, device="cpu")
    jf, jc, jp = j_synthetic.generate_sequence_device(**kw)
    assert frames.shape == (4, 16 * 256, 4) and frames.dtype == torch.float32
    assert counts.dtype == torch.int32 and int(counts[3]) == 0
    assert np.array_equal(poses, synthetic.loop_trajectory(3)) and np.array_equal(poses, jp)
    f, c = frames.numpy(), counts.numpy()
    for i in range(3):
        assert np.all(f[i, :c[i], 3] == 1.0) and np.all(f[i, c[i]:, 0] == PAD_SENTINEL)
    assert np.all(f[3, :, 3] == 0.0)
    n, hist, ground = _stats(f[:3], c[:3])
    jn, jhist, jground = _stats(np.asarray(jf)[:3], np.asarray(jc)[:3])
    assert abs(n - jn) <= 0.03 * jn
    np.testing.assert_allclose(hist, jhist, atol=0.02)
    assert abs(ground - jground) <= 0.02


def test_apps_in_process(tmp_path):
    d = str(tmp_path / "synth")
    out = _run(dump_synthetic_kitti.main, [d, "--frames", "4", "--device", "cpu"])
    assert out.startswith("wrote 4 scans (") and out.rstrip().endswith(f"gt.txt to {d}")
    assert len([n for n in os.listdir(d) if n.endswith(".bin")]) == 4
    est = str(tmp_path / "est.txt")
    out = _run(odometry_benchmark.main, [
        d, est, "--engine", "small_gicp", "--device", "cpu", "--max_scan_points", "16384",
        "--max_downsampled", "4096", "--map_capacity", "8192",
        "--downsampling_resolution", "0.5"])
    assert "num_frames=4" in out and f"saved={est}" in out
    gt = load_kitti_trajectory(os.path.join(d, "gt.txt"))
    assert np.abs(load_kitti_trajectory(est)[:, :3, 3] - gt[:, :3, 3]).max() < 0.2
    out = _run(odometry_accuracy.main, [os.path.join(d, "gt.txt"), est, "--rpe_delta", "1"])
    assert out.splitlines()[0].split()[:3] == ["trajectory", "APE", "[m]"]
    ape = float(out.splitlines()[1].split()[1])
    assert ape < 0.2

    png = str(tmp_path / "odo.png")
    times = tmp_path / "times.txt"
    times.write_text("1.0\n2.0\n1.5\n1.2\n")
    out = _run(plot_odometry.main, [est, "--gt", os.path.join(d, "gt.txt"), "--times",
                                    str(times), "-o", png])
    assert out.strip() == f"wrote {png}"
    assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"

    out = _run(downsampling_benchmark.main, [
        "--num_points", "2048", "--resolutions", "1.0", "4.0", "--trials", "1",
        "--device", "cpu"])
    lines = out.splitlines()
    assert lines[0] == "backend=cpu num_points=2048"
    rec = [json.loads(line) for line in lines[1:]]
    assert [r["resolution"] for r in rec] == [1.0, 4.0]
    assert rec[0]["points_out"] > rec[1]["points_out"] > 0 and rec[0]["msec"] > 0
    out = _run(downsampling_benchmark.main, [os.path.join(d, "000000.bin"),
                                             "--resolutions", "1.0", "--trials", "1",
                                             "--device", "cpu"])
    assert out.splitlines()[0].startswith("backend=cpu num_points=")

    out = _run(synthetic_odometry_benchmark.main, [
        "--frames", "3", "--chunk-frames", "2", "--engines", "gicp_scan",
        "--max-downsampled", "2048", "--downsample", "1.0", "--rpe-delta", "1",
        "--device", "cpu", "--save-prefix", str(tmp_path / "syn")])
    last = json.loads(out.splitlines()[-1])
    assert last["frames"] == 3 and last["results"]["gicp_scan"]["ape_mean"] < 0.2
    assert any(line.startswith("gicp_scan: APE ") for line in out.splitlines())
    assert (tmp_path / "syn_gt.txt").exists() and (tmp_path / "syn_gicp_scan.txt").exists()
