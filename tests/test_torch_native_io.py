"""The port's native host loader (``small_gicp_tpu_torch/native``) on the
CPU: it builds into ``build/native/``, reads scans equal to the numpy
readers and to the JAX package's native readers bit for bit, its loader
keeps order, ends, cuts to ``max_points`` and falls back to numpy, and the
odometry CLI's ``load_scans`` streams through it. The files are those of
``tests/test_native_io.py`` (five scans of 1,000-1,400 points, as KITTI
``.bin`` and PLY), written by the test.
"""

import numpy as np
import pytest

from small_gicp_tpu import native as j_native
from small_gicp_tpu_torch import native
from small_gicp_tpu_torch.apps import odometry_benchmark
from small_gicp_tpu_torch.utils.io import read_kitti_bin, read_ply, write_ply


@pytest.fixture(scope="module")
def scan_dir(tmp_path_factory):
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("scans")
    scans = []
    for i in range(5):
        pts = rng.uniform(-50, 50, size=(1000 + 100 * i, 3)).astype(np.float32)
        np.c_[pts, np.full(len(pts), 0.5, np.float32)].tofile(d / f"{i:06d}.bin")
        write_ply(str(d / f"{i:06d}.ply"), pts)
        scans.append(pts)
    return d, scans


def test_library_builds_into_build_native():
    assert native.native_available(), "g++ is expected wherever the port builds"
    path = native.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    assert path.name.startswith("io_native-") and path.suffix == ".so"


@pytest.mark.parametrize("fmt", ["bin", "ply"])
def test_reads_equal_numpy_and_jax_native(scan_dir, fmt):
    d, scans = scan_dir
    for i, pts in enumerate(scans):
        path = str(d / f"{i:06d}.{fmt}")
        if fmt == "bin":
            got, ref, j = (native.read_kitti_bin(path), read_kitti_bin(path),
                           j_native.read_kitti_bin(path))
        else:
            got, ref, j = (native.read_ply_xyz(path), read_ply(path),
                           j_native.read_ply_xyz(path))
        assert got.dtype == np.float32
        assert np.array_equal(got, ref) and np.array_equal(got, j)
        assert np.array_equal(got, pts)
    cut = native.read_kitti_bin(str(d / "000001.bin"), max_points=7)
    assert np.array_equal(cut, scans[1][:7])
    with pytest.raises(IOError):
        native.read_kitti_bin(str(d / "missing.bin"))


@pytest.mark.parametrize("fmt", ["bin", "ply"])
def test_loader_order_termination_and_truncation(scan_dir, fmt):
    d, scans = scan_dir
    paths = [str(d / f"{i:06d}.{fmt}") for i in range(5)]
    loader = native.DatasetLoader(paths, max_points=4096, prefetch=2)
    got = list(loader)
    assert len(got) == 5
    for g, ref in zip(got, scans):
        assert np.array_equal(g, ref)
    with pytest.raises(StopIteration):
        next(loader)
    (g,) = list(native.DatasetLoader([paths[4]], max_points=100))
    assert g.shape == (100, 3) and np.array_equal(g, scans[4][:100])
    assert list(native.DatasetLoader([])) == []
    # An empty scan is a scan of 0 rows, not the end of the stream.
    empty = str(d / f"empty.{fmt}")
    if fmt == "bin":
        open(empty, "wb").close()
    else:
        write_ply(empty, np.zeros((0, 3), np.float32))
    got = list(native.DatasetLoader([paths[0], empty, paths[1]]))
    assert [len(g) for g in got] == [len(scans[0]), 0, len(scans[1])]


def test_numpy_fallback(scan_dir, monkeypatch):
    d, scans = scan_dir
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.native_available()
    paths = [str(d / f"{i:06d}.bin") for i in range(2)]
    got = list(native.DatasetLoader(paths + [str(d / "000002.ply")], max_points=1050))
    assert [len(g) for g in got] == [1000, 1050, 1050]
    assert np.array_equal(got[2], scans[2][:1050])
    assert np.array_equal(native.read_ply_xyz(str(d / "000003.ply")), scans[3])


def test_load_scans_streams_through_the_loader(scan_dir):
    d, scans = scan_dir
    stream = odometry_benchmark.load_scans(str(d), limit=3)
    assert isinstance(stream, native.DatasetLoader)
    assert stream.max_points == 1 << 21 and stream.kitti
    got = list(stream)
    assert len(got) == 3 and all(np.array_equal(g, s) for g, s in zip(got, scans))
    ply_dir = d / "ply_only"
    ply_dir.mkdir(exist_ok=True)
    write_ply(str(ply_dir / "a.ply"), scans[0])
    (only,) = list(odometry_benchmark.load_scans(str(ply_dir)))
    assert np.array_equal(only, scans[0])
