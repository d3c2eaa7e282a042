"""Edge cases of the port's search wrappers (k above the valid rows, empty
targets, no query, one query, ``num_points`` below the capacity), the
target-side tables that ``KdTree`` keeps between searches, its file
readers against the JAX package's writers, and the ``kdtree_benchmark``
CLI on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from small_gicp_tpu.utils.io import write_kitti_bin, write_ply
from small_gicp_tpu_torch.apps import kdtree_benchmark
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.ops.knn_cuda import (
    knn,
    knn_pruned,
    knn_T,
    nearest_neighbor,
    pruned_prepare_queries,
    pruned_query_positions,
    target_centre,
)
from small_gicp_tpu_torch.utils.io import read_kitti_bin, read_ply


@pytest.mark.parametrize("search", [knn, knn_T, knn_pruned])
def test_search_wrapper_edge_cases(search):
    rng = np.random.default_rng(5)
    tp = rng.uniform(-4, 4, (30, 3)).astype(np.float32)
    pts = np.full((40, 4), 1e9, np.float32)
    pts[:30, :3] = tp
    t4 = torch.as_tensor(pts)
    q = torch.as_tensor(tp[:6] + 0.01)

    def num(n):
        return torch.tensor(n, dtype=torch.int32)

    # More neighbours asked than valid rows: real rows first, then d² = 3e38
    # and index 0; rows beyond num_points are never returned.
    d, i = search(t4, num(3), q, 5)
    assert torch.all(d[:, :3] < 1e3) and torch.all(d[:, 3:] == 3e38)
    assert torch.all(i[:, 3:] == 0) and int(i.max()) < 3 and i.dtype == torch.int32
    ref = ((q[:, None, :] - t4[None, :3, :3]) ** 2).sum(-1).sort(dim=1)
    assert torch.equal(i[:, :3].long(), ref.indices)
    # num_points below the capacity, k above the capacity, an empty target,
    # a target without rows, no query, one query.
    d, i = search(t4, num(30), q, 50)
    assert torch.all(d[:, :30] < 1e3) and torch.all(d[:, 30:] == 3e38)
    for tgt, n in ((t4, 0), (t4[:0], 0)):
        d, i = search(tgt, num(n), q, 4)
        assert torch.all(d == 3e38) and torch.all(i == 0)
    d, i = search(t4, num(30), q[:0], 4)
    assert d.shape == (0, 4) and i.shape == (0, 4)
    d1, i1 = search(t4, num(30), q[2:3], 4)
    d, i = search(t4, num(30), q, 4)
    assert torch.equal(i1[0], i[2]) and torch.equal(d1[0], d[2])
    with pytest.raises(ValueError, match="k <= 64"):
        search(t4, num(30), q, 65)


def test_kept_target_tables_give_the_same_results():
    """K9's centre and the target half of K12's prologue depend on the target
    alone: ``KdTree`` computes each once, and a search over the kept tables
    equals the search that computes them itself."""
    rng = np.random.default_rng(9)
    tp = rng.uniform(-20, 20, (900, 3)).astype(np.float32)
    tp[:, 2] = np.sin(tp[:, 0] * 0.4)
    pts = np.full((1000, 4), 1e9, np.float32)
    pts[:900, :3] = tp
    t4, num = torch.as_tensor(pts), torch.tensor(900, dtype=torch.int32)
    tree = KdTree(points=t4, num_points=num)
    queries = (torch.as_tensor(tp[::3] + 0.02),
               torch.as_tensor(rng.uniform(-25, 25, (130, 3)).astype(np.float32)))

    centre, tables = tree.centre(), tree.pruned_target()
    assert tree.centre() is centre and tree.pruned_target() is tables
    assert torch.equal(centre, target_centre(t4))
    # Valid rows sorted first, each carrying its original row; boxes hold them.
    assert sorted(tables.tperm[:900].tolist()) == list(range(900))
    assert torch.equal(tables.tsorted[:900, :3], t4[tables.tperm[:900], :3])
    assert torch.equal(tables.tsorted[:900, 3].view(torch.int32).long(),
                       tables.tperm[:900])
    assert tables.tbox.shape == (4, 8)
    assert torch.equal(tables.tbox[0, 0:3], tables.tsorted[:256, :3].amin(0))
    assert torch.equal(tables.tbox[3, 4:7], tables.tsorted[768:900, :3].amax(0))
    for q in queries:
        d, i = knn(t4, num, q, 7)
        dk, ik = knn_pruned(t4, num, q, 7, target=tables)
        dw, iw = knn_pruned(t4, num, q, 7)
        assert torch.equal(ik, i) and torch.equal(dk, d)
        assert torch.equal(iw, i) and torch.equal(dw, d)
        d1, i1 = nearest_neighbor(t4, num, q, "vpu", centre)
        dn, in_ = nearest_neighbor(t4, num, q, "vpu")
        assert torch.equal(i1, in_) and torch.equal(d1, dn)
        # A CPU tree searches by the uncentred brute force: the same rows.
        assert torch.equal(tree.nearest_neighbor_search(q)[1], in_)
        half = pruned_prepare_queries(tables, q)
        assert sorted(half.qperm.tolist()) == list(range(q.shape[0]))
        qpos = pruned_query_positions(tables, half)
        assert torch.all(half.qkey[1:] >= half.qkey[:-1])
        assert torch.all(qpos[1:] >= qpos[:-1]) and int(qpos.max()) <= 900


def test_readers_and_kdtree_benchmark_cli(tmp_path, capsys):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-30, 30, (700, 3)).astype(np.float32)
    write_kitti_bin(str(tmp_path / "scan.bin"), pts)
    write_ply(str(tmp_path / "scan.ply"), pts, normals=pts[::-1].copy())
    np.testing.assert_array_equal(read_kitti_bin(str(tmp_path / "scan.bin")), pts)
    np.testing.assert_array_equal(read_ply(str(tmp_path / "scan.ply")), pts)
    (tmp_path / "ascii.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
        "property float y\nproperty uchar r\nproperty float z\nend_header\n"
        "1 2 9 3\n4 5 9 6\n")
    np.testing.assert_array_equal(read_ply(str(tmp_path / "ascii.ply")),
                                  [[1, 2, 3], [4, 5, 6]])
    with pytest.raises(ValueError, match="not a PLY"):
        read_ply(str(tmp_path / "scan.bin"))

    for argv in (["--device", "cpu", "--sizes", "512", "--ks", "1", "5",
                  "--trials", "1"],
                 [str(tmp_path / "scan.bin"), "--device", "cpu", "--sizes", "256",
                  "--ks", "3", "--trials", "1"]):
        assert kdtree_benchmark.main(argv) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[0].startswith("backend=cpu")
        rows = [json.loads(line) for line in lines[1:]]
        assert [r["k"] for r in rows] == [int(a) for a in argv[argv.index("--ks") + 1:
                                                                argv.index("--trials")]]
        for r in rows:
            assert set(r) == {"n", "k", "msec", "queries_per_sec"}
            assert r["msec"] > 0 and r["queries_per_sec"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            kdtree_benchmark.main(["--sizes", "256"])
