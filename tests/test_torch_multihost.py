"""Process groups and meshes of the port (``parallel/multihost.py``) and
the ``pod_scaling`` app, against the JAX package's single-process
behaviour (``tests/test_multihost.py``).

The multi-process cases start fresh interpreters (``multihost.run_ranks``)
that import torch and the port only and meet through a file store under the
test's temporary directory, as gloo ranks on the CPU.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch.distributed as dist

from small_gicp_tpu.parallel import multihost as j_multihost
from small_gicp_tpu_torch.parallel import multihost
from small_gicp_tpu_torch.parallel.multihost import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One torch thread a rank: the suite runs beside these processes.
ENV = {**os.environ, "OMP_NUM_THREADS": "1",
       "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}

# One rank: the group, both meshes, and the normal-equation reduction of
# tests/test_multihost.py's worker over them.
WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from small_gicp_tpu_torch.parallel import multihost
from small_gicp_tpu_torch.parallel.sharding import make_mesh

multihost.initialize(f"file://{store}", world, rank, device="cpu")
multihost.initialize(f"file://{store}", world, rank, device="cpu")  # a second call: no-op
assert multihost.process_info() == (rank, world, 1), multihost.process_info()
mesh = multihost.global_mesh("data", device="cpu")
assert mesh.size() == world and mesh.mesh_dim_names == ("data",)
assert make_mesh(device="cpu").size() == make_mesh(world, device="cpu").size() == world
try:
    make_mesh(world + 1, device="cpu")
    raise AssertionError("make_mesh took more devices than ranks")
except ValueError as e:
    assert "world size" in str(e), e
m2 = multihost.global_mesh_2d(("host", "chip"), device="cpu")
assert tuple(m2.mesh.shape) == (1, world) and m2.mesh_dim_names == ("host", "chip")
group, r, size = multihost.mesh_group(mesh)
assert (r, size) == (rank, world)

n = 1024
full = np.arange(n * 6, dtype=np.float64).reshape(n, 6) / (n * 6.0)
x = torch.as_tensor(full[multihost.block(n, rank, world)])
sums = torch.cat([(x.T @ x).reshape(36), x.sum(0), (x * x).sum().reshape(1)])
dist.all_reduce(sums, group=group)
assert np.allclose(sums[:36].numpy().reshape(6, 6), full.T @ full, atol=1e-9)
assert np.allclose(sums[36:42].numpy(), full.sum(0), atol=1e-9)
assert abs(float(sums[42]) - float((full * full).sum())) < 1e-9
rows = multihost.all_gather_rows(torch.tensor([rank, rank], dtype=torch.int32)[None], group,
                                 world)
assert rows.tolist() == [[k, k] for k in range(world)], rows
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "jax imported"
print(f"rank {rank}: psum over {world} processes OK", flush=True)
dist.destroy_process_group()
"""


def test_initialize_noop_single_process(monkeypatch):
    """Without torchrun's environment or arguments nothing is brought up,
    as the JAX package's ``initialize`` does nothing in a single process."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    j_multihost.initialize()
    multihost.initialize()
    assert not dist.is_initialized()
    assert multihost.process_info() == (0, 1, 1)
    assert j_multihost.process_info()[:2] == (0, 1)
    with pytest.raises(RuntimeError, match="not initialized"):
        multihost.global_mesh(device="cpu")
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize("file:///nowhere/store", 2, device="cpu")
    with pytest.raises(TypeError, match="1-D DeviceMesh or a process group"):
        multihost.mesh_group("data")


def test_blocks_split_as_partition_specs():
    """Contiguous equal blocks in rank order, as ``P("data")`` splits."""
    got = [np.arange(12)[multihost.block(12, r, 3)] for r in range(3)]
    assert [g.tolist() for g in got] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]


def test_global_mesh_over_two_ranks(tmp_path):
    """Two processes form one gloo group and a two-rank mesh, and reduce the
    (H, b, e) normal equations across it (``tests/test_multihost.py``)."""
    runs = run_ranks(lambda r: [sys.executable, "-c", WORKER, str(r), "2",
                                str(tmp_path / "store")], 2, timeout=120, env=ENV)
    for r, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-4000:]}"
        assert "psum over 2 processes OK" in out, out


def _pod_scaling(rank, *extra):
    return [sys.executable, "-m", "small_gicp_tpu_torch.apps.pod_scaling", "--device",
            "cpu", "--points", "256", "--problems-per-device", "1", "--reps", "1",
            *extra]


def test_two_process_pod_scaling(tmp_path):
    """``pod_scaling`` in two gloo processes: rank 0 prints one JSON line for
    each of the three modes, over two ranks, and saves the baseline."""
    base = tmp_path / "base.json"
    runs = run_ranks(lambda r: _pod_scaling(
        r, "--coordinator", f"file://{tmp_path}/store", "--num-processes", "2",
        "--process-id", str(r), "--save-baseline", str(base)), 2, timeout=150, env=ENV)
    for r, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-4000:]}"
    recs = {rec["mode"]: rec for rec in map(json.loads, (
        line for line in runs[0][1].splitlines() if line.startswith("{")))}
    assert set(recs) == {"batch", "point", "fleet"}, runs[0][1]
    for rec in recs.values():
        assert rec["devices"] == 2 and rec["processes"] == 2 and rec["device"] == "cpu"
        assert rec["throughput"] > 0
    assert recs["point"]["units"] == 512 and recs["batch"]["units"] == 2
    assert not any(line.startswith("{") for line in runs[1][1].splitlines())
    assert set(json.loads(base.read_text())) == {"batch", "point", "fleet"}


def test_pod_scaling_single_rank(tmp_path):
    """Without torchrun it runs as one rank, and reads a baseline back."""
    (tmp_path / "base.json").write_text(json.dumps({"batch": 1.0}))
    [(rc, out)] = run_ranks(lambda r: _pod_scaling(
        r, "--modes", "batch", "--baseline-json", str(tmp_path / "base.json")), 1,
        timeout=120, env=ENV)
    assert rc == 0, out
    [rec] = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert rec["mode"] == "batch" and rec["devices"] == 1 and rec["efficiency"] > 0


def test_scaling_benchmark_curve():
    """``scaling_benchmark`` over mesh sizes 1 and 2 of gloo ranks on the CPU:
    one JSON line with every mode at both sizes and the unsharded calls."""
    [(rc, out)] = run_ranks(lambda r: [
        sys.executable, "-m", "small_gicp_tpu_torch.apps.scaling_benchmark", "--device",
        "cpu", "--devices", "2", "--points", "256", "--reps", "1"], 1, timeout=150,
        env=ENV)
    assert rc == 0, out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["points"] == 256 and rec["device"] == "cpu"
    ms = rec["ms_by_devices"]
    for mode in ("floor_ms_per_collective", "batch_dp", "point_sp", "sharded_map"):
        assert set(ms[mode]) == {"1", "2"} and min(ms[mode].values()) > 0, mode
    assert set(ms["unsharded"]) == {"batch_dp", "point_sp", "sharded_map"}
