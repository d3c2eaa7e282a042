"""Scale-out registration of the port (``parallel/sharding.py``,
``align_fleet_sharded``, ``BatchOdometry(mesh=)``) on two gloo ranks on the
CPU, against the JAX package's sharded runs of the same names on
``make_mesh(2)`` of the conftest's 8 CPU devices and against the port's
unsharded calls.

The ranks are two fresh interpreters (``multihost.run_ranks``) that import
torch and the port only, meet through a file store under the test's
temporary directory, run every sharded mode once and save what each
returned; the JAX oracles run here, at ``tests/test_parallel.py``'s shapes.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.models.odometry import OdometryParams as JOdometryParams
from small_gicp_tpu.models.odometry_scan import BatchOdometry as JBatchOdometry
from small_gicp_tpu.parallel.fleet import align_fleet_sharded as j_align_fleet_sharded
from small_gicp_tpu.parallel.sharding import (
    align_batch as j_align_batch,
    align_point_sharded as j_align_point_sharded,
    make_mesh as j_make_mesh,
    stack_clouds as j_stack_clouds,
)
from small_gicp_tpu.point_cloud import PointCloud as JCloud
from small_gicp_tpu.utils.lie import se3_exp as j_se3_exp
from small_gicp_tpu_torch.models.odometry import OdometryParams
from small_gicp_tpu_torch.models.odometry_scan import BatchOdometry
from small_gicp_tpu_torch.models.registration import align_impl
from small_gicp_tpu_torch.parallel.fleet import align_fleet
from small_gicp_tpu_torch.parallel.multihost import run_ranks
from small_gicp_tpu_torch.parallel.sharding import align_batch, stack_clouds
from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.utils.lie import se3_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
FIELDS = ("T_target_source", "converged", "iterations", "num_inliers", "H", "b", "error")
ODOM = dict(max_scan_points=1024, max_downsampled=1024, map_capacity=2048,
            downsampling_resolution=0.4)

# One rank: every sharded mode on the same global inputs, and the errors the
# sizes that do not divide raise.
WORKER = r"""
import sys

import numpy as np
import torch

rank, world, store, data, out = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
from small_gicp_tpu_torch.models.odometry import OdometryParams
from small_gicp_tpu_torch.models.odometry_scan import BatchOdometry
from small_gicp_tpu_torch.parallel import multihost
from small_gicp_tpu_torch.parallel.fleet import align_fleet_sharded
from small_gicp_tpu_torch.parallel.sharding import (
    align_batch, align_point_sharded, make_mesh, stack_clouds)
from small_gicp_tpu_torch.point_cloud import PointCloud

multihost.initialize(f"file://{store}", world, rank, device="cpu")
mesh = make_mesh(device="cpu")
d = dict(np.load(data))
covs = torch.as_tensor(d["covs"])


def cloud(pts):
    return PointCloud.from_points(pts, device="cpu").replace(covs=covs[:len(pts)])


def fields(res):  # copies: a result's tensors are views of one record
    return {k: v.clone() for k, v in vars(res).items()}


targets = stack_clouds([cloud(p) for p in d["targets"]])
sources = stack_clouds([cloud(p) for p in d["sources"]])
got = {}
got["batch"] = fields(align_batch(targets, sources, d["init"], mesh=mesh,
                                registration_type="gicp"))
got["point"] = fields(align_point_sharded(cloud(d["p_target"]), cloud(d["p_source"]),
                                        torch.eye(4), mesh, registration_type="gicp"))
got["fleet"] = fields(align_fleet_sharded(
    stack_clouds([cloud(d["targets"][0])]), stack_clouds([cloud(d["sources"][0])]),
    d["fleet_init"], mesh, num_lanes_per_device=2))
params = OdometryParams(max_scan_points=1024, max_downsampled=1024, map_capacity=2048,
                        downsampling_resolution=0.4)
seqs = [list(lane) for lane in d["odom"]]
got["odometry"] = BatchOdometry(len(seqs), params, mesh=mesh, device="cpu").feed(seqs)

errors = {}
for name, call in {
    "batch": lambda: align_batch(stack_clouds([cloud(p) for p in d["targets"][:3]]),
                                 stack_clouds([cloud(p) for p in d["sources"][:3]]),
                                 d["init"][:3], mesh=mesh),
    "point": lambda: align_point_sharded(
        cloud(d["p_target"]), cloud(d["p_source"]).with_capacity(1023), torch.eye(4), mesh),
    "fleet": lambda: align_fleet_sharded(
        stack_clouds([cloud(d["targets"][0])]), stack_clouds([cloud(d["sources"][0])]),
        d["fleet_init"][:3], mesh),
    "odometry": lambda: BatchOdometry(3, params, mesh=mesh, device="cpu"),
}.items():
    try:
        call()
    except ValueError as e:
        errors[name] = str(e)
got["errors"] = errors
torch.save(got, out)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "jax imported"
print(f"rank {rank} of {world}: done")
"""


def _surface(rng, n):
    pts = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    pts[:, 2] = np.sin(pts[:, 0] * 0.5) + 0.3 * np.cos(pts[:, 1] * 0.7)
    return pts


def _pair(rng, n, twist_scale=0.05):
    """``tests/test_parallel.py``'s pair: a surface and its rigid motion."""
    pts = _surface(rng, n)
    tw = np.r_[rng.normal(size=3) * 0.02, rng.normal(size=3) * twist_scale]
    T = np.asarray(j_se3_exp(jnp.asarray(tw, jnp.float32)))
    src = (np.c_[pts, np.ones(n)] @ T.T)[:, :3].astype(np.float32)
    return pts, src


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1507)
    pairs = [_pair(rng, 1024) for _ in range(B)]
    p_target, p_source = _pair(rng, 2048)
    base = rng.uniform(-6, 6, size=(900, 3)).astype(np.float32)
    base[:, 2] = 0.3 * np.sin(base[:, 0]) + 0.2 * np.cos(base[:, 1])
    odom = np.stack([np.stack([base - [0.08 * f * (1 + 0.1 * b), 0, 0] for f in range(3)])
                     for b in range(4)]).astype(np.float32)
    fleet_init = np.stack([np.asarray(se3_exp(torch.as_tensor(t)))
                           for t in np.c_[rng.normal(size=(B, 3)) * 0.01,
                                          rng.normal(size=(B, 3)) * 0.05]
                           .astype(np.float32)])
    return {
        "targets": np.stack([p[0] for p in pairs]),
        "sources": np.stack([p[1] for p in pairs]),
        "init": np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy(),
        "covs": np.broadcast_to(np.eye(3, dtype=np.float32) * 0.01, (2048, 3, 3)).copy(),
        "p_target": p_target, "p_source": p_source, "odom": odom,
        "fleet_init": fleet_init,
    }


def _cloud(d, pts):
    return PointCloud.from_points(pts, device="cpu").replace(
        covs=torch.as_tensor(d["covs"][:len(pts)]))


def _jcloud(d, pts):
    return JCloud.from_points(pts).replace(covs=jnp.asarray(d["covs"][:len(pts)]))


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    np.savez(tmp / "data.npz", **data)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    runs = run_ranks(lambda r: [sys.executable, "-c", WORKER, str(r), "2",
                                str(tmp / "store"), str(tmp / "data.npz"),
                                str(tmp / f"rank{r}.pt")], 2, timeout=150, env=env)
    for r, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def unsharded_batch(data):
    targets = stack_clouds([_cloud(data, p) for p in data["targets"]])
    sources = stack_clouds([_cloud(data, p) for p in data["sources"]])
    return align_batch(targets, sources, data["init"], registration_type="gicp")


def test_align_batch_matches_jax_and_single(data, unsharded_batch):
    """``align_batch`` without a mesh against the JAX package's on two of its
    CPU devices and against the port's ``align_impl`` pair by pair: poses
    within 1e-5, iterations equal (``tests/test_parallel.py:42-87``)."""
    jres = j_align_batch(
        j_stack_clouds([_jcloud(data, p) for p in data["targets"]]),
        j_stack_clouds([_jcloud(data, p) for p in data["sources"]]),
        jnp.asarray(data["init"]), mesh=j_make_mesh(2), registration_type="gicp")
    res = unsharded_batch
    assert res.T_target_source.shape == (B, 4, 4)
    np.testing.assert_allclose(res.T_target_source.numpy(),
                               np.asarray(jres.T_target_source), atol=1e-5)
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(jres.iterations))
    for i in range(B):
        single = align_impl(_cloud(data, data["targets"][i]),
                            _cloud(data, data["sources"][i]), None, torch.eye(4),
                            registration_type="gicp")
        np.testing.assert_allclose(res.T_target_source[i].numpy(),
                                   single.T_target_source.numpy(), atol=1e-5)
        assert int(res.iterations[i]) == int(single.iterations)


def test_ranks_return_the_same_results(ranks):
    """SPMD: both ranks hold the same global result of every mode."""
    for mode in ("batch", "point", "fleet"):
        for f in FIELDS:
            assert torch.equal(ranks[0][mode][f], ranks[1][mode][f]), (mode, f)
    np.testing.assert_array_equal(ranks[0]["odometry"], ranks[1]["odometry"])


def test_align_batch_two_ranks(ranks, unsharded_batch):
    """Two ranks of four pairs each return the unsharded batch bit for bit."""
    for f in FIELDS:
        assert torch.equal(ranks[0]["batch"][f], getattr(unsharded_batch, f)), f


def test_align_point_sharded_two_ranks(data, ranks):
    """The source rows split over two ranks, sums and trial errors all-reduced:
    the JAX package's point-sharded align on two devices and the port's
    unsharded unfused align, poses within 1e-5, inliers equal."""
    got = ranks[0]["point"]
    jres = j_align_point_sharded(
        _jcloud(data, data["p_target"]), _jcloud(data, data["p_source"]),
        jnp.eye(4, dtype=jnp.float32), j_make_mesh(2), registration_type="gicp")
    single = align_impl(_cloud(data, data["p_target"]), _cloud(data, data["p_source"]),
                        None, torch.eye(4), registration_type="gicp", use_fused="never")
    for ref_T, ref_inl in ((np.asarray(jres.T_target_source), int(jres.num_inliers)),
                           (single.T_target_source.numpy(), int(single.num_inliers))):
        np.testing.assert_allclose(got["T_target_source"].numpy(), ref_T, atol=1e-5)
        assert int(got["num_inliers"]) == ref_inl
    assert int(got["num_inliers"]) > 1900


def test_align_fleet_sharded_two_ranks(data, ranks):
    """Four problems a rank, two lanes each: every row equals ``align_fleet``'s
    over the whole queue, at two lanes and at four, and the JAX package's
    ``align_fleet_sharded`` on two devices, two lanes each: poses within
    1e-5, convergence, iterations and inliers equal."""
    got = ranks[0]["fleet"]
    for lanes in (2, 4):
        ref = align_fleet(stack_clouds([_cloud(data, data["targets"][0])]),
                          stack_clouds([_cloud(data, data["sources"][0])]),
                          data["fleet_init"], num_lanes=lanes)
        for f in FIELDS:
            assert torch.equal(got[f], getattr(ref, f)), (lanes, f)
    assert bool(got["converged"].all())
    jres = j_align_fleet_sharded(
        j_stack_clouds([_jcloud(data, data["targets"][0])]),
        j_stack_clouds([_jcloud(data, data["sources"][0])]),
        jnp.asarray(data["fleet_init"]), j_make_mesh(2), num_lanes_per_device=2)
    np.testing.assert_allclose(got["T_target_source"].numpy(),
                               np.asarray(jres.T_target_source), atol=1e-5)
    for f in ("converged", "iterations", "num_inliers"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(getattr(jres, f)), f)


def test_batch_odometry_two_ranks(data, ranks):
    """Four lanes, two a rank: the unsharded batch bit for bit (lanes never
    interact), and the JAX package's ``BatchOdometry(mesh=)`` on two devices
    within 1e-3 a pose entry, the port's tolerance against the JAX batch."""
    seqs = [list(lane) for lane in data["odom"]]
    ref = BatchOdometry(len(seqs), OdometryParams(**ODOM), device="cpu").feed(seqs)
    got = ranks[0]["odometry"]
    assert got.shape == ref.shape == (4, 3, 4, 4)
    np.testing.assert_array_equal(got, ref)
    j_poses = JBatchOdometry(len(seqs), JOdometryParams(**ODOM),
                             mesh=j_make_mesh(2)).feed(seqs)
    np.testing.assert_allclose(got, j_poses, atol=1e-3)


def test_sizes_that_do_not_divide_raise(ranks):
    """The JAX package's messages: batch, source capacity, problems, lanes."""
    errors = ranks[0]["errors"]
    assert set(errors) == {"batch", "point", "fleet", "odometry"}
    assert "batch size 3 must be a multiple of the mesh size 2" in errors["batch"]
    assert "source capacity 1023 must be a multiple of the mesh size 2" in errors["point"]
    assert "P=3 problems must divide evenly over 2 devices" in errors["fleet"]
    assert "num_lanes=3 must be a multiple of the mesh size 2" in errors["odometry"]
