"""Map-block sharding of the port (``parallel/map_sharding.py``) on two gloo
ranks on the CPU: the sharded voxel searches against the port's unsharded
ones and the JAX package's sharded ones on ``make_mesh(2)`` of the
conftest's 8 CPU devices, at ``tests/test_map_sharding.py``'s shapes, and
``sharded_model_align`` against the single-device voxel-map align and the
JAX package's ``sharded_model_align``.

The ranks are two fresh interpreters (``multihost.run_ranks``) that import
torch and the port only and meet through a file store under the test's
temporary directory; they build the maps from the same points as this
process.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_gicp_tpu.models.voxelmap import (
    GaussianVoxelMap as JGaussianVoxelMap,
    IncrementalVoxelMap as JIncrementalVoxelMap,
)
from small_gicp_tpu.parallel.map_sharding import (
    shard_gaussian_voxelmap as j_shard_gvm,
    shard_incremental_voxelmap as j_shard_ivm,
    sharded_gvm_nn as j_sharded_gvm_nn,
    sharded_ivm_nn as j_sharded_ivm_nn,
    sharded_model_align as j_sharded_model_align,
)
from small_gicp_tpu.parallel.sharding import make_mesh as j_make_mesh
from small_gicp_tpu.point_cloud import PointCloud as JCloud
from small_gicp_tpu.utils.lie import se3_exp as j_se3_exp
from small_gicp_tpu_torch.models.registration import Registration
from small_gicp_tpu_torch.models.voxelmap import GaussianVoxelMap, IncrementalVoxelMap
from small_gicp_tpu_torch.parallel.multihost import run_ranks
from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.utils.lie import se3_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIST = [0.01, -0.02, 0.015, 0.05, -0.08, 0.04]

# One rank: the maps of tests/test_map_sharding.py, sharded, searched and
# registered against.
WORKER = r"""
import sys

import numpy as np
import torch

rank, world, store, data, out = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
from small_gicp_tpu_torch.models.voxelmap import GaussianVoxelMap, IncrementalVoxelMap
from small_gicp_tpu_torch.parallel import multihost
from small_gicp_tpu_torch.parallel.map_sharding import (
    shard_gaussian_voxelmap, shard_incremental_voxelmap, sharded_gvm_nn,
    sharded_ivm_nn, sharded_model_align, sharded_nn_payload)
from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.utils.lie import se3_exp

multihost.initialize(f"file://{store}", world, rank, device="cpu")
mesh = multihost.global_mesh(device="cpu")
d = {k: torch.as_tensor(v) for k, v in np.load(data).items()}


def cloud(pts):
    covs = torch.eye(3).expand(len(pts), 3, 3) * 0.01
    return PointCloud.from_points(pts, device="cpu").replace(covs=covs.contiguous())


got = {}
gvm = GaussianVoxelMap.build(cloud(d["gvm_pts"]), 1.0, capacity=8192)
g_local = shard_gaussian_voxelmap(gvm, mesh)
got["gvm_nn"] = sharded_gvm_nn(g_local, d["gvm_q"], mesh)
got["gvm_payload"] = sharded_nn_payload(g_local, d["gvm_q"], mesh)
got["gvm_block"] = (g_local.capacity, g_local.payload.shape[0])
ivm = IncrementalVoxelMap.empty(1.0, capacity=8192, num_offsets=7, device="cpu").insert(
    cloud(d["ivm_pts"]))
i_local = shard_incremental_voxelmap(ivm, mesh)
got["ivm_nn"] = sharded_ivm_nn(i_local, d["ivm_q"], mesh)
got["ivm_block"] = (i_local.voxel_capacity, i_local.payload.shape[0])

T0 = se3_exp(d["twist"])
source = cloud(d["src_pts"])
map_cloud = cloud(d["map_pts"])
gvm = GaussianVoxelMap.build(map_cloud, 1.0, capacity=4096)
ivm = IncrementalVoxelMap.empty(1.0, capacity=8192, has_covs=True, device="cpu").insert(
    map_cloud)
for name, vm in (("align_gvm", gvm), ("align_ivm", ivm)):
    got[name] = {k: v.clone() for k, v in vars(sharded_model_align(vm, source, T0,
                                                                    mesh)).items()}
torch.save(got, out)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "jax imported"
print(f"rank {rank} of {world}: done")
"""


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2015)
    gvm_pts = rng.uniform(-20, 20, size=(4000, 3)).astype(np.float32)
    ivm_pts = rng.uniform(-20, 20, size=(3000, 3)).astype(np.float32)
    map_pts = rng.uniform(-10, 10, size=(4000, 3)).astype(np.float32)
    return {
        "gvm_pts": gvm_pts,
        "gvm_q": (gvm_pts[:1024] + rng.normal(scale=0.1, size=(1024, 3))).astype(np.float32),
        "ivm_pts": ivm_pts,
        "ivm_q": (ivm_pts[:512] + rng.normal(scale=0.05, size=(512, 3))).astype(np.float32),
        "map_pts": map_pts,
        "src_pts": (map_pts[:2000] + rng.normal(scale=0.02, size=(2000, 3))).astype(
            np.float32),
        "twist": np.asarray(TWIST, np.float32),
    }


def _cloud(pts):
    covs = torch.eye(3).expand(len(pts), 3, 3) * 0.01
    return PointCloud.from_points(pts, device="cpu").replace(covs=covs.contiguous())


def _jcloud(pts):
    covs = np.broadcast_to(np.eye(3, dtype=np.float32) * 0.01, (len(pts), 3, 3))
    return JCloud.from_points(pts).replace(covs=jnp.asarray(covs))


@pytest.fixture(scope="module")
def maps(data):
    gvm = GaussianVoxelMap.build(_cloud(data["gvm_pts"]), 1.0, capacity=8192)
    ivm = IncrementalVoxelMap.empty(1.0, capacity=8192, num_offsets=7,
                                    device="cpu").insert(_cloud(data["ivm_pts"]))
    return gvm, ivm


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("map_sharding")
    np.savez(tmp / "data.npz", **data)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    runs = run_ranks(lambda r: [sys.executable, "-c", WORKER, str(r), "2",
                                str(tmp / "store"), str(tmp / "data.npz"),
                                str(tmp / f"rank{r}.pt")], 2, timeout=150, env=env)
    for r, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _same_but_ties(idx, ref_idx, d2, q, rows_of):
    """Indices equal, or else both rows at the query's d² (an exact tie)."""
    diff = torch.nonzero(idx != ref_idx).flatten()
    for i in diff.tolist():
        a, b = rows_of(idx[i]), rows_of(ref_idx[i])
        da = ((a - q[i]) ** 2).sum()
        db = ((b - q[i]) ** 2).sum()
        assert float(da) == float(db) == float(d2[i]), (i, float(da), float(db))
    return len(diff)


def test_sharded_gvm_nn_two_ranks(data, maps, ranks):
    """d² and found bit for bit the unsharded search's, slots equal but on
    exact ties; both ranks hold the same result and half the slots each."""
    gvm, _ = maps
    q = torch.as_tensor(data["gvm_q"])
    d_ref, i_ref, f_ref = gvm.nearest_neighbor_search(q)
    d, i, f = ranks[0]["gvm_nn"]
    assert torch.equal(f, f_ref) and float(f.float().mean()) > 0.5
    assert torch.equal(d, d_ref)
    _same_but_ties(i[f], i_ref[f], d[f], q[f], lambda s: gvm.payload[int(s), :3])
    for a, b in zip(ranks[0]["gvm_nn"], ranks[1]["gvm_nn"]):
        assert torch.equal(a, b)
    assert ranks[0]["gvm_block"] == (4096, 4096)


def test_sharded_ivm_nn_two_ranks(data, maps, ranks):
    """The incremental map at 7 offsets: d² and found bit for bit, payload
    rows numbered as on one device and equal but on exact ties."""
    _, ivm = maps
    q = torch.as_tensor(data["ivm_q"])
    d_ref, i_ref, f_ref = ivm.nearest_neighbor_search(q)
    d, i, f = ranks[0]["ivm_nn"]
    assert torch.equal(f, f_ref) and float(f.float().mean()) > 0.5
    assert torch.equal(d, d_ref)
    _same_but_ties(i[f], i_ref[f], d[f], q[f], lambda r: ivm.payload[int(r), :3])
    for a, b in zip(ranks[0]["ivm_nn"], ranks[1]["ivm_nn"]):
        assert torch.equal(a, b)
    assert ranks[0]["ivm_block"] == (4096, 4096 * ivm.cell_capacity)


def test_sharded_payload_is_the_winners_row(data, maps, ranks):
    """The masked SUM of the winners' rows gives the unsharded gather's
    means and covariances bit for bit."""
    gvm, _ = maps
    q = torch.as_tensor(data["gvm_q"])
    d_ref, i_ref, f_ref = gvm.nearest_neighbor_search(q)
    d, found, mu, covs, normals = ranks[0]["gvm_payload"]
    assert torch.equal(d, d_ref) and torch.equal(found, f_ref) and normals is None
    rows = gvm.payload[ranks[0]["gvm_nn"][1].long()]
    assert torch.equal(mu[found], rows[found, :3])
    assert torch.equal(covs[found], rows[found, 4:13].reshape(-1, 3, 3))
    assert bool((mu[~found] == 0).all())


def test_sharded_search_matches_jax(data, ranks):
    """The JAX package's sharded searches on two devices: found equal, d²
    within 1e-6 relative, slots equal (``tests/test_map_sharding.py``)."""
    mesh = j_make_mesh(2)
    jg = JGaussianVoxelMap.build(_jcloud(data["gvm_pts"]), 1.0, capacity=8192)
    jd, ji, jf = j_sharded_gvm_nn(j_shard_gvm(jg, mesh), jnp.asarray(data["gvm_q"]), mesh)
    d, i, f = ranks[0]["gvm_nn"]
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    fm = np.asarray(jf)
    np.testing.assert_allclose(d.numpy()[fm], np.asarray(jd)[fm], rtol=1e-6)
    np.testing.assert_array_equal(i.numpy()[fm], np.asarray(ji)[fm])

    ji_vm = JIncrementalVoxelMap.empty(1.0, capacity=8192, num_offsets=7).insert(
        _jcloud(data["ivm_pts"]))
    jd, ji, jf = j_sharded_ivm_nn(j_shard_ivm(ji_vm, mesh), jnp.asarray(data["ivm_q"]), mesh)
    d, i, f = ranks[0]["ivm_nn"]
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    fm = np.asarray(jf)
    np.testing.assert_allclose(d.numpy()[fm], np.asarray(jd)[fm], rtol=1e-6)
    assert (i.numpy()[fm] == np.asarray(ji)[fm]).mean() > 0.999


@pytest.mark.parametrize("kind", ["gvm", "ivm"])
def test_sharded_model_align_two_ranks(data, ranks, kind):
    """VGICP against the Gaussian map and GICP against the incremental map,
    sharded over two ranks: the single-device voxel-map align bit for bit
    (the masked SUM hands every rank the winners' rows exactly), and the
    JAX package's ``sharded_model_align`` on two devices with the pose
    within 1e-5, convergence, iterations and inliers equal."""
    source = _cloud(data["src_pts"])
    map_cloud = _cloud(data["map_pts"])
    T0 = se3_exp(torch.as_tensor(data["twist"]))
    j_map = _jcloud(data["map_pts"])
    if kind == "gvm":
        vm, rtype = GaussianVoxelMap.build(map_cloud, 1.0, capacity=4096), "vgicp"
        j_vm = JGaussianVoxelMap.build(j_map, 1.0, capacity=4096)
    else:
        vm = IncrementalVoxelMap.empty(1.0, capacity=8192, has_covs=True,
                                       device="cpu").insert(map_cloud)
        j_vm = JIncrementalVoxelMap.empty(1.0, capacity=8192, has_covs=True).insert(j_map)
        rtype = "gicp"
    ref = Registration(registration_type=rtype).align(vm, source, None, T0)
    jres = j_sharded_model_align(j_vm, _jcloud(data["src_pts"]),
                                 j_se3_exp(jnp.asarray(data["twist"])), j_make_mesh(2))
    got = ranks[0][f"align_{kind}"]
    for f in ("T_target_source", "converged", "iterations", "num_inliers"):
        assert torch.equal(got[f], getattr(ref, f)), f
    np.testing.assert_allclose(got["T_target_source"].numpy(),
                               np.asarray(jres.T_target_source), atol=1e-5)
    for f in ("converged", "iterations", "num_inliers"):
        assert int(got[f]) == int(getattr(jres, f)), f
    assert int(got["num_inliers"]) > 1500
    for f in got:
        assert torch.equal(got[f], ranks[1][f"align_{kind}"][f]), f
