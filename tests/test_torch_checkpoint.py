"""The port's checkpoints (``utils/checkpoint.py``) against the JAX package's
on the CPU.

The frames and parameters are ``tests/test_torch_odometry.py``'s (frames of
2,500 points 0.15 m apart, 4,096-row capacities, a map of 8,192 rows, k =
10, 0.3 m / 1.0 m); the chunked engine's are
``tests/test_checkpoint_metrics.py``'s. A resumed run equals the continuous
one bit for bit (``np.array_equal`` on poses, ``torch.equal`` on every map
tensor); files cross between the packages with equal leaves, and the
port's engine resumed from a JAX checkpoint stays within the odometry
parity tolerance (``atol=1e-3`` a pose entry) of the JAX engine resumed
from the same file.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from small_gicp_tpu.models.odometry import (
    OdometryParams as JParams,
    create_odometry as j_create,
)
from small_gicp_tpu.models.voxelmap import GaussianVoxelMap as JGVM
from small_gicp_tpu.utils import checkpoint as j_ckpt
from small_gicp_tpu_torch.models.odometry import OdometryParams, create_odometry
from small_gicp_tpu_torch.models.odometry_scan import JitOdometry
from small_gicp_tpu_torch.models.voxelmap import GaussianVoxelMap, IncrementalVoxelMapCov
from small_gicp_tpu_torch.utils.checkpoint import (
    load_odometry_state,
    load_pytree,
    save_odometry_state,
    save_pytree,
)
from tests.test_torch_odometry import J_PARAMS, PARAMS, _make_frames


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tensors(obj):
    """The tensor fields of a dataclass, by name."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


def _same_tensors(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for name in ta:
        assert torch.equal(ta[name], tb[name]), name


def test_pytree_roundtrip_and_static_fields(tmp_path):
    vm = IncrementalVoxelMapCov(1.0, 256, voxel_capacity=64, device="cpu")
    tree = {"map": vm, "poses": [torch.eye(4), np.arange(3.0)], "pair": (torch.ones(2),)}
    path = str(tmp_path / "tree.npz")
    save_pytree(path, tree)
    template = {"map": IncrementalVoxelMapCov(1.0, 256, voxel_capacity=64, device="cpu"),
                "poses": [torch.zeros(4, 4), np.zeros(3)], "pair": (torch.zeros(2),)}
    back = load_pytree(path, template)
    _same_tensors(back["map"], vm)
    assert back["map"].has_covs and back["map"].cell_capacity == vm.cell_capacity
    assert torch.equal(back["poses"][0], torch.eye(4))
    assert isinstance(back["poses"][1], np.ndarray)
    assert np.array_equal(back["poses"][1], np.arange(3.0))
    assert isinstance(back["pair"], tuple) and torch.equal(back["pair"][0], torch.ones(2))
    with np.load(path) as data:
        assert int(data["__schema_version__"]) == 2
        assert list(data["__keypaths__"])[:2] == ["map/dir_keys", "map/dir_vals"]


def test_wrong_capacity_and_names_raise(tmp_path):
    path = str(tmp_path / "vm.npz")
    save_pytree(path, GaussianVoxelMap.empty(1.0, capacity=128, device="cpu"))
    with pytest.raises(ValueError, match="dir_keys"):
        load_pytree(path, GaussianVoxelMap.empty(1.0, capacity=64, device="cpu"))
    save_pytree(path, {"a": torch.zeros(2), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match=r"not checkpoint: \['c'\]"):
        load_pytree(path, {"a": torch.zeros(2), "c": torch.zeros(2)})


def test_v1_checkpoint_loads_with_a_warning(tmp_path):
    path = str(tmp_path / "v1.npz")
    np.savez(path, leaf_0=np.eye(4, dtype=np.float32), leaf_1=np.arange(3, dtype=np.int32))
    with pytest.warns(UserWarning, match="v1 checkpoint"):
        back = load_pytree(path, (torch.zeros(4, 4), torch.zeros(3, dtype=torch.int32)))
    assert torch.equal(back[0], torch.eye(4))
    with pytest.raises(ValueError, match="leaf 1"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        load_pytree(path, (torch.zeros(4, 4), torch.zeros(3)))


@pytest.mark.parametrize("engine", ["small_gicp_model", "small_gicp"])
def test_streaming_resume_equals_continuous(tmp_path, engine):
    frames, _ = _make_frames(n_frames=4)
    full = create_odometry(engine, PARAMS, device="cpu")
    poses_full = full.estimate(frames)
    a = create_odometry(engine, PARAMS, device="cpu")
    a.estimate(frames[:2])
    path = str(tmp_path / "odo.npz")
    save_odometry_state(path, a)
    b = create_odometry(engine, PARAMS, device="cpu")
    if engine == "small_gicp":  # the previous cloud is part of the template
        b.estimate(frames[:1])
    load_odometry_state(path, b)
    b.estimate(frames[2:])
    assert np.array_equal(np.stack(b.traj), poses_full)
    assert torch.equal(b.T_world, full.T_world)
    if hasattr(full, "voxelmap"):
        _same_tensors(b.voxelmap, full.voxelmap)
        assert torch.equal(b.T_delta, full.T_delta) and b._first is False
    else:
        _same_tensors(b._prev, full._prev)
    small = create_odometry(engine, dataclasses.replace(PARAMS, map_capacity=4096,
                                                        max_downsampled=2048),
                            device="cpu")
    if engine == "small_gicp":
        small.estimate(frames[:1])
    with pytest.raises(ValueError, match="voxelmap/" if hasattr(full, "voxelmap")
                       else "prev/"):
        load_odometry_state(path, small)


def test_jit_carry_resume_equals_continuous(tmp_path):
    rng = np.random.default_rng(5)
    base = rng.uniform(-8, 8, size=(1500, 3))
    base[:, 2] = 0.3 * np.sin(base[:, 0])
    frames = [(base - [0.15 * i, 0, 0]).astype(np.float32) for i in range(4)]
    P = OdometryParams(max_scan_points=2048, max_downsampled=2048, map_capacity=4096,
                       downsampling_resolution=0.4)
    full = JitOdometry(P, chunk_frames=2, device="cpu").feed(frames)
    a = JitOdometry(P, chunk_frames=2, device="cpu")
    a.feed(frames[:2])
    path = str(tmp_path / "carry.npz")
    save_pytree(path, a.carry)
    b = JitOdometry(P, chunk_frames=2, device="cpu")
    b.carry = load_pytree(path, b.carry)
    assert np.array_equal(b.feed(frames[2:]), full[2:])


def test_jax_checkpoints_load_into_the_port_and_back(tmp_path):
    frames, _ = _make_frames()
    # A JAX-written Gaussian voxel map, into the port's and back.
    path = str(tmp_path / "gvm.npz")
    j_ckpt.save_pytree(path, JGVM.empty(1.0, capacity=128))
    vm = load_pytree(path, GaussianVoxelMap.empty(1.0, capacity=128, device="cpu"))
    back_path = str(tmp_path / "gvm_back.npz")
    save_pytree(back_path, vm)
    j_vm = j_ckpt.load_pytree(back_path, JGVM.empty(1.0, capacity=128))
    for name, t in _tensors(vm).items():
        assert np.array_equal(np.asarray(getattr(j_vm, name)), t.numpy()), name

    # Engine state: JAX runs 3 frames and saves; both packages resume from it.
    j_a = j_create("small_gicp_model", J_PARAMS)
    j_a.estimate(frames[:3])
    j_path = str(tmp_path / "j_odo.npz")
    j_ckpt.save_odometry_state(j_path, j_a)
    j_b = j_create("small_gicp_model", J_PARAMS)
    j_ckpt.load_odometry_state(j_path, j_b)
    j_tail = j_b.estimate(frames[3:])

    t_b = create_odometry("small_gicp_model", PARAMS, device="cpu")
    load_odometry_state(j_path, t_b)
    for name, t in _tensors(t_b.voxelmap).items():
        assert np.array_equal(np.asarray(getattr(j_a.voxelmap, name)), t.numpy()), name
    assert np.array_equal(t_b.T_world.numpy(), np.asarray(j_a.T_world))
    t_tail = t_b.estimate(frames[3:])
    np.testing.assert_allclose(t_tail, j_tail, atol=1e-3)

    # The port's state back into a JAX engine: equal leaves.
    t_path = str(tmp_path / "t_odo.npz")
    save_odometry_state(t_path, t_b)
    j_c = j_create("small_gicp_model", J_PARAMS)
    j_ckpt.load_odometry_state(t_path, j_c)
    for name, t in _tensors(t_b.voxelmap).items():
        assert np.array_equal(np.asarray(getattr(j_c.voxelmap, name)), t.numpy()), name
    assert np.array_equal(np.stack(j_c.traj), np.stack(t_b.traj))
