"""Map-block sharding: a voxel map's slots split over a mesh.

Counterpart of ``small_gicp_tpu/parallel/map_sharding.py``, for maps too
large for one card. Each rank keeps one contiguous block of the slots (and,
for the incremental map, their payload rows) with a directory of its own
slots' keys, built when the map is sharded; the scalars stay replicated. A
query set, replicated, is searched on every rank by the port's own voxel
search (``models/voxelmap.py``) against the local block, and the ranks'
winners are combined by two ``MIN`` all-reduces over [Q] — the d², then the
global index among the ranks that hold it, so ties go to the lower global
slot — and, for registration, one masked ``SUM`` of the [Q,12] winner
payload: the winner is unique, so the sum is its row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist

from small_gicp_tpu_torch.models.voxelmap import (
    _FAR,
    _IMAX,
    GaussianVoxelMap,
    IncrementalVoxelMap,
    _directory,
    _gvm_nn,
    _ivm_knn,
)
from small_gicp_tpu_torch.parallel.multihost import block, mesh_group


def _slot_block(v: int, mesh) -> Tuple[slice, int]:
    _, rank, size = mesh_group(mesh)
    if v % size:
        raise ValueError(f"voxel capacity {v} must be a multiple of the mesh size {size}")
    return block(v, rank, size), v // size


def shard_gaussian_voxelmap(vm: GaussianVoxelMap, mesh) -> GaussianVoxelMap:
    """This rank's block of a ``GaussianVoxelMap``'s slots (copies, so the
    full map can be dropped), with a directory over the block's keys
    (local slot values) and the scalars replicated."""
    sl, local_v = _slot_block(vm.capacity, mesh)
    keys = vm.vox_keys[sl].clone()
    slots = torch.arange(local_v, dtype=torch.int32, device=keys.device)
    dk, dv = _directory(keys, slots)
    return vm.replace(dir_keys=dk, dir_vals=dv, vox_keys=keys,
                      payload=vm.payload[sl].clone(), lru=vm.lru[sl].clone())


def shard_incremental_voxelmap(vm: IncrementalVoxelMap, mesh) -> IncrementalVoxelMap:
    """This rank's block of an ``IncrementalVoxelMap``'s slots and of their
    payload rows ([V/size · C]), with a directory over the block's keys
    ((local slot << 8) | occupancy) and the scalars replicated."""
    sl, local_v = _slot_block(vm.voxel_capacity, mesh)
    c = vm.cell_capacity
    keys, occ = vm.vox_keys[sl].clone(), vm.occ[sl].clone()
    slots = torch.arange(local_v, dtype=torch.int32, device=keys.device)
    dk, dv = _directory(keys, (slots << 8) | occ)
    rows = slice(sl.start * c, sl.stop * c)
    return vm.replace(dir_keys=dk, dir_vals=dv, vox_keys=keys, occ=occ,
                      stamps=vm.stamps[sl].clone(), payload=vm.payload[rows].clone())


def _combine_across_shards(group, d2: torch.Tensor, idx: torch.Tensor):
    """[Q] local bests → [Q] global bests: the least d², then the least
    global index among the ranks that hold it."""
    gmin = d2.clone()
    dist.all_reduce(gmin, op=dist.ReduceOp.MIN, group=group)
    cand = torch.where(d2 <= gmin, idx, _IMAX).to(torch.int32)
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
    return gmin, cand


def _local_best(vm, query_xyz: torch.Tensor, rank: int):
    """(d² [Q], global index [Q] int32 — _IMAX where nothing was found —,
    local row [Q]) of the block's nearest voxel (Gaussian map: slot) or
    point (incremental map: payload row)."""
    if isinstance(vm, GaussianVoxelMap):
        d2, local, _ = _gvm_nn(vm, query_xyz)
    elif isinstance(vm, IncrementalVoxelMap):
        d, i, _ = _ivm_knn(vm, query_xyz, 1)
        d2, local = d[:, 0], i[:, 0]
    else:
        raise TypeError(f"unsupported sharded map type {type(vm).__name__}")
    gidx = torch.where(d2 < _FAR, local + rank * vm.capacity, _IMAX).to(torch.int32)
    return d2, gidx, local.long()


def _sharded_nn(vm, query_xyz: torch.Tensor, mesh):
    group, rank, _ = mesh_group(mesh)
    bd, bidx, _ = _local_best(vm, query_xyz, rank)
    d2, idx = _combine_across_shards(group, bd, bidx)
    found = d2 < _FAR
    return d2, torch.where(found, idx, 0), found


def sharded_gvm_nn(vm: GaussianVoxelMap, query_xyz: torch.Tensor, mesh):
    """NN over a slot-sharded ``GaussianVoxelMap`` (``vm``: this rank's block
    from ``shard_gaussian_voxelmap``): (sq_dists [Q], GLOBAL slot [Q] int32,
    found [Q]), the single-device ``nearest_neighbor_search``'s result but
    on exact ties (here the lower global slot)."""
    return _sharded_nn(vm, query_xyz, mesh)


def sharded_ivm_nn(vm: IncrementalVoxelMap, query_xyz: torch.Tensor, mesh):
    """NN over a slot-sharded ``IncrementalVoxelMap`` (``vm``: this rank's
    block from ``shard_incremental_voxelmap``): (sq_dists [Q], GLOBAL payload
    row [Q] int32, numbered as on the single device, found [Q])."""
    return _sharded_nn(vm, query_xyz, mesh)


@dataclass
class ShardedVoxelMapTarget:
    """A registration target whose voxel map is sharded over ``mesh``:
    ``align_impl`` searches it through ``sharded_nn_payload`` (``vm``: this
    rank's block). The source and the optimizer stay replicated."""

    vm: object  # GaussianVoxelMap | IncrementalVoxelMap: this rank's block
    mesh: object  # a 1-D DeviceMesh or a process group


def sharded_nn_payload(vm, query_xyz: torch.Tensor, mesh):
    """NN and the winner's payload over a sharded voxel map: (sq_dists [Q],
    found [Q], mu [Q,3], covs [Q,3,3] or None, normals [Q,4] or None). Each
    rank zeroes the rows it does not win, and one SUM all-reduce of the
    [Q, 3 | 9? | 4?] columns gathers the winners'."""
    group, rank, _ = mesh_group(mesh)
    bd, bidx, local = _local_best(vm, query_xyz, rank)
    d2, gidx = _combine_across_shards(group, bd, bidx)
    prow = vm.payload[local]
    if isinstance(vm, GaussianVoxelMap):
        cols, has_covs, has_normals = [prow[:, 0:3], prow[:, 4:13]], True, False
    else:
        has_covs, has_normals = vm.has_covs, vm.has_normals
        cols = [prow[:, 0:3]]
        if has_covs:
            off = 8 if has_normals else 4
            cols.append(prow[:, off:off + 9])
        if has_normals:
            cols.append(prow[:, 4:8])
    win = (bidx == gidx) & (bd < _FAR)
    pay = torch.where(win[:, None], torch.cat(cols, dim=1), 0.0)
    dist.all_reduce(pay, group=group)
    mu, off = pay[:, 0:3], 3
    covs = normals = None
    if has_covs:
        covs, off = pay[:, off:off + 9].reshape(-1, 3, 3), off + 9
    if has_normals:
        normals = pay[:, off:off + 4]
    return d2, d2 < _FAR, mu, covs, normals


def sharded_model_align(vm, source, init_T=None, mesh=None, **kwargs):
    """Register ``source`` against a voxel map sharded over ``mesh``: the
    map (the whole map, on every rank) is cut to this rank's block, wrapped
    as a ``ShardedVoxelMapTarget`` and aligned by ``Registration(**kwargs)``
    ("vgicp" for a Gaussian map, "gicp" for an incremental one by default);
    the result matches the single-device voxel-map align."""
    from small_gicp_tpu_torch.models.registration import Registration

    if mesh is None:
        raise ValueError("sharded_model_align requires a mesh")
    if isinstance(vm, GaussianVoxelMap):
        local = shard_gaussian_voxelmap(vm, mesh)
        kwargs.setdefault("registration_type", "vgicp")
    elif isinstance(vm, IncrementalVoxelMap):
        local = shard_incremental_voxelmap(vm, mesh)
        kwargs.setdefault("registration_type", "gicp")
    else:
        raise TypeError(f"unsupported map type {type(vm).__name__}")
    target = ShardedVoxelMapTarget(vm=local, mesh=mesh)
    return Registration(**kwargs).align(target, source, None, init_T)
