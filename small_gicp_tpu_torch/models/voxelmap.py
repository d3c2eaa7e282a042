"""Voxel maps: the Gaussian map (VGICP's target) and the incremental
scan-to-model map, in torch.

Counterpart of ``small_gicp_tpu/models/voxelmap.py``, the same slot-table
design: a voxel lives at a fixed slot whose payload rows are updated in
place, and a narrow directory of the occupied keys sorted ascending (with
each key's slot) serves lookups by binary search (``torch.searchsorted``).
An insert sorts the scan by voxel key, looks each run up in the directory,
evicts expired voxels on clear cycles, gives new voxels free slots in
ascending key order, scatters the scan's rows into their slots and sorts
the [V]-row directory again; of the payload only the scan's rows are
written (the new map's tables are copies, as XLA copies them for the JAX
package's values). Semantics kept from the reference (and the JAX package):

  * voxel mean = mean of the inserted points, voxel covariance = mean of
    their covariances (Gaussian map);
  * at most ``cell_capacity`` points a voxel in arrival order, and a new
    point closer than √``min_sq_dist_in_cell`` to one the voxel holds is
    dropped (incremental map; within one insert the test is the JAX
    package's fine-grid approximation, ``_fine_hash``);
  * LRU eviction with pre-increment stamps and the post-increment test
    (stamp + horizon < counter on every ``lru_clear_cycle``-th insert);
    empty inserts change nothing and do not advance the clock;
  * the 1/7/27-voxel search patterns (``neighbor_offsets``);
  * slot exhaustion drops new voxels from the highest key; existing voxels
    keep theirs.

Each map is a plain class of tensors with a ``replace``: ``insert`` returns
a new map and leaves the old one as it was. The counters (``num_voxels``,
``num_points_stored``, ``lru_counter``) stay 0-d device tensors, and
``insert``, ``nearest_neighbor_search`` and ``knn_search`` make no host read
(the neighbour offsets are made once per device and kept), and a transform
T is applied by elementwise ops, so that a scan gets the same keys on the
card and on the CPU. The scatters that
the JAX package writes with ``mode="drop"`` send the dropped rows to one
spare row past the end, which the stored tensors never keep. The float64
prefix sums of the Gaussian insert run along the last dim of a [14, n]
tensor and are rounded once to the map's type. All of this is torch ops,
as it is XLA ops in the JAX package: no kernel of the port lives here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from small_gicp_tpu_torch.point_cloud import (
    PAD_SENTINEL,
    PointCloud,
    pad_row,
    resolve_device,
    transform_covs,
)
from small_gicp_tpu_torch.ops.voxel_keys import (
    INVALID_KEY,
    neighbor_offsets,
    pack_coords,
    voxel_coords,
)

_FAR = 1e18
_IMAX = torch.iinfo(torch.int32).max
_offsets: Dict[Tuple[int, str], torch.Tensor] = {}


def _offsets_on(num_offsets: int, dev: torch.device) -> torch.Tensor:
    """``neighbor_offsets`` on ``dev``, copied there once and kept."""
    key = (num_offsets, str(dev))
    if key not in _offsets:
        _offsets[key] = neighbor_offsets(num_offsets, device=dev)
    return _offsets[key]


def _transform(T: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """T·p of [N,4] homogeneous rows (normals: w = 0), each output
    coordinate ((r0·x + r1·y) + r2·z) + t·w by elementwise ops, each rounded
    on its own: the same bits on the card and on the CPU, so that a point
    on a voxel boundary gets one key on both."""
    prod = rows[:, None, :] * T[None, :3, :]  # [N,3,4]
    xyz = ((prod[..., 0] + prod[..., 1]) + prod[..., 2]) + prod[..., 3]
    return torch.cat([xyz, rows[:, 3:4]], dim=1)


def _put(base: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """A copy of ``base`` [R, ...] with rows ``idx`` set to ``vals``; an
    index of R (the spare row) drops its row."""
    spare = base.new_zeros((1,) + tuple(base.shape[1:]))
    return torch.cat([base, spare]).index_put_((idx,), vals)[:base.shape[0]]


def _runs(keys_s: torch.Tensor, valid: torch.Tensor):
    """(seg_first, pos, run_start, run_end) of the runs of equal valid keys in
    a sorted key array: run_start is the head row of each row's run,
    run_end the row after the run's last (for the head rows)."""
    n = keys_s.shape[0]
    dev = keys_s.device
    prev = torch.cat([keys_s.new_full((1,), INVALID_KEY), keys_s[:-1]])
    seg_first = (keys_s != prev) & valid
    pos = torch.arange(n, device=dev)
    run_start = torch.cummax(torch.where(seg_first, pos, -1), 0).values
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(seg_first, pos, n), [0]), 0)
                     .values, [0])
    run_end = torch.cat([nxt[1:], nxt.new_full((1,), n)])[:n]
    return seg_first, pos, run_start, run_end


def _scan_keys(points: torch.Tensor, leaf_size: torch.Tensor, num_points) -> torch.Tensor:
    """Voxel keys of the scan's first ``num_points`` rows (INVALID_KEY
    elsewhere), with 1/leaf taken in the map's type and cast to the scan's."""
    n = points.shape[0]
    inv_leaf = (1.0 / leaf_size).to(points.dtype)
    keys = pack_coords(voxel_coords(points[:, :3], inv_leaf))
    live = torch.arange(n, device=points.device) < num_points
    return torch.where(live, keys, torch.full_like(keys, INVALID_KEY))


def _lookup(dir_keys: torch.Tensor, keys: torch.Tensor):
    """(hit, directory position) of each key, by binary search (side left)."""
    v = dir_keys.shape[0]
    lo = torch.clamp(torch.searchsorted(dir_keys, keys), 0, v - 1)
    return dir_keys[lo] == keys, lo


def _allocate(vox_keys0: torch.Tensor, new_head: torch.Tensor) -> torch.Tensor:
    """Free slots for the new voxels' head rows in ascending key order
    (their row order): slot, or V where the slots have run out."""
    v = vox_keys0.shape[0]
    free = vox_keys0 == INVALID_KEY
    slots = torch.arange(v, device=vox_keys0.device)
    fsorted = torch.sort(torch.where(free, slots, _IMAX)).values
    nh = new_head.to(torch.int64)
    r = torch.cumsum(nh, 0) - nh
    cand = fsorted[torch.clamp(r, 0, v - 1)]
    ok = new_head & (r < free.sum()) & (cand != _IMAX)
    return torch.where(ok, cand, v)


def _clear_cycle(vm, stamps: torch.Tensor, nonempty: torch.Tensor,
                 counter: torch.Tensor) -> torch.Tensor:
    """[V] bool: the voxels this insert evicts (every ``lru_clear_cycle``-th
    insert, those with stamp + horizon < counter)."""
    do_clear = nonempty & ((counter % vm.lru_clear_cycle) == 0)
    expired = (stamps.to(torch.int64) + vm.lru_horizon) < counter.to(torch.int64)
    return do_clear & expired & (vm.vox_keys != INVALID_KEY)


def _directory(vox_keys: torch.Tensor, vals: torch.Tensor):
    """The directory: occupied keys ascending (INVALID_KEY last) and each
    entry's value. Entries of free slots follow in slot order; the JAX
    package's sort leaves their order open, so only live entries compare."""
    dk, order = torch.sort(vox_keys, stable=True)
    return dk, vals[order]


def _nn_best(d2: torch.Tensor):
    """Row of the first minimum of each row of ``d2`` [Q,L] and its value."""
    best = torch.argmin(d2, dim=-1, keepdim=True)
    return best, torch.gather(d2, 1, best)[:, 0]


def _candidate_keys(center: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    return pack_coords(center[:, None, :] + offsets[None, :, :])  # [Q,K]


def _sq_norm3(d: torch.Tensor) -> torch.Tensor:
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


# ======================================================================
# Gaussian voxel map (VGICP)
# ======================================================================

@dataclass
class GaussianVoxelMap:
    """VGICP's Gaussian voxel map: voxel slots with one [mean 4 | cov 9 |
    count] payload row each, and the sorted key → slot directory."""

    dir_keys: torch.Tensor  # [V] int64 occupied keys ascending, INVALID_KEY pad
    dir_vals: torch.Tensor  # [V] int32 slot of each directory entry
    vox_keys: torch.Tensor  # [V] int64 key of the voxel at each slot; INVALID = free
    payload: torch.Tensor  # [V,14] mean(4) | cov(9) | count(1)
    lru: torch.Tensor  # [V] int32 last-touch stamp of each slot
    num_voxels: torch.Tensor  # 0-d int32
    lru_counter: torch.Tensor  # 0-d int32
    leaf_size: torch.Tensor  # 0-d, the map's type
    num_offsets: int = 1
    lru_horizon: int = 100
    lru_clear_cycle: int = 10

    @property
    def capacity(self) -> int:
        return self.vox_keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.payload.device

    # Views of the slot table (rows at slot positions; mask with valid_mask()).
    @property
    def means(self) -> torch.Tensor:
        return self.payload[:, 0:4]

    @property
    def covs(self) -> torch.Tensor:
        return self.payload[:, 4:13].reshape(-1, 3, 3)

    @property
    def counts(self) -> torch.Tensor:
        return self.payload[:, 13]

    def replace(self, **changes) -> "GaussianVoxelMap":
        return dataclasses.replace(self, **changes)

    @staticmethod
    def empty(leaf_size: float, capacity: int = 131072, dtype=torch.float32,
              num_offsets: int = 1, lru_horizon: int = 100, lru_clear_cycle: int = 10,
              *, device=None) -> "GaussianVoxelMap":
        """An empty map of ``capacity`` slots (rounded up to a multiple of 8,
        as the JAX package does) on ``device`` (default: the card)."""
        dev = resolve_device(device)
        v = -(-capacity // 8) * 8
        return GaussianVoxelMap(
            dir_keys=torch.full((v,), INVALID_KEY, dtype=torch.int64, device=dev),
            dir_vals=torch.arange(v, dtype=torch.int32, device=dev),
            vox_keys=torch.full((v,), INVALID_KEY, dtype=torch.int64, device=dev),
            payload=torch.zeros((v, 14), dtype=dtype, device=dev),
            lru=torch.zeros(v, dtype=torch.int32, device=dev),
            num_voxels=torch.zeros((), dtype=torch.int32, device=dev),
            lru_counter=torch.zeros((), dtype=torch.int32, device=dev),
            leaf_size=torch.tensor(leaf_size, dtype=dtype, device=dev),
            num_offsets=num_offsets, lru_horizon=lru_horizon,
            lru_clear_cycle=lru_clear_cycle)

    @staticmethod
    def build(cloud: PointCloud, leaf_size: float, capacity: Optional[int] = None,
              num_offsets: int = 1) -> "GaussianVoxelMap":
        """One-shot construction from a cloud with covariances, on the
        cloud's device (reference: create_gaussian_voxelmap)."""
        if cloud.covs is None:
            raise ValueError("GaussianVoxelMap.build requires covariances")
        cap = capacity if capacity is not None else cloud.capacity
        vm = GaussianVoxelMap.empty(leaf_size, cap, cloud.dtype, num_offsets=num_offsets,
                                    device=cloud.device)
        return vm.insert(cloud)

    def insert(self, cloud: PointCloud, T=None) -> "GaussianVoxelMap":
        """The map with ``cloud`` (transformed by T if given) merged in and
        the LRU cycle run: each voxel's new mean and covariance are the
        running sums of all its points divided by their count."""
        points, covs = cloud.points, cloud.covs
        if covs is None:
            raise ValueError(
                "GaussianVoxelMap.insert requires a cloud with covariances "
                "(run estimate_covariances / preprocess_points first)")
        if T is not None:
            T = torch.as_tensor(T, dtype=points.dtype, device=points.device)
            points = _transform(T, points)
            covs = transform_covs(T, covs)
        return _gvm_insert(self, points, covs, cloud.num_points)

    def set_lru(self, horizon: int = 100, clear_cycle: int = 10) -> "GaussianVoxelMap":
        return self.replace(lru_horizon=int(horizon), lru_clear_cycle=int(clear_cycle))

    def set_search_offsets(self, num_offsets: int) -> "GaussianVoxelMap":
        """The map searching the 1/7/27-voxel neighbourhood."""
        if num_offsets not in (1, 7, 27):
            raise ValueError("num_offsets must be 1, 7, or 27")
        return self.replace(num_offsets=int(num_offsets))

    def size(self) -> torch.Tensor:
        """Number of occupied voxels (0-d device tensor)."""
        return self.num_voxels

    def nearest_neighbor_search(self, query_xyz: torch.Tensor):
        """[Q,3] → (sq_dists [Q], voxel slot [Q] int32, found [Q] bool): the
        nearest voxel mean among the query's voxel and its offsets."""
        return _gvm_nn(self, query_xyz)

    # Host-side accessors: the live voxels, compacted (numpy).
    def voxel_points(self) -> np.ndarray:
        """[num_voxels, 4] live voxel means (homogeneous)."""
        live = self.valid_mask().cpu().numpy()
        return self.means.cpu().numpy()[live]

    def voxel_covs(self) -> np.ndarray:
        """[num_voxels, 3, 3] live voxel covariances."""
        live = self.valid_mask().cpu().numpy()
        return self.covs.cpu().numpy()[live]

    def __len__(self) -> int:
        return int(self.num_voxels)

    def valid_mask(self) -> torch.Tensor:
        return self.vox_keys != INVALID_KEY


def _gvm_insert(vm: GaussianVoxelMap, points: torch.Tensor, covs: torch.Tensor,
                num_points) -> GaussianVoxelMap:
    """The Gaussian insert of the JAX package's ``_gvm_insert``, step by step:
    per-run sums of the sorted scan by float64 prefix differences, the old
    rows of existing voxels folded in, stamps, eviction, allocation, the
    head rows scattered at their slots, the directory sorted again."""
    V = vm.capacity
    n = points.shape[0]
    dt, dev = vm.payload.dtype, vm.device
    num_points = torch.as_tensor(num_points, device=dev)
    stamp = vm.lru_counter
    nonempty = num_points > 0
    counter = torch.where(nonempty, vm.lru_counter + 1, vm.lru_counter)

    keys = _scan_keys(points, vm.leaf_size, num_points)
    k_s, order = torch.sort(keys, stable=True)
    valid = k_s != INVALID_KEY
    seg_first, pos, _, run_end = _runs(k_s, valid)

    w = valid.to(dt)[:, None]
    allc = torch.cat([points[order].to(dt) * w, covs[order].reshape(n, 9).to(dt) * w, w],
                     dim=1)  # [n,14] = Σ points 4 | Σ covs 9 | count
    # Exclusive prefix sums in float64 along the last dim of [14, n+1]; each
    # run's sum is the difference of two, rounded once to the map's type.
    pref = torch.zeros((14, n + 1), dtype=torch.float64, device=dev)
    pref[:, 1:] = torch.cumsum(allc.to(torch.float64).T.contiguous(), dim=1)
    end = torch.where(seg_first, run_end, pos)
    u_sum = (pref[:, end] - pref[:, pos]).T.to(dt)  # zero off the head rows

    hit, lo = _lookup(vm.dir_keys, k_s)
    hit = hit & valid
    slot_hit = torch.where(hit, vm.dir_vals[lo].to(torch.int64), 0)
    orow = vm.payload[slot_hit]
    old = torch.cat([orow[:, 0:13] * orow[:, 13:14], orow[:, 13:14]], dim=1)
    u_sum = u_sum + torch.where((hit & seg_first)[:, None], old, 0.0)

    # Stamps of the hit voxels, then eviction before allocation.
    stamps_n = stamp.expand(n)
    lru = _put(vm.lru, torch.where(hit & seg_first, slot_hit, V), stamps_n)
    kill = _clear_cycle(vm, lru, nonempty, counter)
    vox_keys0 = torch.where(kill, INVALID_KEY, vm.vox_keys)

    alloc = _allocate(vox_keys0, seg_first & ~hit)
    slot_all = torch.where(hit, slot_hit, alloc)
    write_head = seg_first & (slot_all < V)

    cnt = torch.clamp(u_sum[:, 13:14], min=1.0)
    fin = torch.cat([u_sum[:, 0:13] / cnt, u_sum[:, 13:14]], dim=1)
    tslot = torch.where(write_head, slot_all, V)
    payload = _put(vm.payload, tslot, fin)
    vox_keys = _put(vox_keys0, tslot, k_s)
    lru = _put(lru, tslot, stamps_n)
    dk, dv = _directory(vox_keys, torch.arange(V, dtype=torch.int32, device=dev))
    return vm.replace(
        dir_keys=dk, dir_vals=dv, vox_keys=vox_keys, payload=payload, lru=lru,
        num_voxels=(vox_keys != INVALID_KEY).sum().to(torch.int32),
        lru_counter=counter.to(torch.int32))


def _gvm_nn(vm: GaussianVoxelMap, query_xyz: torch.Tensor):
    q = query_xyz.shape[0]
    offsets = _offsets_on(vm.num_offsets, query_xyz.device)
    inv_leaf = (1.0 / vm.leaf_size).to(query_xyz.dtype)
    cand = _candidate_keys(voxel_coords(query_xyz, inv_leaf), offsets)  # [Q,K]
    hit, pos = _lookup(vm.dir_keys, cand.reshape(-1))
    found = hit.reshape(q, -1) & (cand != INVALID_KEY)
    slot = torch.where(found, vm.dir_vals[pos].reshape(q, -1).to(torch.int64), 0)
    mu = vm.payload[:, 0:3][slot].to(query_xyz.dtype)  # [Q,K,3]
    d2 = torch.where(found, _sq_norm3(mu - query_xyz[:, None, :]), _FAR)
    best, bd = _nn_best(d2)
    return (bd, torch.gather(slot, 1, best)[:, 0].to(torch.int32),
            torch.gather(found, 1, best)[:, 0])


def voxelmap_as_cloud(vm: GaussianVoxelMap) -> PointCloud:
    """The voxel means and covariances as a point cloud (the reference
    passes the voxel map as the target cloud too). Free slots hold the
    padding sentinel; the live rows stay at their slots and number
    ``num_voxels``."""
    pad = pad_row(vm.payload.dtype, vm.device)
    pts = torch.where(vm.valid_mask()[:, None], vm.means, pad)
    return PointCloud(points=pts, num_points=vm.num_voxels, covs=vm.covs)


def ivm_as_cloud(vm: "IncrementalVoxelMap") -> PointCloud:
    """An incremental map's stored points (and normals, covariances) as a
    point cloud: rows at their slot positions, dead rows at the padding
    sentinel, ``num_points`` the live count."""
    pad = pad_row(vm.payload.dtype, vm.device)
    pts = torch.where(vm.valid_points_mask()[:, None], vm.points_flat(), pad)
    return PointCloud(points=pts, num_points=vm.num_points_stored,
                      normals=vm.normals_flat(), covs=vm.covs_flat())


# ======================================================================
# Incremental voxel map (scan-to-model)
# ======================================================================

@dataclass
class IncrementalVoxelMap:
    """Scan-to-model voxel map: slot v owns payload rows [v·C, (v+1)·C)
    (C = ``cell_capacity``), which never move once written; the directory
    maps each occupied key to (slot << 8) | occupancy."""

    dir_keys: torch.Tensor  # [V] int64
    dir_vals: torch.Tensor  # [V] int32 (slot << 8) | occupancy
    vox_keys: torch.Tensor  # [V] int64 key of the voxel at each slot; INVALID = free
    occ: torch.Tensor  # [V] int32 stored points of each slot
    stamps: torch.Tensor  # [V] int32 LRU stamp of each slot
    payload: torch.Tensor  # [V·C, D] point(4) | normal(4)? | cov(9)?
    num_points_stored: torch.Tensor  # 0-d int32
    num_voxels: torch.Tensor  # 0-d int32
    lru_counter: torch.Tensor  # 0-d int32
    leaf_size: torch.Tensor  # 0-d, the map's type
    has_normals: bool = False
    has_covs: bool = False
    cell_capacity: int = 10
    num_offsets: int = 1
    lru_horizon: int = 100
    lru_clear_cycle: int = 10
    min_sq_dist_in_cell: float = 0.01

    @property
    def voxel_capacity(self) -> int:
        return self.vox_keys.shape[0]

    @property
    def capacity(self) -> int:
        """Payload rows (most points stored = V · cell_capacity)."""
        return self.payload.shape[0]

    @property
    def device(self) -> torch.device:
        return self.payload.device

    @property
    def point_keys(self) -> torch.Tensor:
        """The voxel key of each payload row (INVALID_KEY on unused rows)."""
        keys = self.vox_keys.repeat_interleave(self.cell_capacity)
        return torch.where(self.valid_points_mask(), keys, INVALID_KEY)

    def replace(self, **changes) -> "IncrementalVoxelMap":
        return dataclasses.replace(self, **changes)

    @staticmethod
    def empty(leaf_size: float, capacity: int = 131072, dtype=torch.float32,
              has_normals: bool = False, has_covs: bool = False,
              cell_capacity: int = 10, num_offsets: int = 1, lru_horizon: int = 100,
              lru_clear_cycle: int = 10, min_sq_dist_in_cell: float = 0.01,
              voxel_capacity: Optional[int] = None, *,
              device=None) -> "IncrementalVoxelMap":
        """An empty map of ``voxel_capacity`` (default ``capacity``) slots,
        rounded up to a multiple of 8, on ``device`` (default: the card)."""
        if not 0 < cell_capacity < 256:
            raise ValueError("cell_capacity must be in [1, 255] "
                             "(packed with the slot id in the directory)")
        v = voxel_capacity if voxel_capacity is not None else capacity
        v = -(-v // 8) * 8
        if v >= 1 << 23:
            raise ValueError(f"voxel_capacity {v} exceeds 2^23 slots (the directory "
                             "packs (slot << 8) | occupancy into int32)")
        dev = resolve_device(device)
        d = 4 + (4 if has_normals else 0) + (9 if has_covs else 0)
        payload = torch.zeros((v * cell_capacity, d), dtype=dtype, device=dev)
        payload[:, 0:3] = PAD_SENTINEL
        slots = torch.arange(v, dtype=torch.int32, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return IncrementalVoxelMap(
            dir_keys=torch.full((v,), INVALID_KEY, dtype=torch.int64, device=dev),
            dir_vals=slots << 8,
            vox_keys=torch.full((v,), INVALID_KEY, dtype=torch.int64, device=dev),
            occ=torch.zeros(v, dtype=torch.int32, device=dev),
            stamps=torch.zeros(v, dtype=torch.int32, device=dev),
            payload=payload, num_points_stored=zero, num_voxels=zero.clone(),
            lru_counter=zero.clone(),
            leaf_size=torch.tensor(leaf_size, dtype=dtype, device=dev),
            has_normals=has_normals, has_covs=has_covs, cell_capacity=cell_capacity,
            num_offsets=num_offsets, lru_horizon=lru_horizon,
            lru_clear_cycle=lru_clear_cycle, min_sq_dist_in_cell=min_sq_dist_in_cell)

    def insert(self, cloud: PointCloud, T=None) -> "IncrementalVoxelMap":
        """The map with ``cloud`` transformed by T (identity if None) inserted;
        normals and covariances are rotated into the map frame."""
        dt, dev = self.payload.dtype, self.device
        points = cloud.points.to(dt)
        T = (torch.eye(4, dtype=dt, device=dev) if T is None
             else torch.as_tensor(T, dtype=dt, device=dev))
        normals = covs = None
        if self.has_normals:
            normals = cloud.normals if cloud.normals is not None else points.new_zeros(
                (cloud.capacity, 4))
            normals = _transform(T, normals.to(dt))
        if self.has_covs:
            covs = cloud.covs if cloud.covs is not None else points.new_zeros(
                (cloud.capacity, 3, 3))
            covs = transform_covs(T, covs.to(dt))
        return _ivm_insert(self, _transform(T, points), normals, covs, cloud.num_points)

    def set_lru(self, horizon: int = 100, clear_cycle: int = 10) -> "IncrementalVoxelMap":
        return self.replace(lru_horizon=int(horizon), lru_clear_cycle=int(clear_cycle))

    def set_search_offsets(self, num_offsets: int) -> "IncrementalVoxelMap":
        """The map searching the 1/7/27-voxel neighbourhood."""
        if num_offsets not in (1, 7, 27):
            raise ValueError("num_offsets must be 1, 7, or 27")
        return self.replace(num_offsets=int(num_offsets))

    def knn_search(self, query_xyz: torch.Tensor, k: int):
        """[Q,3] → (sq_dists [Q,k], flat row [Q,k] int32, found [Q,k] bool)
        over the stored points of the offset neighbourhood, ascending, ties
        to the earlier candidate; slots beyond the candidates hold 1e18 and
        row 0. The rows index ``points_flat()`` / ``covs_flat()``."""
        return _ivm_knn(self, query_xyz, k)

    def nearest_neighbor_search(self, query_xyz: torch.Tensor):
        d, i, f = _ivm_knn(self, query_xyz, 1)
        return d[:, 0], i[:, 0], f[:, 0]

    # Flat views (rows at slot positions; address live rows with
    # valid_points_mask() or the kNN's rows).
    def points_flat(self) -> torch.Tensor:
        return self.payload[:, :4]

    def normals_flat(self) -> Optional[torch.Tensor]:
        return self.payload[:, 4:8] if self.has_normals else None

    def covs_flat(self) -> Optional[torch.Tensor]:
        if not self.has_covs:
            return None
        off = 8 if self.has_normals else 4
        return self.payload[:, off:off + 9].reshape(-1, 3, 3)

    def size(self) -> torch.Tensor:
        """Number of occupied voxels (use num_points() for stored points)."""
        return self.num_voxels

    def num_points(self) -> torch.Tensor:
        """Total number of stored points across all voxels."""
        return self.num_points_stored

    def __len__(self) -> int:
        return int(self.num_voxels)

    def valid_points_mask(self) -> torch.Tensor:
        c = self.cell_capacity
        j = torch.arange(self.capacity, device=self.device) % c
        return j < self.occ.repeat_interleave(c)

    # Host-side accessors: live points only, compacted (numpy).
    def voxel_points(self) -> np.ndarray:
        """[num_points, 4] stored points (homogeneous)."""
        live = self.valid_points_mask().cpu().numpy()
        return self.points_flat().cpu().numpy()[live]

    def voxel_normals(self) -> Optional[np.ndarray]:
        if not self.has_normals:
            return None
        live = self.valid_points_mask().cpu().numpy()
        return self.normals_flat().cpu().numpy()[live]

    def voxel_covs(self) -> Optional[np.ndarray]:
        if not self.has_covs:
            return None
        live = self.valid_points_mask().cpu().numpy()
        return self.covs_flat().cpu().numpy()[live]


def IncrementalVoxelMapNormal(leaf_size, capacity, **kw) -> IncrementalVoxelMap:
    """The reference bindings' names: IncrementalVoxelMap{Normal,Cov,NormalCov}."""
    return IncrementalVoxelMap.empty(leaf_size, capacity, has_normals=True, **kw)


def IncrementalVoxelMapCov(leaf_size, capacity, **kw) -> IncrementalVoxelMap:
    return IncrementalVoxelMap.empty(leaf_size, capacity, has_covs=True, **kw)


def IncrementalVoxelMapNormalCov(leaf_size, capacity, **kw) -> IncrementalVoxelMap:
    return IncrementalVoxelMap.empty(leaf_size, capacity, has_normals=True,
                                     has_covs=True, **kw)


def _fine_hash(xyz: torch.Tensor, fine_leaf: torch.Tensor,
               coarse_keys: torch.Tensor) -> torch.Tensor:
    """Mixed 64-bit hash of (coarse voxel key, fine-grid integer coords) for
    the within-insert dedup; int64 products wrap and ``>>`` is arithmetic,
    bit for bit the JAX package's."""
    fc = torch.floor(xyz / fine_leaf).to(torch.int64)
    h = (fc[:, 0] * -7046029254386353131      # 0x9E3779B97F4A7C15
         + fc[:, 1] * -4417276706812531889    # 0xC2B2AE3D27D4EB4F
         + fc[:, 2] * 1609587929392839161     # 0x165667B19E3779F9
         + coarse_keys * -8796714831421723037)  # 0x85EBCA77C2B2AE63
    h = h ^ (h >> 29)
    h = h * -4658895280553007687              # 0xBF58476D1CE4E5B9
    return h ^ (h >> 32)


def _ivm_insert(vm: IncrementalVoxelMap, points: torch.Tensor,
                normals: Optional[torch.Tensor], covs: Optional[torch.Tensor],
                num_points) -> IncrementalVoxelMap:
    """The incremental insert of the JAX package's ``_ivm_insert``: the scan
    sorted by (key, arrival), each run's slot and occupancy from the
    directory, the exact dedup against the voxel's points and the fine-grid
    one within the scan, the cap by arrival rank, stamps, eviction,
    allocation, the accepted rows scattered into their pinned rows."""
    V, C = vm.voxel_capacity, vm.cell_capacity
    VC = V * C
    n = points.shape[0]
    dt, dev = vm.payload.dtype, vm.device
    num_points = torch.as_tensor(num_points, device=dev)
    stamp = vm.lru_counter
    nonempty = num_points > 0
    counter = torch.where(nonempty, vm.lru_counter + 1, vm.lru_counter)

    keys = _scan_keys(points, vm.leaf_size, num_points)
    k_s, a_s = torch.sort(keys, stable=True)  # (key, arrival) order
    cols = [points.to(dt)]
    if vm.has_normals:
        cols.append(normals.to(dt))
    if vm.has_covs:
        cols.append(covs.reshape(n, 9).to(dt))
    rows_new = torch.cat(cols, dim=1)[a_s]  # [n, D]
    xyz_s = rows_new[:, :3]
    valid = k_s != INVALID_KEY

    hit, lo = _lookup(vm.dir_keys, k_s)
    hit = hit & valid
    dval = vm.dir_vals[lo].to(torch.int64)
    slot_hit = torch.where(hit, dval >> 8, 0)
    occ_base = torch.where(hit, dval & 0xFF, 0)

    cells = torch.arange(C, device=dev)
    if vm.min_sq_dist_in_cell > 0.0:
        # Exact dedup against the voxel's stored points.
        win = torch.clamp(slot_hit[:, None] * C + cells[None, :], 0, VC - 1)
        oxyz = vm.payload[:, :3][win]  # [n,C,3]
        in_vox = hit[:, None] & (cells[None, :] < occ_base[:, None])
        d2 = torch.where(in_vox, _sq_norm3(oxyz - xyz_s[:, None, :]), _FAR)
        ok = valid & (torch.amin(d2, dim=-1) >= vm.min_sq_dist_in_cell)
        # Within the scan: the first arrival of each fine cell of a voxel.
        # The order of (hash, arrival): by arrival (the inverse of a_s), then
        # stably by hash.
        fine_leaf = torch.sqrt(torch.full((), vm.min_sq_dist_in_cell, dtype=dt, device=dev))
        fh = torch.where(ok, _fine_hash(xyz_s, fine_leaf, k_s), INVALID_KEY)
        by_arrival = torch.argsort(a_s)
        by_hash = torch.sort(fh[by_arrival], stable=True)
        pos_s = by_arrival[by_hash.indices]
        fh_s = by_hash.values
        first = torch.cat([torch.ones(min(n, 1), dtype=torch.bool, device=dev),
                           fh_s[1:] != fh_s[:-1]]) & (fh_s != INVALID_KEY)
        first_b = torch.zeros(n, dtype=torch.bool, device=dev).index_put_((pos_s,), first)
        ok = ok & first_b
    else:
        ok = valid

    # Per-voxel cap: arrival rank among the accepted rows of the run.
    seg_first, pos, run_start, run_end = _runs(k_s, valid)
    rs = torch.clamp(run_start, 0, max(n - 1, 0))
    okf = ok.to(torch.int64)
    ex = torch.cumsum(okf, 0) - okf
    rank = ex - ex[rs]
    keep = ok & (occ_base + rank < C)

    # Stamps of every voxel the scan touches, then eviction before allocation.
    stamps_n = stamp.expand(n)
    stamps = _put(vm.stamps, torch.where(hit & seg_first, slot_hit, V), stamps_n)
    kill = _clear_cycle(vm, stamps, nonempty, counter)
    vox_keys0 = torch.where(kill, INVALID_KEY, vm.vox_keys)
    occ0 = torch.where(kill, 0, vm.occ)

    alloc_head = _allocate(vox_keys0, seg_first & ~hit)
    slot_all = torch.where(hit, slot_hit, alloc_head[rs])
    keep = keep & (slot_all < V)

    dst = torch.where(keep, slot_all * C + occ_base + rank, VC)
    payload = _put(vm.payload, dst, rows_new)

    # Rows added to each run, at its head row.
    kf = keep.to(torch.int64)
    ck = torch.cumsum(kf, 0)
    added = ck[torch.clamp(run_end - 1, min=0)] - (ck - kf)

    tslot = torch.where(seg_first & (slot_all < V), slot_all, V)
    vox_keys = _put(vox_keys0, tslot, k_s)
    occ = _put(occ0, tslot, (occ_base + added).to(torch.int32))
    stamps = _put(stamps, tslot, stamps_n)
    slots = torch.arange(V, dtype=torch.int32, device=dev)
    dk, dv = _directory(vox_keys, (slots << 8) | occ)
    return vm.replace(
        dir_keys=dk, dir_vals=dv, vox_keys=vox_keys, occ=occ, stamps=stamps,
        payload=payload, num_points_stored=occ.sum().to(torch.int32),
        num_voxels=(vox_keys != INVALID_KEY).sum().to(torch.int32),
        lru_counter=counter.to(torch.int32))


def _ivm_knn(vm: IncrementalVoxelMap, query_xyz: torch.Tensor, k: int):
    q = query_xyz.shape[0]
    C = vm.cell_capacity
    dev = query_xyz.device
    offsets = _offsets_on(vm.num_offsets, dev)
    K = offsets.shape[0]
    inv_leaf = (1.0 / vm.leaf_size).to(query_xyz.dtype)
    cand = _candidate_keys(voxel_coords(query_xyz, inv_leaf), offsets)  # [Q,K]
    hit, pos = _lookup(vm.dir_keys, cand.reshape(-1))
    found = hit.reshape(q, K) & (cand != INVALID_KEY)
    dval = vm.dir_vals[pos].reshape(q, K).to(torch.int64)
    slot = torch.where(found, dval >> 8, 0)
    occv = torch.where(found, dval & 0xFF, 0)

    cells = torch.arange(C, device=dev)
    idx = slot[:, :, None] * C + cells  # [Q,K,C]
    usable = cells < occv[:, :, None]
    d2 = _sq_norm3(vm.payload[:, :3][idx] - query_xyz[:, None, None, :])
    d2 = torch.where(usable, d2, _FAR).reshape(q, K * C)
    flat_idx = idx.reshape(q, K * C)
    if k == 1:
        best, bd = _nn_best(d2)
        return (bd[:, None], torch.gather(flat_idx, 1, best).to(torch.int32),
                (bd < _FAR)[:, None])
    # At most K·C candidates; the rest of k are not-found slots. The first
    # kk of a stable sort: ties to the lower candidate, as top_k gives them.
    kk = min(k, K * C)
    d_s, sel = torch.sort(d2, dim=1, stable=True)
    d_out = d_s[:, :kk]
    i_out = torch.gather(flat_idx, 1, sel[:, :kk]).to(torch.int32)
    if kk < k:
        d_out = torch.cat([d_out, d_out.new_full((q, k - kk), _FAR)], dim=1)
        i_out = torch.cat([i_out, i_out.new_zeros((q, k - kk))], dim=1)
    return d_out, i_out, d_out < _FAR
