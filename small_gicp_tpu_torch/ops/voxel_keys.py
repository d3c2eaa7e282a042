"""63-bit voxel key packing, in int64 torch.

Counterpart of ``small_gicp_tpu/ops/voxel_keys.py``: each axis is
floor(p · (1/leaf)) offset by 2^20 into 21 unsigned bits, packed as
(z<<42 | y<<21 | x). Out-of-range, non-finite and sentinel rows get
INVALID_KEY, which sorts last.
"""

from __future__ import annotations

import torch

COORD_BITS = 21
COORD_OFFSET = 1 << (COORD_BITS - 1)
COORD_RANGE = 1 << COORD_BITS
INVALID_KEY = torch.iinfo(torch.int64).max


def voxel_coords(points_xyz: torch.Tensor, inv_leaf: torch.Tensor) -> torch.Tensor:
    """[N,3] float coords → [N,3] int32 voxel coords, floor(p · inv_leaf).

    Non-finite and huge values are forced to 2^30 before the integer
    cast, so pack_coords maps them to INVALID_KEY.
    """
    c = torch.floor(points_xyz * inv_leaf)
    big = 2.0**30
    c = torch.where(torch.isfinite(c), torch.clamp(c, -big, big),
                    torch.full_like(c, big))
    return c.to(torch.int32)


def pack_coords(coords: torch.Tensor) -> torch.Tensor:
    """[N,3] int voxel coords → [N] int64 keys; out-of-range → INVALID_KEY."""
    shifted = coords.to(torch.int64) + COORD_OFFSET
    in_range = torch.all((shifted >= 0) & (shifted < COORD_RANGE), dim=-1)
    key = (
        (shifted[..., 2] << (2 * COORD_BITS))
        | (shifted[..., 1] << COORD_BITS)
        | shifted[..., 0]
    )
    return torch.where(in_range, key, torch.full_like(key, INVALID_KEY))


def voxel_keys(points_xyz: torch.Tensor, leaf_size) -> torch.Tensor:
    """[N,3] points → [N] int64 voxel keys.

    The reciprocal 1/leaf is taken in the cloud dtype and multiplied in,
    exactly as the reference does; dividing by leaf instead moves points
    that sit on a voxel boundary.
    """
    dt = points_xyz.dtype
    leaf = torch.as_tensor(leaf_size, dtype=dt, device=points_xyz.device)
    inv_leaf = torch.ones((), dtype=dt, device=points_xyz.device) / leaf
    return pack_coords(voxel_coords(points_xyz, inv_leaf))


def sort_segments(keys: torch.Tensor):
    """Stable argsort of keys (INVALID_KEY last) and per-voxel runs.

    Returns (order, keys_sorted, valid [N] bool, seg_id [N] int64 — invalid
    rows go to N-1 —, num_segments 0-d int64).
    """
    keys_s, order = torch.sort(keys, stable=True)
    valid, _, seg, num = segment_ids(keys_s)
    return order, keys_s, valid, seg, num


def unpack_key(keys: torch.Tensor) -> torch.Tensor:
    """[N] int64 keys → [N,3] int32 voxel coords (inverse of pack_coords)."""
    mask = COORD_RANGE - 1
    x = (keys & mask) - COORD_OFFSET
    y = ((keys >> COORD_BITS) & mask) - COORD_OFFSET
    z = ((keys >> (2 * COORD_BITS)) & mask) - COORD_OFFSET
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def neighbor_offsets(num_offsets: int, device=None) -> torch.Tensor:
    """Voxel neighbourhood offsets, [K,3] int32: the reference's 1/7/27-voxel
    search patterns in the JAX package's order, which a nearest-neighbour
    search's first-minimum tie-break follows."""
    if num_offsets == 1:
        offs = [(0, 0, 0)]
    elif num_offsets == 7:
        offs = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                (0, 0, 1), (0, 0, -1)]
    elif num_offsets == 27:
        offs = [(x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)]
    else:
        raise ValueError("num_offsets must be 1, 7, or 27")
    return torch.tensor(offs, dtype=torch.int32, device=device)


def segment_ids(keys_sorted: torch.Tensor):
    """Runs of equal valid keys in a sorted key array: (valid [N] bool,
    seg_first [N] bool, seg_id [N] int64 — invalid rows go to N-1 —,
    num_segments 0-d int64)."""
    n = keys_sorted.shape[0]
    valid = keys_sorted != INVALID_KEY
    prev = torch.cat([keys_sorted.new_full((1,), INVALID_KEY), keys_sorted[:-1]])
    seg_first = (keys_sorted != prev) & valid
    seg = torch.cumsum(seg_first.to(torch.int64), 0) - 1
    num = torch.sum(seg_first)
    seg = torch.where(valid, seg, torch.full_like(seg, n - 1))
    return valid, seg_first, seg, num
