"""Morton sort and tile boxes: the prologue that the box-pruned searches
share (K12 ``knn_cuda.knn_pruned``, K3 and K4 ``cov_fused_cuda.knn_moments``
/ ``knn_topk_idx``, K1 and K6 ``gicp_fused_cuda.gicp_linearize_tables`` on
either route, and over stacked pairs K7
``gicp_fused_cuda.gicp_linearize_fleet``).

A cloud's valid rows are sorted by Morton code (cell 1.0, origin at their
min corner) and every ``TILE_ROWS`` sorted rows get a bounding box; a
kernel's block of ``BLOCK_ROWS`` queries then skips every tile whose box
lies beyond its bound. The result depends on the cloud alone, so a caller
that searches one cloud repeatedly builds it once (``KdTree.pruned_target``).
The box walks of K3, K4, K1, K6 and K7 cull a block's tiles in passes of
``CULL_PASS`` boxes. The three constants repeat ``kBoxRows``,
``kPrunedThreads`` and ``kCullPass`` of ``csrc/common.cuh``; ``library``
holds them against the compiled values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from small_gicp_tpu_torch import _build
from small_gicp_tpu_torch.ops.knn_window import morton_codes32

_BIG = 3.0e38
TILE_ROWS = 256
BLOCK_ROWS = 64
CULL_PASS = 256


def library(name: str):
    """The kernel library ``name`` (one built on ``csrc/common.cuh``), its
    box constants held against this module's on the first load."""
    return _build.library_with_geometry(name, "sgt_box_geometry",
                                        (TILE_ROWS, BLOCK_ROWS, CULL_PASS))


def morton_order(xyz: torch.Tensor, valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable order of the rows [N,3] by Morton code (cell 1.0, origin at
    the valid rows' min corner), valid rows first whatever their code:
    (sorted keys [N] int64 — the code, 2³¹ for invalid rows; perm [N] int64,
    sorted position → row; origin [3]). Over stacked clouds [U,N,3] with
    ``valid`` [U,N] each cloud is ordered on its own, by one sort of the
    keys offset by cloud: every output gains the leading [U]."""
    if xyz.shape[-2] > 0:
        origin = torch.where(valid[..., None], xyz, torch.inf).amin(dim=-2)
        origin = torch.where(torch.isfinite(origin), origin, 0.0)
    else:
        origin = xyz.new_zeros(xyz.shape[:-2] + (3,))
    codes = morton_codes32(xyz, 1.0, origin[..., None, :]).to(torch.int64)
    key = torch.where(valid, codes, 2 ** 31)
    if key.dim() == 1:
        key, perm = torch.sort(key, stable=True)
        return key, perm, origin
    u, n = key.shape
    offset = torch.arange(u, device=key.device)[:, None]
    flat, perm = torch.sort((key + offset * 2 ** 32).reshape(-1), stable=True)
    return (flat.view(u, n) - offset * 2 ** 32, perm.view(u, n) - offset * n, origin)


@dataclass
class PrunedTarget:
    """A cloud sorted and boxed for the pruned searches (stacked clouds:
    every field gains a leading [U])."""

    tsorted: torch.Tensor  # [M,4] Morton-sorted x y z | original row (int32 bits)
    tperm: torch.Tensor  # [M] int64, sorted position → original row
    tbox: torch.Tensor  # [ceil(M/256), 8]: lo 3, 0, hi 3, 0 over valid rows
    tkey: torch.Tensor  # [M] int64 sorted keys: the code, 2³¹ for padding rows
    origin: torch.Tensor  # [3] min corner of the valid rows, the codes' origin


def pruned_prepare_target(target_points: torch.Tensor, num_points: torch.Tensor
                          ) -> PrunedTarget:
    """Sort the cloud's first ``num_points`` rows by Morton code and box
    every 256 sorted rows. No host read of ``num_points``. Stacked clouds
    [U,M,4] with counts [U] are sorted and boxed each on its own, by one
    sort for all (``morton_order``)."""
    dev, dt = target_points.device, target_points.dtype
    t = target_points[..., :3]
    lead, m = t.shape[:-2], t.shape[-2]
    num = torch.as_tensor(num_points, device=dev)[..., None]
    tkey, tperm, origin = morton_order(t, torch.arange(m, device=dev) < num)
    tsorted = torch.empty(lead + (m, 4), dtype=dt, device=dev)
    tsorted[..., :3] = torch.gather(t, -2, tperm[..., None].expand(lead + (m, 3)))
    if dt == torch.float32:
        tsorted[..., 3] = tperm.to(torch.int32).view(torch.float32)
    else:
        tsorted[..., 3] = 0.0

    ntiles = (m + TILE_ROWS - 1) // TILE_ROWS
    padded = torch.zeros(lead + (ntiles * TILE_ROWS, 3), dtype=dt, device=dev)
    padded[..., :m, :] = tsorted[..., :3]
    live = (torch.arange(ntiles * TILE_ROWS, device=dev) < num)[..., None]
    tbox = torch.zeros(lead + (ntiles, 8), dtype=dt, device=dev)
    if ntiles > 0:
        tiles = lead + (ntiles, TILE_ROWS, 3)
        tbox[..., 0:3] = torch.where(live, padded, _BIG).view(tiles).amin(-2)
        tbox[..., 4:7] = torch.where(live, padded, -_BIG).view(tiles).amax(-2)
    return PrunedTarget(tsorted=tsorted, tperm=tperm, tbox=tbox, tkey=tkey,
                        origin=origin)


def box_gap2(tbox: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """[T] gap² between each box of ``tbox`` [T,8] and the box [lo, hi] [3],
    in the kernels' operation order (``csrc/common.cuh`` ``box_gap2``): it
    never exceeds the d² of a pair of points inside the two boxes."""
    g = torch.clamp(torch.maximum(tbox[:, 0:3] - hi, lo - tbox[:, 4:7]), min=0.0)
    return g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2]
