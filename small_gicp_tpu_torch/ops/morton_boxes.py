"""Morton sort and tile boxes: the prologue that the box-pruned searches
share (K12 ``knn_cuda.knn_pruned``, K3, K4 and K5
``cov_fused_cuda.knn_moments`` / ``knn_topk_idx``, K1 and K6
``gicp_fused_cuda.gicp_linearize_tables`` on either route, and over stacked
pairs K7 ``gicp_fused_cuda.gicp_linearize_fleet``), and the plain account of
the box walk that K3, K4, K5 and K12 share (``walk_lists_plain``).

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
from typing import Optional, Tuple

import torch

from small_gicp_tpu_torch import _build
from small_gicp_tpu_torch.ops.knn import first_k, sq_dists
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


# ------------------------------------------- the walk of K3, K4, K5, K12 ----

def bound_window(k: int) -> int:
    """Sorted rows around a query from which the walk takes its reach (``w``
    of cov_fused_pallas.py:431)."""
    return max(64, 2 * k + 24)


def walk_passes(own: int, ntiles: int, cull_pass: int = CULL_PASS,
                outward: bool = True):
    """The cull passes over ``ntiles`` boxes of a block whose anchor box is
    ``own``: [(first, end)], the first pass the ``cull_pass`` boxes around
    ``own`` (``outward``; else the first ones), then the adjacent passes
    above and below in turn. Every box lies in exactly one pass."""
    below = max(0, min(own - cull_pass // 2, ntiles - cull_pass)) if outward else 0
    above = min(ntiles, below + cull_pass)
    passes, up = [(below, above)], True
    while True:
        if above < ntiles and (up or below == 0):
            passes.append((above, min(ntiles, above + cull_pass)))
            above = passes[-1][1]
        elif below > 0:
            passes.append((max(0, below - cull_pass), below))
            below = passes[-1][0]
        else:
            return passes
        up = not up


def window_reach(xyz: torch.Tensor, m: int, q: torch.Tensor, lo: torch.Tensor,
                 window: int, k: int, hi: Optional[torch.Tensor] = None,
                 step: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[Q] the kth smallest d² from each query q [Q,3] over the sorted rows
    lo, lo + step, … (``window`` of them; step 1 by default) below hi (m by
    default), 3e38 where these are fewer than k: the reach that seeds a
    query's list in the walk. Any k distinct rows bound the query's true kth
    distance from above."""
    cols = torch.arange(window, device=q.device)
    cols = lo[:, None] + (cols if step is None else cols * step[:, None])
    below = cols < (m if hi is None else torch.clamp(hi, max=m)[:, None])
    d = xyz[cols.clamp(max=m - 1)] - q[:, None, :]
    wd2 = torch.where(below, d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2], _BIG)
    return torch.sort(wd2, dim=1).values[:, k - 1]


def walk_lists_plain(xyz: torch.Tensor, orig: torch.Tensor, tbox: torch.Tensor, m: int,
                     q: torch.Tensor, reach: torch.Tensor, anchors, k: int, team: int,
                     cull_pass: int = CULL_PASS, outward: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The box walk of K3, K4, K5 and K12 (common.cuh's walk_sorted) step
    by step over a sorted table: ``xyz`` [M,3] sorted rows, the first m
    valid, ``orig`` [M] their original rows, ``tbox`` their boxes; queries
    q [Q,3] in the kernel's order, blocks of ``BLOCK_ROWS // team``
    consecutive queries; ``reach`` [Q] each query's seed (``window_reach``)
    and ``anchors`` [blocks] the box where each block's passes start. A
    block has the box of its queries and the bound R = the largest reach;
    the passes of ``walk_passes`` keep the tiles whose box gap² to the
    block's box does not exceed R; member t of a query's team takes the
    rows t, t + team, … of each kept tile into its own list, those within
    the query's reach, and R tightens after each pass to the largest of
    every member's min(kth so far, reach); each member's list is the k
    first of its rows in (d², original row) order, and the team's merged
    list the k first of theirs. Returns the merged lists (d² [Q,k], original
    row [Q,k] int32; empty slots 3e38 and 0): the k nearest valid rows of
    each query, since no bound ever cuts a true neighbour and the merge
    keeps the order."""
    if BLOCK_ROWS % team or TILE_ROWS % team:
        raise ValueError(f"a team of {team} does not divide a block")
    dev, nq = q.device, q.shape[0]
    out_d = torch.full((nq, k), _BIG, dtype=q.dtype, device=dev)
    out_i = torch.zeros((nq, k), dtype=torch.int32, device=dev)
    if m == 0:
        return out_d, out_i
    ntiles = -(-m // TILE_ROWS)
    block = BLOCK_ROWS // team
    tile_cols = torch.arange(TILE_ROWS, device=dev)
    orig = orig.long()

    def kth_of(cand_d, rq):
        if cand_d.shape[1] < k:
            return torch.full_like(rq, _BIG)
        return torch.sort(cand_d, dim=1).values[:, k - 1]

    for b, q0 in enumerate(range(0, nq, block)):
        qb, rq = q[q0:q0 + block], reach[q0:q0 + block]
        blo, bhi = qb.amin(dim=0), qb.amax(dim=0)
        bound = rq.max()
        cand_d = [qb.new_zeros((len(qb), 0)) for _ in range(team)]
        cand_i = [orig.new_zeros(0) for _ in range(team)]
        for first, end in walk_passes(int(anchors[b]), ntiles, cull_pass, outward):
            live = first + (~(box_gap2(tbox[first:end], blo, bhi) > bound)).nonzero()[:, 0]
            rows = (live[:, None] * TILE_ROWS + tile_cols).reshape(-1)
            rows = rows[rows < m]
            d2 = sq_dists(qb, xyz[rows])
            d2 = torch.where(d2 <= rq[:, None], d2, _BIG)
            for t in range(team):
                mine = rows % team == t  # the member's rows of each tile
                cand_d[t] = torch.cat([cand_d[t], d2[:, mine]], dim=1)
                cand_i[t] = torch.cat([cand_i[t], orig[rows[mine]]])
            bound = torch.stack([torch.minimum(kth_of(c, rq), rq) for c in cand_d]).max()
        lists_d, lists_i = [], []
        for t in range(team):
            by_row = torch.argsort(cand_i[t], stable=True)
            dk, ik = first_k(cand_d[t][:, by_row], cand_i[t][by_row], k)
            lists_d.append(dk)
            lists_i.append(torch.where(dk < _BIG, ik.long(), orig.new_full((), 2 ** 40)))
        # The merge: the k first of the members' lists in (d², original row)
        # order (empty slots last).
        all_d, all_i = torch.cat(lists_d, dim=1), torch.cat(lists_i, dim=1)
        by_row = torch.argsort(all_i, dim=1, stable=True)
        all_d, all_i = torch.gather(all_d, 1, by_row), torch.gather(all_i, 1, by_row)
        by_d = torch.argsort(all_d, dim=1, stable=True)[:, :k]
        dk, ik = torch.gather(all_d, 1, by_d), torch.gather(all_i, 1, by_d)
        out_d[q0:q0 + block] = dk
        out_i[q0:q0 + block] = torch.where(dk < _BIG, ik, 0).to(torch.int32)
    return out_d, out_i
