"""Exact self-kNN covariance moments: kernels K3, K4, K5 and their plain
versions.

Counterpart of ``small_gicp_tpu/ops/cov_fused_pallas.py``
(``knn_moments_pallas``). ``knn_moments`` returns, in original row order,
(m1 [N,3] = Σd, m2 [N,3,3] = Σddᵀ, counts [N]) with d = p − q over the k
nearest valid rows p of every valid row q (self included; a neighbour
counts if its d² < 1e16). Rows at or beyond ``num_points`` are zero. Ties
go to the lower row index in every layout, so the three layouts choose the
same neighbours. The cloud is front-packed, as ``preprocess_points`` makes
it: the walks take its first ``num_points`` live rows from the sort
(``point_cloud.live_rows``), the plain versions its first ``num_points``
rows, and the two are the same rows only there.

Three layouts, named as the JAX package names them:

  * ``"t"`` (K3): the moment rows formed in the kernel, after a walk over
    the cloud's Morton sort and boxes in which ``MOMENTS_TEAM`` threads
    serve one query (``knn_moments_walk_plain`` is the plain account) — the
    default up to ``TI_MIN_ROWS`` rows;
  * ``"ti"`` (K4): the kernel returns the neighbours only (``knn_topk_idx``:
    indices and d², through the same Morton-sorted, box-pruned walk, one
    thread a query, whose bound comes from each row's Morton window, its
    boxes culled in parallel passes — ``knn_topk_idx_walk_plain`` is the
    plain account of that walk); the winners are gathered and summed here
    with torch ops — the default above ``TI_MIN_ROWS`` rows;
  * ``"q"`` (K5): K3's moment rows by the other work mapping — the same
    walk over the cloud's Morton sort and boxes with ``MOMENTS_Q_TEAM``
    lanes a query, each lane's list in shared memory
    (``knn_moments_walk_plain(team=MOMENTS_Q_TEAM)`` is the plain
    account); by request only.

``knn_normals_covs`` is K3 in its epilogue modes: the same launch finishes
each row's normal and plane-regularised covariance from its moment row, bit
for bit as the torch epilogue of ``ops/normals.py`` does on the card.

``knn_moments_rows`` returns the [N,16] rows of ``"t"`` and ``"q"``,

  [Σd 3 | Σddᵀ upper 6 (xx xy xz yy yz zz) | count | d_k | 0 ×5]

with d_k the kth d². The routing thresholds are the JAX package's; they
were set by TPU memory and bind nothing on this card, and moving them is a
measured decision for later.

K3, K4 and K5 take the cloud's sort and boxes (``morton_boxes``) as
``target=`` when the caller keeps them (``KdTree.pruned_target()``: the
covariance stage of ``preprocess_points`` and the align that follows share
one sort of each cloud); without it they sort the cloud themselves.

On a CUDA tensor every wrapper launches its kernel (``csrc/cov_fused.cu``)
or raises; on a CPU tensor it runs the plain version beside it. The first
forms stay as yardsticks reached from no path: K3's brute-force scan in
row order (``_knn_moments_rows_v1``), K4's walk that tested the boxes
one after another (``_knn_topk_idx_v1``) and K5's dense scan with a warp a
query (``_knn_moments_rows_q_v1``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from small_gicp_tpu_torch import _build
from small_gicp_tpu_torch.ops import morton_boxes
from small_gicp_tpu_torch.ops.knn import QUERY_BLOCK
from small_gicp_tpu_torch.ops.knn_cuda import knn_plain
from small_gicp_tpu_torch.ops.morton_boxes import (
    BLOCK_ROWS,
    CULL_PASS,
    TILE_ROWS,
    PrunedTarget,
    bound_window,
    pruned_prepare_target,
    walk_lists_plain,
    window_reach,
)

_BIG = 3.0e38
_VALID_SQ = 1e16
MAX_K = 64
LAYOUTS = ("t", "ti", "q")
# knn_moments_pallas' routing (cov_fused_pallas.py:402-415): "t" up to this
# many rows, "ti" above, nothing above MAX_ROWS.
TI_MIN_ROWS = 262_144
MAX_ROWS = 1_048_576
# Threads that serve one of K3's queries and lanes that serve one of K5's
# (kTeam and kWarpTeam of csrc/cov_fused.cu, held against them when the
# library loads; tools/scan_walk_sweep.py, tools/warp_kernel_sweep.py).
MOMENTS_TEAM = 4
MOMENTS_Q_TEAM = 8

Pair = Tuple[torch.Tensor, torch.Tensor]


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_moments supports 1 <= k <= {MAX_K}, got {k}")


def _library():
    morton_boxes.library("cov_fused")  # the box constants held
    return _build.library_with_geometry("cov_fused", "sgt_knn_moments_geometry",
                                        (MOMENTS_TEAM, MOMENTS_Q_TEAM))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ------------------------------------------------------------ K3, K5 ----

def _moment_rows(gx: torch.Tensor, gy: torch.Tensor, gz: torch.Tensor,
                 d_k: torch.Tensor) -> torch.Tensor:
    """[R,11] = [Σd 3 | Σddᵀ upper 6 | count | d_k] of the offsets (gx, gy,
    gz) [R,k] of each row's k slots at d² ``d_k`` [R,k], slots with
    d² ≥ 1e16 left out: the plain versions' one form of the sums."""
    v = d_k < _VALID_SQ
    vx, vy, vz = (torch.where(v, g, 0.0) for g in (gx, gy, gz))
    return torch.stack(
        [vx.sum(1), vy.sum(1), vz.sum(1),
         (vx * gx).sum(1), (vx * gy).sum(1), (vx * gz).sum(1),
         (vy * gy).sum(1), (vy * gz).sum(1), (vz * gz).sum(1),
         v.sum(1).to(gx.dtype), d_k[:, -1]],
        dim=1,
    )


def knn_moments_rows_plain(points: torch.Tensor, num_points: torch.Tensor,
                           k: int, rows: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of K3: [N,4] points → [N,16] moment rows.
    ``rows`` [R] int64 restricts the queries to those rows ([R,16] output),
    for clouds whose N² distances are out of reach."""
    n = points.shape[0]
    dev, dt = points.device, points.dtype
    out = torch.zeros((n if rows is None else len(rows), 16), dtype=dt, device=dev)
    # Only the valid rows (the first num_points) are candidates, and only
    # they get moments: a padding column would sort after them all and only
    # fill slots that count for nothing.
    m = min(int(num_points), n)
    if m == 0:
        return out
    rows = torch.arange(m, device=dev) if rows is None else rows
    xyz = points[:m, :3]
    for s in range(0, len(rows), QUERY_BLOCK):
        ids = rows[s:s + QUERY_BLOCK]
        q = points[ids, :3]
        dx = xyz[None, :, 0] - q[:, None, 0]  # p − q, [B, m]
        dy = xyz[None, :, 1] - q[:, None, 1]
        dz = xyz[None, :, 2] - q[:, None, 2]
        d2 = dx * dx + dy * dy + dz * dz
        if m < k:
            d2 = torch.cat([d2, d2.new_full((d2.shape[0], k - m), _BIG)], dim=1)
        d_sorted, idx = torch.sort(d2, dim=1, stable=True)
        d_k, idx = d_sorted[:, :k], torch.clamp(idx[:, :k], max=m - 1)
        moments = _moment_rows(*(torch.gather(a, 1, idx) for a in (dx, dy, dz)), d_k)
        out[s:s + len(ids), :11] = torch.where((ids < m)[:, None], moments, 0.0)
    return out


def knn_moments_rows_q_plain(points: torch.Tensor, num_points: torch.Tensor,
                             k: int, rows: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of K5: the same function as K3's, so the same
    body (the two kernels differ in their work mapping only)."""
    return knn_moments_rows_plain(points, num_points, k, rows)


def _launch_rows(entry: str, points: torch.Tensor, num_points: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Launch the first form ``entry`` of K3 or K5 (no sort), uncounted."""
    _check_k(k)
    _build.require(points, "points", torch.float32, (None, 4))
    _build.require(num_points, "num_points", torch.int32, ())
    n = points.shape[0]
    out = torch.empty((n, 16), dtype=torch.float32, device=points.device)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(points.device):
        rc = getattr(lib, entry)(points.data_ptr(), num_points.data_ptr(), n, k,
                                 out.data_ptr(), _stream())
    _build.check(rc, entry)
    return out


def _knn_moments_rows_v1(points: torch.Tensor, num_points: torch.Tensor,
                         k: int) -> torch.Tensor:
    """K3's first form (one thread a query over every valid row in row
    order, bounded by the ±32 rows around it): the yardstick of K3, on no
    path and counted nowhere."""
    return _launch_rows("sgt_knn_moments_v1", points, num_points, k)


def _knn_moments_rows_q_v1(points: torch.Tensor, num_points: torch.Tensor,
                           k: int) -> torch.Tensor:
    """K5's first form (one warp a query over every valid row in row
    order, cold lane lists): the yardstick of K5, on no path and counted
    nowhere."""
    return _launch_rows("sgt_knn_moments_warp_v1", points, num_points, k)


def _sorted_cloud(points: torch.Tensor, num_points: torch.Tensor,
                  target: Optional[PrunedTarget]) -> PrunedTarget:
    """The cloud's Morton sort and boxes: ``target`` when the caller keeps
    them (checked against the cloud's shape), else made here."""
    if target is None:
        return pruned_prepare_target(points, num_points)
    if target.tsorted.shape != points.shape or target.tsorted.dtype != points.dtype:
        raise ValueError("target= was not prepared from these points")
    return target


def _walk_launch(wrapper, entry: str, points: torch.Tensor, num_points: torch.Tensor,
                 k: int, target: Optional[PrunedTarget], outs) -> None:
    """Launch the walk ``entry`` (K3 in one of its modes, or K5) over the
    cloud's sort and boxes (made here without ``target``) into the tensors
    ``outs`` (None: a null pointer), and count it on ``wrapper``."""
    n = points.shape[0]
    if n == 0:
        return
    target = _sorted_cloud(points, num_points, target)
    _build.require(target.tsorted, "sorted rows", torch.float32, (n, 4))
    lib = _library()
    with torch.cuda.device(points.device):
        rc = getattr(lib, entry)(points.data_ptr(), target.tsorted.data_ptr(),
                                 num_points.data_ptr(), n, target.tbox.data_ptr(), k,
                                 bound_window(k),
                                 *(None if t is None else t.data_ptr() for t in outs),
                                 _stream())
    _build.check(rc, entry)
    wrapper.launches += 1


def _moments_walk_launch(wrapper, entry: str, points: torch.Tensor,
                         num_points: torch.Tensor, k: int,
                         target: Optional[PrunedTarget]) -> torch.Tensor:
    """[N,16] moment rows of the walk ``entry`` (K3 or K5), counted on
    ``wrapper``."""
    _build.require(points, "points", torch.float32, (None, 4))
    _build.require(num_points, "num_points", torch.int32, ())
    out = torch.empty((points.shape[0], 16), dtype=torch.float32, device=points.device)
    _walk_launch(wrapper, entry, points, num_points, k, target, (out,))
    return out


def _knn_moments_rows_cuda(points: torch.Tensor, num_points: torch.Tensor, k: int,
                           target: Optional[PrunedTarget]) -> torch.Tensor:
    """Kernel K3 over the cloud's sort and boxes (made here without
    ``target``)."""
    return _moments_walk_launch(knn_moments_rows, "sgt_knn_moments", points, num_points,
                                k, target)


def knn_moments_rows_q(points: torch.Tensor, num_points: torch.Tensor, k: int,
                       target: Optional[PrunedTarget] = None) -> torch.Tensor:
    """[N,4] padded cloud → [N,16] moment rows with ``MOMENTS_Q_TEAM`` lanes
    a query: kernel K5 on CUDA over the cloud's sort and boxes (``target``
    when the caller keeps them, else made here), plain version on the
    CPU."""
    _check_k(k)
    if points.device.type == "cpu":
        return knn_moments_rows_q_plain(points, num_points, k)
    return _moments_walk_launch(knn_moments_rows_q, "sgt_knn_moments_warp", points,
                                num_points, k, target)


knn_moments_rows_q.launches = 0


def knn_moments_rows(points: torch.Tensor, num_points: torch.Tensor, k: int,
                     layout: str = "t", target: Optional[PrunedTarget] = None
                     ) -> torch.Tensor:
    """[N,4] padded cloud → [N,16] moment rows: layout ``"t"`` (kernel K3 on
    CUDA over the cloud's sort and boxes, which ``target`` passes in when
    the caller keeps them; plain version on the CPU) or ``"q"``
    (``knn_moments_rows_q``, over the same ``target``). Layout ``"ti"``
    forms no rows: see ``knn_topk_idx``."""
    _check_k(k)
    if layout == "q":
        return knn_moments_rows_q(points, num_points, k, target=target)
    if layout != "t":
        raise ValueError(f"moment rows come in layout 't' or 'q', got {layout!r}")
    if points.device.type == "cpu":
        return knn_moments_rows_plain(points, num_points, k)
    return _knn_moments_rows_cuda(points, num_points, k, target)


knn_moments_rows.launches = 0


def knn_normals_covs(points: torch.Tensor, num_points: torch.Tensor, k: int,
                     need_normals: bool = True, need_covs: bool = True,
                     target: Optional[PrunedTarget] = None):
    """Kernel K3 with its epilogue, on CUDA: (normals [N,4], covs [N,3,3])
    of ``ops/normals.py``, each None where not asked for, finished in the
    launch that forms the moment rows — bit for bit what the torch epilogue
    there (``normals._torch_epilogue``, the plain version) makes of K3's
    rows on the card. Layout "t" only; counted as a launch of K3 on
    ``knn_moments_rows``."""
    _check_k(k)
    if not (need_normals or need_covs):
        raise ValueError("knn_normals_covs: ask for normals, covs or both")
    _build.require(points, "points", torch.float32, (None, 4))
    _build.require(num_points, "num_points", torch.int32, ())
    n, dev = points.shape[0], points.device
    normals = torch.empty((n, 4), dtype=torch.float32, device=dev) if need_normals else None
    covs = torch.empty((n, 3, 3), dtype=torch.float32, device=dev) if need_covs else None
    _walk_launch(knn_moments_rows, "sgt_knn_normals_covs", points, num_points, k, target,
                 (normals, covs))
    return normals, covs


# ---------------------------------------------------------------- K4 ----

def knn_topk_idx_plain(points: torch.Tensor, num_points: torch.Tensor, k: int,
                       rows: Optional[torch.Tensor] = None) -> Pair:
    """Plain PyTorch version of K4: brute-force self-kNN by stable sort
    (ties to the lower row), (d² [N,k] ascending, idx [N,k] int32); rows at
    or beyond ``num_points`` and slots without a neighbour hold d² = 3e38
    and index 0. ``rows`` [R] int64 restricts the queries to those rows
    ([R,k] outputs): brute force over a map-scale cloud is out of reach."""
    n = points.shape[0]
    rows = torch.arange(n, device=points.device) if rows is None else rows
    d, i = knn_plain(points, num_points, points[rows, :3], k)
    live = (rows < num_points)[:, None]
    return torch.where(live, d, _BIG), torch.where(live, i, 0)


def _walk_plain(points: torch.Tensor, num_points: torch.Tensor, k: int, team: int,
                cull_pass: int, outward: bool, target: Optional[PrunedTarget]) -> Pair:
    """The walk of K4 (``team`` 1), K3 and K5 over the cloud's sort and
    boxes (``morton_boxes.walk_lists_plain``): the valid rows in sorted order
    as the queries, each with its reach over its ``bound_window(k)``
    Morton-sorted neighbours, and each block's passes anchored at the box of
    its first row. Returns the merged lists in original row order as
    ``knn_topk_idx_plain`` does: equal to it."""
    _check_k(k)
    n = points.shape[0]
    dev, dt = points.device, points.dtype
    out_d = torch.full((n, k), _BIG, dtype=dt, device=dev)
    out_i = torch.zeros((n, k), dtype=torch.int32, device=dev)
    if target is None:
        target = pruned_prepare_target(points, num_points)
    m = min(int(num_points), n)
    if m == 0:
        return out_d, out_i
    xyz, orig = target.tsorted[:, :3], target.tperm
    w = bound_window(k)
    pos = torch.arange(m, device=dev)
    lo = torch.clamp(torch.clamp(pos - w // 2, max=m - w), min=0)
    reach = window_reach(xyz, m, xyz[:m], lo, w, k)
    block = BLOCK_ROWS // team
    anchors = [q0 // TILE_ROWS for q0 in range(0, m, block)]
    d, i = walk_lists_plain(xyz, orig, target.tbox, m, xyz[:m], reach, anchors, k, team,
                            cull_pass, outward)
    out_d[orig[:m]], out_i[orig[:m]] = d, i
    return out_d, out_i


def knn_topk_idx_walk_plain(points: torch.Tensor, num_points: torch.Tensor, k: int,
                            cull_pass: int = CULL_PASS, outward: bool = True,
                            target: Optional[PrunedTarget] = None) -> Pair:
    """Plain account of K4's pruned walk (``_walk_plain`` with one thread a
    query), with the outputs of ``knn_topk_idx_plain``."""
    return _walk_plain(points, num_points, k, 1, cull_pass, outward, target)


def knn_moments_walk_plain(points: torch.Tensor, num_points: torch.Tensor, k: int,
                           team: int = MOMENTS_TEAM, cull_pass: int = CULL_PASS,
                           target: Optional[PrunedTarget] = None) -> torch.Tensor:
    """Plain account of K3 (``team`` = ``MOMENTS_TEAM``) and of K5
    (``MOMENTS_Q_TEAM``): the walk of ``_walk_plain`` with ``team`` threads
    a query, the team's merged list, and the offsets d = p − q of its slots
    in slot order summed as ``knn_moments_rows_plain`` sums them — the same
    [N,16] rows, bit for bit."""
    n = points.shape[0]
    d_k, idx = _walk_plain(points, num_points, k, team, cull_pass, True, target)
    out = torch.zeros((n, 16), dtype=points.dtype, device=points.device)
    m = min(int(num_points), n)
    if m == 0:
        return out
    xyz = points[:, :3]
    gathered = xyz[idx[:m].long()]  # [m,k,3]
    off = [gathered[..., c] - xyz[:m, None, c] for c in range(3)]
    out[:m, :11] = _moment_rows(*off, d_k[:m])
    return out


def _topk_idx_launch(entry: str, target: PrunedTarget, num_points: torch.Tensor,
                     k: int) -> Pair:
    """Launch the K4 entry ``entry`` over the finished sort and boxes."""
    _check_k(k)
    _build.require(target.tsorted, "sorted rows", torch.float32, (None, 4))
    _build.require(num_points, "num_points", torch.int32, ())
    n = target.tsorted.shape[0]
    dev = target.tsorted.device
    d = torch.empty((n, k), dtype=torch.float32, device=dev)
    i = torch.empty((n, k), dtype=torch.int32, device=dev)
    if n == 0:
        return d, i
    lib = _library()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            target.tsorted.data_ptr(), num_points.data_ptr(), n, target.tbox.data_ptr(),
            k, bound_window(k), d.data_ptr(), i.data_ptr(), _stream())
    _build.check(rc, entry)
    return d, i


def knn_topk_idx_launch(target: PrunedTarget, num_points: torch.Tensor, k: int
                        ) -> Pair:
    """Kernel K4 alone, over the finished sort and boxes of the cloud."""
    out = _topk_idx_launch("sgt_knn_topk_idx", target, num_points, k)
    if target.tsorted.shape[0] > 0:
        knn_topk_idx.launches += 1
    return out


def _knn_topk_idx_v1(target: PrunedTarget, num_points: torch.Tensor, k: int) -> Pair:
    """K4's first form (one box after another, each tile staged
    synchronously), over the finished sort and boxes: the yardstick of the
    kernel above, on no path and counted nowhere."""
    return _topk_idx_launch("sgt_knn_topk_idx_v1", target, num_points, k)


def knn_topk_idx(points: torch.Tensor, num_points: torch.Tensor, k: int,
                 target: Optional[PrunedTarget] = None) -> Pair:
    """Indices and d² of every valid row's k nearest valid rows (self
    included): (d² [N,k] ascending, idx [N,k] int32), ties to the lower row;
    padding rows and empty slots hold d² = 3e38 and index 0. Kernel K4 on
    CUDA (over ``pruned_prepare_target``'s sort and boxes, which ``target``
    passes in when the caller has them), plain version on the CPU."""
    _check_k(k)
    if points.device.type == "cpu":
        return knn_topk_idx_plain(points, num_points, k)
    _build.require(points, "points", torch.float32, (None, 4))
    return knn_topk_idx_launch(_sorted_cloud(points, num_points, target), num_points, k)


knn_topk_idx.launches = 0


def moments_from_neighbors(points: torch.Tensor, sq_dists: torch.Tensor,
                           idx: torch.Tensor):
    """(m1, m2, counts) from gathered winners, query-centred, slots with
    d² ≥ 1e16 dropped (cov_fused_pallas.py:537-551)."""
    xyz = points[:, :3]
    nb = xyz[idx.long()] - xyz[:, None, :]  # [N,k,3]
    v = (sq_dists < _VALID_SQ).to(points.dtype)
    nbv = nb * v[:, :, None]
    return nbv.sum(dim=1), torch.einsum("nka,nkb->nab", nbv, nb), v.sum(dim=1)


# ---------------------------------------------------------- the entry ----

def auto_layout(num_rows: int) -> str:
    """The layout ``knn_moments(layout=None)`` takes for a cloud of
    ``num_rows`` rows (capacity, not valid rows)."""
    return "t" if num_rows <= TI_MIN_ROWS else "ti"


def knn_moments(points: torch.Tensor, num_points: torch.Tensor, k: int,
                layout: Optional[str] = None, target: Optional[PrunedTarget] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(m1 [N,3] = Σd, m2 [N,3,3] = Σddᵀ, counts [N]) in original row order.
    ``target``: the cloud's Morton sort and boxes, which every layout walks
    on the card (``KdTree.pruned_target()`` keeps them)."""
    if layout is None:
        layout = auto_layout(points.shape[0])
    if k > MAX_K:
        raise ValueError(f"knn_moments supports k<={MAX_K}, got {k}")
    if points.shape[0] > MAX_ROWS:
        raise ValueError(
            f"knn_moments serves clouds of at most {MAX_ROWS} rows, got "
            f"{points.shape[0]} (use the searched path, KdTree.knn_search, for "
            "larger clouds)")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (use 't', 'ti' or 'q')")
    if layout == "ti":
        return moments_from_neighbors(points, *knn_topk_idx(points, num_points, k,
                                                            target=target))
    rows = knn_moments_rows(points, num_points, k, layout, target=target)
    m1 = rows[:, 0:3]
    # Column views stacked (an index list would be copied to the card).
    m2 = torch.stack([rows[:, c] for c in (3, 4, 5, 4, 6, 7, 5, 7, 8)],
                     dim=1).reshape(-1, 3, 3)
    return m1, m2, rows[:, 9]
