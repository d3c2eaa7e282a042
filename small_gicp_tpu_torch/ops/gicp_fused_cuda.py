"""Fused correspondence search + linearize (K1, K6, K7) and LM trial errors
(K2, K8).

Counterpart of ``small_gicp_tpu/ops/gicp_fused_pallas.py``:

  * ``gicp_prepare`` builds the per-align tables once, for one of two
    routes: ``"listed"`` (K1; the default up to ``LISTED_MP_CAP`` target
    rows) or ``"swept"`` (K6, for map-scale targets). Both walk the
    Morton-sorted target rows and their tile boxes in the source's Morton
    order, all from ``ops/morton_boxes.py``, which the tables of one pair
    carry beside the clouds' own (the target's half depends on the target
    alone and can be passed in: a ``KdTree`` keeps it). The threshold is
    the JAX package's, set by TPU memory; either route can be forced;
  * ``gicp_linearize_tables`` → (H [6,6], b [6], inliers, corr [N,16]):
    exact 1-NN of T·p among the valid target rows within the rejector
    radius (ties to the lower index), the factor's weight W, the rejector
    mask d² ≤ max_d2, the optional Huber/Cauchy weight and the sums of
    J_iᵀW_iJ_i, J_iᵀW_ir_i, e_i and the inlier count. corr rows are [μ 3 |
    W 9 | mask | d² | 0 0] in original source order; a row without an
    accepted correspondence holds zeros and d² = 3e38 (its nearest row may
    lie in a tile that was never visited). It follows the tables' route:
    K1 (``gicp_linearize_listed``'s kernel) and K6 (``gicp_linearize_swept``)
    both visit only the target tiles within the rejector radius of a block
    of source rows and differ in their launch (K1 finishes the float64
    sums itself, K6 leaves them to torch); on the listed route
    ``mxu_dist=True`` ranks the targets by the score ‖t‖² − 2 t·q
    (``gicp_linearize_score``, K1's walk with a score offer) instead;
  * ``gicp_error_multi`` → [K1] float64: Σ ½ rᵀWr·mask at each of up to
    100 poses over frozen corr rows, re-weighted by w(√e) at each pose (on
    the card the errors-only mode of the LM step kernel, ``ops/lm_step.py``,
    which redesigned K2; its first form ``_gicp_error_multi_v1`` stays);
  * ``gicp_linearize_sums`` → (sums [44] float64, corr): one linearization
    in the form the LM step reads, K1's outputs kept in ``linearize_buffers``.

The fleet variants serve B lanes over U prepared pairs
(``parallel/fleet.py``): ``gicp_fleet_prepare`` stacks the tables of U
pairs and adds, per pair, the sorted target rows, boxes and source order;
``gicp_linearize_fleet`` (K7) is the swept search for lane b on pair
uids[b] at pose Ts[b] — K1's H, b, inliers and accepted corr rows,
unmatched rows zero with d² = 3e38 — and ``gicp_error_multi_fleet`` (K8)
is K2 for each lane. A lane reads its pair's tables in place; an inactive
lane returns zero sums and all-zero corr rows. Each fleet wrapper launches
one kernel of ``csrc/gicp_fleet.cu``, which finishes the float64 sums
itself.

Per-point terms are float32 on the card; sums across blocks are float64
and are handed on un-truncated. On a CUDA tensor the wrappers launch the
kernels of ``csrc/gicp_listed.cu``, ``csrc/gicp_fused.cu``,
``csrc/gicp_swept.cu`` and ``csrc/gicp_fleet.cu``; on a CPU tensor they run
the plain versions below, which repeat the kernels' arithmetic. The
single-pair plain versions are the fleet ones at one lane. K1's first
forms, a brute-force scan over every valid target row in source row order
by d² and by the score, stay as the yardsticks ``_gicp_linearize_v1`` and
``_gicp_linearize_score_v1`` (their kernel also serves the brute-force lane
entries).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from small_gicp_tpu_torch import _build
from small_gicp_tpu_torch.ops import knn_cuda, morton_boxes
from small_gicp_tpu_torch.ops.eigh3 import inv3x3
from small_gicp_tpu_torch.ops.knn import QUERY_BLOCK, sq_dists
from small_gicp_tpu_torch.ops.morton_boxes import (
    TILE_ROWS,
    PrunedTarget,
    morton_order,
    pruned_prepare_target,
)
from small_gicp_tpu_torch.utils.profiling import host_read

_BIG = 3.0e38
_NO_INDEX = 2 ** 31 - 1
ROUTES = ("listed", "swept")
# Targets above this many rows take the swept route by default
# (_LISTED_MP_CAP of gicp_fused_pallas.py).
LISTED_MP_CAP = 1_572_864
# Source rows per block of the swept kernel.
SWEPT_BLOCK_ROWS = morton_boxes.BLOCK_ROWS
# Blocks on each SM that the chunk plan of K6 and K1 aims at
# (tools/box_walk_sweep.py, tools/scan_walk_sweep.py).
SWEPT_BLOCKS_PER_SM = 32
# K6's per-row key with no winner posted: the kernel's ~0 (unsigned), here
# the largest int64, above every real key (whose top bit, d²'s sign, is 0).
SWEPT_KEY_NONE = 2 ** 63 - 1
FACTORS = ("gicp", "plane_icp", "icp")
ROBUST_KERNELS = ("huber", "cauchy")
MAX_POSES = 100
# The JAX fleet kernels keep each pair's target table resident in TPU
# memory and reject larger targets (gicp_fused_pallas.py:1343-1348); the
# port keeps the same contract.
MAX_FLEET_TARGET_ROWS = 65536


@dataclass
class GicpTables:
    """Per-align kernel tables (built once by ``gicp_prepare``).

    ttab [M,16]: x y z 0 | payload 9 (C_t row-major, or the target normal
    in 0-2, or zeros) | ‖t‖² 0 0.  qtab [N,16]: x y z 0 | C_s 9 | 0 0 0.
    Both stay in the clouds' row order on either route. The tables of one
    float32 pair (both routes) add the last four. Fleet tables (``gicp_fleet_prepare``) carry a
    leading [U] pair axis on every tensor, the last three included.
    """

    ttab: torch.Tensor
    tnum: torch.Tensor  # int32, valid target rows (0-d, or [U])
    qtab: torch.Tensor
    qnum: torch.Tensor  # int32, valid source rows (0-d, or [U])
    factor: str
    route: str = "listed"
    tsorted: Optional[torch.Tensor] = None  # [M,4] Morton-sorted x y z | row
    tbox: Optional[torch.Tensor] = None  # [ceil(M/256), 8] lo 3, 0, hi 3, 0
    sperm: Optional[torch.Tensor] = None  # [N] int32, sorted position → source row
    # Host copy of qnum (or a bound on it), read by the first launch of K1 or
    # K6 for its chunk plan: once per tables, unless gicp_prepare was given it.
    qnum_host: Optional[int] = None
    # ‖t‖² of the sorted target rows, padded to whole tiles: the score
    # form's table, gathered at its first launch (score_norms).
    tnorm: Optional[torch.Tensor] = None
    # K1's chunk plan (swept_plan), and whether the tables passed K1's
    # checks: both set once, by gicp_prepare on the card.
    chunks: Optional[int] = None
    checked: bool = False


@dataclass
class LinearizeBuffers:
    """K1's outputs, kept by an align across its iterations
    (``linearize_buffers``): corr [N,16] float32, the block partials
    [blocks, 44] float32 and the float64 sums [44] (H 36 | b 6 | e |
    inliers) that the LM step reads in place."""

    corr: torch.Tensor
    partials: torch.Tensor
    sums: torch.Tensor


def auto_route(target_points: torch.Tensor) -> str:
    """The route ``gicp_prepare(route=None)`` takes for this target: listed
    up to ``LISTED_MP_CAP`` rows (capacity, not valid rows) and for stacked
    tables, swept above."""
    return ("swept" if target_points.dim() == 2
            and target_points.shape[0] > LISTED_MP_CAP else "listed")


def gicp_prepare(target_points: torch.Tensor, target_num: torch.Tensor,
                 source_points: torch.Tensor, source_num: torch.Tensor,
                 factor: str = "gicp", target_covs: Optional[torch.Tensor] = None,
                 source_covs: Optional[torch.Tensor] = None,
                 target_normals: Optional[torch.Tensor] = None,
                 route: Optional[str] = None,
                 target: Optional[PrunedTarget] = None,
                 source_rows: Optional[int] = None) -> GicpTables:
    """Build the tables of one registration, once before the optimizer's
    loop. ``route``: ``"listed"``, ``"swept"`` or None for ``auto_route``.
    The tables keep the clouds' row order; those of one pair (either route;
    the listed route float32 only) add the sorted target rows, their boxes
    and the source's order. ``target`` is ``pruned_prepare_target(
    target_points, target_num)`` when the caller has it already (``KdTree``
    keeps it): then only the source is ordered here. The sort takes the
    target's first ``target_num`` live rows wherever they stand
    (``point_cloud.live_rows``). Leading dimensions of the clouds carry
    over to the tables (listed route only, without the sort:
    ``gicp_fleet_prepare`` adds each pair's). ``source_rows``: a host
    bound on the source's valid rows, which the chunk plans of K1 and K6 then
    take instead of reading the count from the card (``qnum_host``)."""
    if factor not in FACTORS:
        raise ValueError(f"unknown fused factor {factor!r}")
    if route is None:
        route = auto_route(target_points)
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r} (use 'listed' or 'swept')")
    if route == "swept" and (target_points.dim() != 2 or source_points.dim() != 2):
        raise ValueError("the swept route serves one pair, not stacked tables")
    dt = source_points.dtype
    ttab = target_points.new_zeros(target_points.shape[:-1] + (16,), dtype=dt)
    ttab[..., 0:3] = target_points[..., :3]
    if factor == "gicp":
        if target_covs is None or source_covs is None:
            raise ValueError("GICP requires source and target covariances")
        ttab[..., 4:13] = target_covs.flatten(-2)
    elif factor == "plane_icp":
        if target_normals is None:
            raise ValueError("point-to-plane ICP requires target normals")
        ttab[..., 4:7] = target_normals[..., :3]
    # ‖t‖² for the score form, in the order its kernel and plain version add.
    x, y, z = ttab[..., 0], ttab[..., 1], ttab[..., 2]
    ttab[..., 13] = x * x + y * y + z * z
    qtab = source_points.new_zeros(source_points.shape[:-1] + (16,))
    qtab[..., 0:3] = source_points[..., :3]
    if factor == "gicp":
        qtab[..., 4:13] = source_covs.flatten(-2)
    tables = GicpTables(ttab=ttab, tnum=target_num.to(torch.int32), qtab=qtab,
                        qnum=source_num.to(torch.int32), factor=factor, route=route,
                        qnum_host=source_rows)
    if route == "swept" or (target_points.dim() == 2 and dt == torch.float32):
        _add_sort(tables, target_points, source_points, target)
        if qtab.device.type == "cuda" and dt == torch.float32:
            _check_listed(tables)
    return tables


def _check_listed(tables: GicpTables) -> None:
    """K1's checks of one pair's tables and its chunk plan, once per tables."""
    f32 = torch.float32
    _build.require(tables.ttab, "ttab", f32, (None, 16))
    _build.require(tables.qtab, "qtab", f32, (None, 16))
    m, n = tables.ttab.shape[0], tables.qtab.shape[0]
    _build.require(tables.tsorted, "tsorted", f32, (m, 4))
    _build.require(tables.tbox, "tbox", f32, ((m + TILE_ROWS - 1) // TILE_ROWS, 8))
    _build.require(tables.sperm, "sperm", torch.int32, (n,))
    _build.require(tables.tnum, "tnum", torch.int32, ())
    _build.require(tables.qnum, "qnum", torch.int32, ())
    tables.chunks = swept_plan(tables) if n > 0 else 1
    tables.checked = True


def linearize_buffers(tables: GicpTables) -> LinearizeBuffers:
    """Output buffers of K1 (either form) for these tables of one pair."""
    n, dev = tables.qtab.shape[0], tables.qtab.device
    blocks = (n + SWEPT_BLOCK_ROWS - 1) // SWEPT_BLOCK_ROWS
    return LinearizeBuffers(
        corr=torch.empty((n, 16), dtype=torch.float32, device=dev),
        partials=torch.empty((max(blocks, 1), 44), dtype=torch.float32, device=dev),
        sums=torch.zeros(44, dtype=torch.float64, device=dev))


def _add_sort(tables: GicpTables, target_points: torch.Tensor,
              source_points: torch.Tensor, target: Optional[PrunedTarget]) -> None:
    """Give one pair's tables the target's Morton sort and boxes (``target``
    when the caller keeps them) and the source's Morton order."""
    dt = tables.qtab.dtype
    if target is None:
        target = pruned_prepare_target(target_points.to(dt), tables.tnum)
    elif (target.tsorted.shape[0] != target_points.shape[0]
          or target.tsorted.dtype != dt):
        raise ValueError("target= was not prepared from these target points")
    n = source_points.shape[0]
    valid = torch.arange(n, device=source_points.device) < tables.qnum
    tables.tsorted, tables.tbox = target.tsorted, target.tbox
    tables.sperm = morton_order(source_points[:, :3], valid)[1].to(torch.int32)


def gicp_fleet_prepare(target_points: torch.Tensor, target_num: torch.Tensor,
                       source_points: torch.Tensor, source_num: torch.Tensor,
                       factor: str = "gicp",
                       target_covs: Optional[torch.Tensor] = None,
                       source_covs: Optional[torch.Tensor] = None,
                       target_normals: Optional[torch.Tensor] = None) -> GicpTables:
    """``gicp_prepare`` over U stacked pairs: targets [U,M,4], sources
    [U,N,4], counts [U] (or one count for every pair) → tables with
    ttab [U,M,16], qtab [U,N,16], tnum and qnum [U] int32, and the swept
    route's fields of each pair as ``pruned_prepare_target`` and
    ``morton_order`` give them for that pair alone: tsorted [U,M,4], tbox
    [U,ceil(M/256),8], sperm [U,N] int32. No host read of the counts."""
    if target_points.dim() != 3 or source_points.dim() != 3:
        raise ValueError("fleet tables take [U,M,4] targets and [U,N,4] sources")
    u = target_points.shape[0]
    if source_points.shape[0] != u:
        raise ValueError(f"{u} targets but {source_points.shape[0]} sources")
    if factor == "gicp" and (target_covs is None or source_covs is None):
        raise ValueError("GICP fleet registration: both clouds need covs")
    if factor == "plane_icp" and target_normals is None:
        raise ValueError("plane-ICP fleet registration: targets need normals")
    if target_points.dtype != torch.float32 or source_points.dtype != torch.float32:
        raise ValueError("fleet registration runs the f32 fused kernels")

    def per_pair(num):
        return torch.as_tensor(num).reshape(-1).expand(u).to(torch.int32).contiguous()

    tables = gicp_prepare(target_points, per_pair(target_num), source_points,
                          per_pair(source_num), factor, target_covs, source_covs,
                          target_normals)
    # Each pair sorted and boxed on its own, by one sort over all pairs.
    target = pruned_prepare_target(target_points, tables.tnum)
    tables.tsorted, tables.tbox = target.tsorted, target.tbox
    dev, n = source_points.device, source_points.shape[1]
    valid = torch.arange(n, device=dev) < tables.qnum.to(dev)[:, None]
    tables.sperm = morton_order(source_points[..., :3], valid)[1].to(torch.int32)
    return tables


def _pose12(T: torch.Tensor, dtype) -> torch.Tensor:
    """[..., 4, 4] → [..., 12] = R row-major 9 | t 3."""
    return torch.cat([T[..., :3, :3].reshape(T.shape[:-2] + (9,)),
                      T[..., :3, 3]], dim=-1).to(dtype).contiguous()


def _robust_code(robust: Optional[str]) -> int:
    if robust is None:
        return 0
    if robust not in ROBUST_KERNELS:
        raise ValueError(f"unknown robust kernel {robust!r}")
    return 1 + ROBUST_KERNELS.index(robust)


def _robust_w(robust: Optional[str], c: float, e: torch.Tensor) -> torch.Tensor:
    """w(√e) as in the kernels: Huber min(1, c/√e), Cauchy c/(c + e), e ≥ 0."""
    e0 = torch.clamp(e, min=0.0)
    if robust == "huber":
        x = torch.sqrt(e0)
        return torch.where(x < c, torch.ones_like(x), c / torch.clamp(x, min=1e-30))
    return c / (c + e0)


def _finish(sums: torch.Tensor):
    """[..., 44] float64 sums → (H [..., 6, 6], b [..., 6], inliers [...])."""
    return sums[..., :36].unflatten(-1, (6, 6)), sums[..., 36:42], sums[..., 43]


def _require_fleet(tables: GicpTables) -> None:
    if tables.ttab.dim() != 3:
        raise ValueError("fleet kernels take the [U]-stacked tables of "
                         "gicp_fleet_prepare")


def _lane_pairs(tables: GicpTables, uids: torch.Tensor) -> torch.Tensor:
    """Each lane's pair index, clamped into [0, U) as the kernels clamp it."""
    _require_fleet(tables)
    return uids.to(device=tables.qtab.device, dtype=torch.int64).clamp(
        0, tables.ttab.shape[0] - 1)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ------------------------------------------------------------ K1, K7 ----

def _transform_lanes(qtab, pose):
    """T·p of the source rows in the kernels' order: qtab [B,N,16], pose
    [B,12] → [B,N,3]."""
    r, t = pose[:, :9, None], pose[:, 9:, None]  # [B,9,1], [B,3,1]
    px, py, pz = qtab[..., 0], qtab[..., 1], qtab[..., 2]  # [B,N]
    return torch.stack([r[:, 0] * px + r[:, 1] * py + r[:, 2] * pz + t[:, 0],
                        r[:, 3] * px + r[:, 4] * py + r[:, 5] * pz + t[:, 1],
                        r[:, 6] * px + r[:, 7] * py + r[:, 8] * pz + t[:, 2]], dim=-1)


def _finalize_plain_lanes(ttab, qtab, pose, q, active, best, best_d, max_dist_sq,
                          robust, robust_c, factor, zero_unmatched=False):
    """The kernels' finalize over B lanes: winners ``best`` [B,N] (rows of
    ttab; any row where ``best_d`` is 3e38) at ``best_d`` [B,N] for the
    transformed points q [B,N,3] → (sums [B,44] float64, corr [B,N,16]).
    ``zero_unmatched``: rows with mask = 0 hold zeros and d² = 3e38."""
    dt, dev = qtab.dtype, qtab.device
    bsz, n = qtab.shape[0], qtab.shape[1]
    px, py, pz = qtab[..., 0], qtab[..., 1], qtab[..., 2]
    found = active & (best_d < _BIG)
    best_d = torch.where(active, best_d, _BIG)
    rows = torch.where(found[..., None],
                       torch.gather(ttab, 1, best[..., None].expand(-1, -1, 16)), 0.0)
    mu, pay = rows[..., 0:3], rows[..., 4:13]
    mask = found & (best_d <= max_dist_sq) & (best_d < 0.5 * _BIG)

    R = pose[:, :9].reshape(bsz, 1, 3, 3)
    if factor == "gicp":
        W = inv3x3(pay.reshape(bsz, n, 3, 3)
                   + R @ qtab[..., 4:13].reshape(bsz, n, 3, 3) @ R.transpose(-1, -2))
    elif factor == "plane_icp":
        W = torch.diag_embed(pay[..., 0:3] ** 2)
    else:
        W = torch.eye(3, dtype=dt, device=dev).expand(bsz, n, 3, 3)
    if zero_unmatched:
        mu = torch.where(mask[..., None], mu, 0.0)
        W = torch.where(mask[..., None, None], W, 0.0)
        best_d = torch.where(mask, best_d, _BIG)

    res = mu - q
    Wr = (W @ res[..., None])[..., 0]
    e_i = 0.5 * torch.sum(res * Wr, dim=-1)
    wm = torch.ones_like(e_i) if robust is None else _robust_w(robust, robust_c, e_i)
    Jr = torch.stack([
        torch.stack([R[..., k, 1] * pz - R[..., k, 2] * py,
                     R[..., k, 2] * px - R[..., k, 0] * pz,
                     R[..., k, 0] * py - R[..., k, 1] * px], dim=-1)
        for k in range(3)
    ], dim=-2)  # R·skew(p), [B,N,3,3]
    J = torch.cat([Jr, (-R).expand(bsz, n, 3, 3)], dim=-1)  # [B,N,3,6]
    Jt = J.transpose(-1, -2)
    H_i = (Jt @ (W @ J)) * wm[..., None, None]
    b_i = (Jt @ Wr[..., None])[..., 0] * wm[..., None]
    per_point = torch.cat([H_i.reshape(bsz, n, 36), b_i, (e_i * wm)[..., None],
                           torch.ones_like(e_i)[..., None]], dim=-1)
    per_point = torch.where(mask[..., None], per_point, 0.0)
    sums = per_point.to(torch.float64).sum(1)

    corr = torch.cat([mu, W.reshape(bsz, n, 9), mask.to(dt)[..., None],
                      best_d[..., None], torch.zeros((bsz, n, 2), dtype=dt, device=dev)],
                     dim=-1)
    return sums, corr


def _linearize_plain_lanes(ttab, tnum, qtab, qnum, pose, max_dist_sq, robust,
                           robust_c, factor, score=False, zero_unmatched=False,
                           trows=None):
    """K1's arithmetic over B lanes: ttab [B,M,16], tnum [B], qtab [B,N,16],
    qnum [B], pose [B,12] → (sums [B,44] float64, corr [B,N,16]). ``score``:
    rank the targets by ‖t‖² − 2 t·q (‖t‖² from ttab column 13) and take
    the winner's difference-form d² afterwards. ``zero_unmatched``: see
    ``_finalize_plain_lanes``. ``trows`` [B,M] bool: the target rows
    searched (default: the first tnum)."""
    dt, dev = qtab.dtype, qtab.device
    bsz, n, m = qtab.shape[0], qtab.shape[1], ttab.shape[1]
    q = _transform_lanes(qtab, pose)

    active = torch.arange(n, device=dev) < qnum[:, None]
    best_d = torch.full((bsz, n), _BIG, dtype=dt, device=dev)
    best = torch.zeros((bsz, n), dtype=torch.int64, device=dev)
    if m > 0:
        if trows is None:
            trows = torch.arange(m, device=dev) < tnum[:, None]
        # Only the columns some lane searches, in row order (the first
        # minimum stays the first), and only the rows below the largest
        # count: a row without a searched column or past its lane's count
        # has no winner either way.
        cols = trows.any(0).nonzero()[:, 0]
        n_rows = min(n, int(qnum.max())) if bsz > 0 else 0
        tcol = trows[:, None, cols]
        step = max(1, QUERY_BLOCK // max(bsz, 1))
        tsel = ttab[:, cols]
        txyz = tsel[..., :3]
        for s in range(0, n_rows if cols.numel() else 0, step):
            qs = q[:, s:s + step]
            if score:
                dot = (qs[..., None, 0] * txyz[:, None, :, 0]
                       + qs[..., None, 1] * txyz[:, None, :, 1]
                       + qs[..., None, 2] * txyz[:, None, :, 2])
                d2 = tsel[:, None, :, 13] - 2.0 * dot
                d2 = torch.where(tcol & (d2 < _BIG), d2, _BIG)
            else:
                d2 = torch.where(tcol, sq_dists(qs, txyz), _BIG)
            # first minimum on ties
            best_d[:, s:s + step], sel = torch.min(d2, dim=-1)
            best[:, s:s + step] = cols[sel]
        if score:
            mu = torch.gather(ttab[..., :3], 1, best[..., None].expand(-1, -1, 3))
            diff = q - mu
            exact = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
                     + diff[..., 2] * diff[..., 2])
            best_d = torch.where(best_d < _BIG, exact, _BIG)
    return _finalize_plain_lanes(ttab, qtab, pose, q, active, best, best_d,
                                 max_dist_sq, robust, robust_c, factor, zero_unmatched)


def _target_rows(tables: GicpTables) -> torch.Tensor:
    """[M] bool: the target rows that the tables of one pair search — those
    of the sorted rows below tnum where the tables carry a float32 sort (the
    live rows wherever they stand, ``point_cloud.live_rows``), else the
    first tnum."""
    m, dev = tables.ttab.shape[0], tables.ttab.device
    first = torch.arange(m, device=dev) < tables.tnum
    if tables.tsorted is None or tables.tsorted.dtype != torch.float32:
        return first
    orig = tables.tsorted[:, 3].contiguous().view(torch.int32).long()
    return torch.zeros(m, dtype=torch.bool, device=dev).index_put_((orig,), first)


def _plain_one_pair(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                    robust: Optional[str], robust_c: float, **kind):
    """``_linearize_plain_lanes`` for the tables of one pair at one pose."""
    _robust_code(robust)
    sums, corr = _linearize_plain_lanes(
        tables.ttab[None], tables.tnum.reshape(1), tables.qtab[None],
        tables.qnum.reshape(1), _pose12(T, tables.qtab.dtype)[None], max_dist_sq,
        robust, robust_c, tables.factor, trows=_target_rows(tables)[None], **kind)
    return (*_finish(sums[0]), corr[0])


def gicp_linearize_plain(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                         robust: Optional[str] = None, robust_c: float = 1.0,
                         score: bool = False):
    """Plain PyTorch version of K1's first form (``score``: of its
    score-form instance): rows without an accepted correspondence hold the
    nearest row all the same."""
    return _plain_one_pair(tables, T, max_dist_sq, robust, robust_c, score=score)


def gicp_linearize_listed_plain(tables: GicpTables, T: torch.Tensor,
                                max_dist_sq: float, robust: Optional[str] = None,
                                robust_c: float = 1.0):
    """Plain PyTorch version of K1: brute force over every valid target row;
    on a row whose nearest row lies within the rejector radius that row is
    K1's winner too, since the box cull never drops an acceptable row
    (``swept_live_tiles``); every other row holds zeros and d² = 3e38 in
    both. Same outputs as ``gicp_linearize_tables`` on the listed route;
    ``gicp_linearize_swept_split_plain`` is the step-by-step account of
    the kernel's walk."""
    return _plain_one_pair(tables, T, max_dist_sq, robust, robust_c,
                           zero_unmatched=True)


def gicp_linearize_score_plain(tables: GicpTables, T: torch.Tensor,
                               max_dist_sq: float, robust: Optional[str] = None,
                               robust_c: float = 1.0):
    """Plain PyTorch version of K1's score form: brute force over every
    valid target row by the score, the winner's exact d², and rows without
    an accepted correspondence zeroed with d² = 3e38. On every row whose
    winner is accepted, the kernel's box walk picks the same winner (its
    tile lies within the rejector radius of the row, so it is scanned);
    ``gicp_linearize_score_walk_plain`` is the step-by-step account."""
    return _plain_one_pair(tables, T, max_dist_sq, robust, robust_c, score=True,
                           zero_unmatched=True)


def score_norms(tables: GicpTables) -> torch.Tensor:
    """[ceil(M/256)·256] ‖t‖² of the sorted target rows — ttab column 13
    gathered by tsorted's original rows, zeros beyond — which the score
    form's walk stages beside the tiles; gathered once per tables."""
    if tables.tnorm is None:
        _require_swept(tables)
        if tables.ttab.dtype != torch.float32:
            raise ValueError("the score form's walk runs float32 tables")
        m = tables.ttab.shape[0]
        orig = tables.tsorted[:, 3].contiguous().view(torch.int32).long()
        tnorm = tables.ttab.new_zeros(-(-m // TILE_ROWS) * TILE_ROWS)
        tnorm[:m] = tables.ttab[orig, 13]
        tables.tnorm = tnorm
    return tables.tnorm


def gicp_linearize_score_walk_plain(tables: GicpTables, T: torch.Tensor,
                                    max_dist_sq: float, robust: Optional[str] = None,
                                    robust_c: float = 1.0):
    """Plain account of K1's score form on the card: for every block of 64
    Morton-sorted source rows, the live tiles by their boxes
    (``swept_live_tiles``); for each of its rows, every row of those tiles
    whose box lies within ``max_dist_sq`` of the row's point (a NaN gap
    keeps the tile), ranked by the score ‖t‖² − 2 t·q (``score_norms``) in
    (score, original row) order; the winner's exact d², then K1's finalize
    with unmatched rows zeroed. (The launch's chunks deal out the tiles and
    merge their winners in the same order, so they change nothing.)"""
    _robust_code(robust)
    _require_swept(tables)
    qtab, dev, dt = tables.qtab, tables.qtab.device, tables.qtab.dtype
    n = qtab.shape[0]
    pose = _pose12(T.to(dev), dt)[None]
    q = _transform_lanes(qtab[None], pose)[0]
    live = swept_live_tiles(tables, T, max_dist_sq)
    norms = score_norms(tables)
    m = min(int(tables.tnum), tables.tsorted.shape[0])
    orig = tables.tsorted[:, 3].contiguous().view(torch.int32).long()
    best_s = torch.full((n,), _BIG, dtype=dt, device=dev)
    best = torch.zeros(n, dtype=torch.int64, device=dev)
    sperm = tables.sperm.long()
    cols = torch.arange(TILE_ROWS, device=dev)
    for b in range(live.shape[0]):
        tiles = live[b].nonzero()[:, 0]
        if len(tiles) == 0:
            continue
        rows = sperm[b * SWEPT_BLOCK_ROWS:(b + 1) * SWEPT_BLOCK_ROWS]
        qb = q[rows]
        box = tables.tbox[tiles]
        g = torch.clamp(torch.maximum(box[None, :, 0:3] - qb[:, None],
                                      qb[:, None] - box[None, :, 4:7]), min=0.0)
        near = ~(g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]
                 > max_dist_sq)  # [rows, tiles]
        sel = (tiles[:, None] * TILE_ROWS + cols).reshape(-1)
        of_tile = torch.arange(len(tiles), device=dev).repeat_interleave(TILE_ROWS)
        keep = sel < m
        sel, of_tile = sel[keep], of_tile[keep]
        # Columns in ascending original row: the first minimum is the lower
        # original row among equal scores.
        ids, by_id = torch.sort(orig[sel])
        sel, of_tile = sel[by_id], of_tile[by_id]
        t = tables.tsorted[sel, :3]
        dot = (qb[:, None, 0] * t[None, :, 0] + qb[:, None, 1] * t[None, :, 1]
               + qb[:, None, 2] * t[None, :, 2])
        score = norms[sel][None, :] - 2.0 * dot
        score = torch.where(near[:, of_tile] & (score < _BIG), score, _BIG)
        best_s[rows], j = torch.min(score, dim=1)
        best[rows] = ids[j]
    mu = tables.ttab[best, :3]
    diff = q - mu
    exact = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2]
    best_d = torch.where(best_s < _BIG, exact, _BIG)
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    active[sperm] = torch.arange(n, device=dev) < tables.qnum
    sums, corr = _finalize_plain_lanes(
        tables.ttab[None], qtab[None], pose, q[None], active[None], best[None],
        best_d[None], max_dist_sq, robust, robust_c, tables.factor,
        zero_unmatched=True)
    return (*_finish(sums[0]), corr[0])


def _gicp_linearize_cuda(wrapper, entry: str, tables: GicpTables, T: torch.Tensor,
                         max_dist_sq: float, robust: Optional[str], robust_c: float,
                         out: Optional[LinearizeBuffers] = None):
    """Launch the entry ``entry`` of K1's first-form kernel and count it on
    ``wrapper`` (None: not counted); ``out``: corr and the sums go there."""
    f32 = torch.float32
    _build.require(tables.ttab, "ttab", f32, (None, 16))
    _build.require(tables.qtab, "qtab", f32, (None, 16))
    _build.require(tables.tnum, "tnum", torch.int32, ())
    _build.require(tables.qnum, "qnum", torch.int32, ())
    n = tables.qtab.shape[0]
    dev = tables.qtab.device
    pose = _pose12(T.to(dev), f32)
    corr = torch.empty((n, 16), dtype=f32, device=dev) if out is None else out.corr
    if n == 0:
        return (*_finish(torch.zeros(44, dtype=torch.float64, device=dev)), corr)
    lib = _build.library("gicp_fused")
    rows = lib.sgt_linearize_block_rows()
    partials = torch.empty(((n + rows - 1) // rows, 44), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            tables.ttab.data_ptr(), tables.tnum.data_ptr(), tables.qtab.data_ptr(),
            tables.qnum.data_ptr(), n, pose.data_ptr(), float(max_dist_sq),
            float(robust_c), FACTORS.index(tables.factor), _robust_code(robust),
            corr.data_ptr(), partials.data_ptr(), _stream(),
        )
    _build.check(rc, entry)
    if wrapper is not None:
        wrapper.launches += 1
    sums = partials.to(torch.float64).sum(0)
    if out is not None:
        sums = out.sums.copy_(sums)
    return (*_finish(sums), corr)


def _gicp_linearize_v1(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                       robust: Optional[str] = None, robust_c: float = 1.0,
                       out: Optional[LinearizeBuffers] = None):
    """K1's first form (a thread a source row in row order, a scan of every
    valid target row; rows without an accepted correspondence hold their
    nearest row): the yardstick of the kernel below, on no path and counted
    nowhere."""
    return _gicp_linearize_cuda(None, "sgt_gicp_linearize", tables, T, max_dist_sq,
                                robust, robust_c, out)


def _gicp_linearize_score_v1(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                             robust: Optional[str] = None, robust_c: float = 1.0):
    """The first form of K1's score form (a thread a source row in row
    order, a scan of every valid target row; rows without an accepted
    correspondence hold their nearest row by the score): the yardstick of
    the kernel below, on no path and counted nowhere."""
    return _gicp_linearize_cuda(None, "sgt_gicp_linearize_score", tables, T,
                                max_dist_sq, robust, robust_c)


def gicp_linearize_score(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                         robust: Optional[str] = None, robust_c: float = 1.0):
    """K1 with the targets ranked by the score ‖t‖² − 2 t·q (uncentred,
    ‖t‖² from the table) and the winner's exact d² taken afterwards: the
    ``mxu_dist=True`` branch of the JAX kernel, on CUDA cores, over K1's box
    walk (the tiles within the rejector radius of a block of source rows).
    Near-exact: between two targets whose d² differ by less than the score's
    float32 rounding (~‖q‖²·2⁻²³) it may pick the other. Same outputs as
    ``gicp_linearize_tables`` there: rows without an accepted
    correspondence hold zeros and d² = 3e38. Kernel on CUDA (float32 tables
    of one pair), plain version on the CPU."""
    if tables.qtab.device.type == "cpu":
        return gicp_linearize_score_plain(tables, T, max_dist_sq, robust, robust_c)
    return _gicp_linearize_listed_cuda(tables, T, max_dist_sq, robust, robust_c,
                                       score=True)


gicp_linearize_score.launches = 0


# ---------------------------------------------------------------- K6 ----

def _require_swept(tables: GicpTables) -> None:
    if tables.tsorted is None or tables.tbox is None or tables.sperm is None:
        raise ValueError("the swept route needs tables from "
                         "gicp_prepare(..., route='swept')")


def _live_tiles_lanes(qtab, sperm, qnum, pose, tbox, tnum, max_dist_sq):
    """Over B lanes: qtab [B,N,16], sperm [B,N], qnum [B], pose [B,12], tbox
    [B,T,8], tnum [B] → [B, blocks, T] bool, the tiles that a block of 64
    Morton-sorted source rows stages (see ``swept_live_tiles``)."""
    dev = qtab.device
    bsz, n = qtab.shape[:2]
    nb = (n + SWEPT_BLOCK_ROWS - 1) // SWEPT_BLOCK_ROWS
    q = _transform_lanes(qtab, pose)  # [B,N,3]
    pos = torch.arange(nb * SWEPT_BLOCK_ROWS, device=dev)
    order = torch.cat([sperm.long(), sperm.new_zeros((bsz, len(pos) - n),
                                                      dtype=torch.int64)], dim=1)
    valid = (pos < torch.clamp(qnum, max=n)[:, None]).view(bsz, nb, SWEPT_BLOCK_ROWS, 1)
    qs = torch.gather(q, 1, order[..., None].expand(-1, -1, 3)).view(
        bsz, nb, SWEPT_BLOCK_ROWS, 3)
    lo = torch.where(valid, qs, _BIG).amin(dim=2)  # [B,nb,3]
    hi = torch.where(valid, qs, -_BIG).amax(dim=2)
    g = torch.clamp(torch.maximum(tbox[:, None, :, 0:3] - hi[:, :, None],
                                  lo[:, :, None] - tbox[:, None, :, 4:7]), min=0.0)
    gap2 = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]
    holds_row = torch.arange(tbox.shape[1], device=dev) * TILE_ROWS < tnum[:, None]
    return ~(gap2 > max_dist_sq) & holds_row[:, None, :] & valid[:, :, :1, 0]


def swept_live_tiles(tables: GicpTables, T: torch.Tensor, max_dist_sq: float
                     ) -> torch.Tensor:
    """[blocks, tiles] bool: the target tiles that the swept search stages
    for each block of 64 Morton-sorted source rows at pose T — those whose
    box gap² to the box of the block's transformed valid rows does not
    exceed ``max_dist_sq`` (a NaN gap keeps the tile) and that hold a
    valid row."""
    _require_swept(tables)
    qtab, dev = tables.qtab, tables.qtab.device
    return _live_tiles_lanes(qtab[None], tables.sperm[None], tables.qnum.reshape(1),
                             _pose12(T.to(dev), qtab.dtype)[None], tables.tbox[None],
                             tables.tnum.reshape(1), max_dist_sq)[0]


def gicp_linearize_swept_plain(tables: GicpTables, T: torch.Tensor,
                               max_dist_sq: float, robust: Optional[str] = None,
                               robust_c: float = 1.0):
    """Plain PyTorch version of K6: for every block of 64 Morton-sorted
    source rows, the live tiles by their boxes, the distances to the sorted
    rows of those tiles, the nearest with d² ≤ max_dist_sq in (d², original
    row) order, then K1's finalize with unmatched rows zeroed. (The kernel
    also skips, warp by warp, staged tiles that cannot improve on a row's
    best so far; the rows it skips beyond these cannot win either.)"""
    _robust_code(robust)
    _require_swept(tables)
    qtab, dev, dt = tables.qtab, tables.qtab.device, tables.qtab.dtype
    n = qtab.shape[0]
    pose = _pose12(T.to(dev), dt)[None]
    q = _transform_lanes(qtab[None], pose)[0]
    live = swept_live_tiles(tables, T, max_dist_sq)
    m = min(int(tables.tnum), tables.tsorted.shape[0])
    tile_of_row = torch.arange(m, device=dev) // TILE_ROWS
    if dt != torch.float32:
        raise ValueError("the swept route runs float32 tables")
    orig = tables.tsorted[:, 3].contiguous().view(torch.int32).long()
    best_d = torch.full((n,), _BIG, dtype=dt, device=dev)
    best = torch.zeros(n, dtype=torch.int64, device=dev)
    sperm = tables.sperm.long()
    for b in range(live.shape[0]):
        sel = live[b, tile_of_row].nonzero()[:, 0]
        if len(sel) == 0:
            continue
        rows = sperm[b * SWEPT_BLOCK_ROWS:(b + 1) * SWEPT_BLOCK_ROWS]
        # Columns in ascending original row, so that the first minimum is
        # the lower original row among equal distances.
        ids, by_id = torch.sort(orig[sel])
        d2 = sq_dists(q[rows], tables.tsorted[sel[by_id], :3])
        d2 = torch.where(d2 <= max_dist_sq, d2, _BIG)
        best_d[rows], j = torch.min(d2, dim=1)
        best[rows] = ids[j]
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    active[sperm] = torch.arange(n, device=dev) < tables.qnum
    sums, corr = _finalize_plain_lanes(
        tables.ttab[None], qtab[None], pose, q[None], active[None], best[None],
        best_d[None], max_dist_sq, robust, robust_c, tables.factor,
        zero_unmatched=True)
    return (*_finish(sums[0]), corr[0])


def swept_chunks(valid_rows: int, mcap: int, sms: int) -> int:
    """Chunks per source block of K6 and K1 for ``valid_rows`` valid source
    rows and a target of capacity ``mcap`` on a card of ``sms`` SMs: enough
    that the valid source blocks times the chunks reach
    ``SWEPT_BLOCKS_PER_SM`` blocks on each SM, but no more than the target
    has tiles (the most live tiles a block can feed). One where the source
    blocks alone reach it."""
    blocks = -(-max(valid_rows, 1) // SWEPT_BLOCK_ROWS)
    return max(1, min(-(-SWEPT_BLOCKS_PER_SM * sms // blocks),
                      -(-max(mcap, 1) // TILE_ROWS), 65535))


def swept_plan(tables: GicpTables) -> int:
    """The chunk count that K6 and K1 launch with on these tables (CUDA):
    ``swept_chunks`` of the valid source rows, read from the card once per
    tables (``qnum_host``)."""
    if tables.qnum_host is None:
        with host_read("source_rows"):
            tables.qnum_host = int(tables.qnum)
    return swept_chunks(min(tables.qnum_host, tables.qtab.shape[0]),
                        tables.ttab.shape[0],
                        knn_cuda._sm_count(tables.qtab.device.index or 0))


def swept_chunk_tiles(live: torch.Tensor, chunks: int) -> torch.Tensor:
    """[blocks, tiles] int64: the chunk of K6 that scans each live tile
    (``swept_live_tiles``), -1 where a tile is not live. Chunk s of a block
    takes the block's live tiles whose ordinal among them, in ascending
    tile order, is s modulo ``chunks``, as the kernel deals them out of its
    cull passes."""
    ordinal = torch.cumsum(live.long(), dim=1) - 1
    return torch.where(live, ordinal % chunks, -1)


def swept_key(d2: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """K6's 64-bit key of a winner (d² float32 ≥ +0, original row): d²'s
    bits above the row, as int64; -0 counts as +0. Smaller keys are
    smaller d², and on a tie the lower row."""
    bits = (d2.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (bits << 32) | row.to(torch.int64)


def gicp_linearize_swept_split_plain(tables: GicpTables, T: torch.Tensor,
                                     max_dist_sq: float, robust: Optional[str] = None,
                                     robust_c: float = 1.0, chunks: int = 1):
    """Plain account of K6 over ``chunks`` chunks per source block: each
    chunk's tiles (``swept_chunk_tiles``), each chunk's winner for each of
    the block's valid rows — the smallest ``swept_key`` over its rows with
    d² ≤ max_dist_sq — the smallest key over the chunks, decoded, then
    K1's finalize with unmatched rows zeroed. The same outputs as
    ``gicp_linearize_swept_plain`` for every chunk count."""
    _robust_code(robust)
    _require_swept(tables)
    qtab, dev, dt = tables.qtab, tables.qtab.device, tables.qtab.dtype
    if dt != torch.float32:
        raise ValueError("the swept route runs float32 tables")
    n = qtab.shape[0]
    pose = _pose12(T.to(dev), dt)[None]
    q = _transform_lanes(qtab[None], pose)[0]
    plan = swept_chunk_tiles(swept_live_tiles(tables, T, max_dist_sq), chunks)
    m = min(int(tables.tnum), tables.tsorted.shape[0])
    nv = min(int(tables.qnum), n)
    orig = tables.tsorted[:, 3].contiguous().view(torch.int32).long()
    sperm = tables.sperm.long()
    keys = torch.full((n,), SWEPT_KEY_NONE, dtype=torch.int64, device=dev)
    cols = torch.arange(TILE_ROWS, device=dev)
    for b in range(-(-nv // SWEPT_BLOCK_ROWS)):
        tiles = (plan[b] >= 0).nonzero()[:, 0]
        if len(tiles) == 0:
            continue
        pos = torch.arange(b * SWEPT_BLOCK_ROWS, min(nv, (b + 1) * SWEPT_BLOCK_ROWS),
                           device=dev)
        rows = (tiles[:, None] * TILE_ROWS + cols).reshape(-1)
        chunk = plan[b, tiles].repeat_interleave(TILE_ROWS)
        keep = rows < m
        rows, chunk = rows[keep], chunk[keep]
        d2 = sq_dists(q[sperm[pos]], tables.tsorted[rows, :3])
        k = torch.where(d2 <= max_dist_sq, swept_key(d2, orig[rows]), SWEPT_KEY_NONE)
        per_chunk = torch.full((len(pos), chunks), SWEPT_KEY_NONE, dtype=torch.int64,
                               device=dev).scatter_reduce(
            1, chunk[None].expand(len(pos), -1), k, "amin")
        keys[pos] = per_chunk.amin(dim=1)
    found = keys != SWEPT_KEY_NONE
    best_d = torch.where(found, (keys >> 32).to(torch.int32).view(torch.float32), _BIG)
    best_pos = torch.where(found, keys & 0xFFFFFFFF, 0)
    best_d_rows = torch.full((n,), _BIG, dtype=dt, device=dev)
    best_rows = torch.zeros(n, dtype=torch.int64, device=dev)
    best_d_rows[sperm], best_rows[sperm] = best_d, best_pos
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    active[sperm] = torch.arange(n, device=dev) < tables.qnum
    sums, corr = _finalize_plain_lanes(
        tables.ttab[None], qtab[None], pose, q[None], active[None], best_rows[None],
        best_d_rows[None], max_dist_sq, robust, robust_c, tables.factor,
        zero_unmatched=True)
    return (*_finish(sums[0]), corr[0])


@dataclass
class _SweptBuffers:
    """The per-row keys (~0, here -1, between launches) and the source
    blocks' tickets (0 between launches; K1 adds one for its final sum) of
    K6 and K1: every launch leaves them so."""

    keys: torch.Tensor  # int64 [≥ N]
    tickets: torch.Tensor  # int32 [≥ source blocks]


_swept_buffers: Dict[Tuple[int, int], _SweptBuffers] = {}


def _swept_workspace(dev: torch.device, n: int, blocks: int) -> _SweptBuffers:
    """The buffers of one device and stream, on which launches run in
    order, grown to hold a launch's needs; set once, at allocation."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    b = _swept_buffers.get(key)
    if b is None:
        b = _swept_buffers[key] = _SweptBuffers(
            keys=torch.full((0,), -1, dtype=torch.int64, device=dev),
            tickets=torch.zeros(0, dtype=torch.int32, device=dev))
    if b.keys.numel() < n:
        b.keys = torch.full((max(n, 1024),), -1, dtype=torch.int64, device=dev)
    if b.tickets.numel() < blocks:
        b.tickets = torch.zeros(max(blocks, 1024), dtype=torch.int32, device=dev)
    return b


def _swept_launch(entry: str, tables: GicpTables, T: torch.Tensor,
                  max_dist_sq: float, robust: Optional[str], robust_c: float,
                  chunks: Optional[int]):
    """Launch the K6 entry ``entry``; ``chunks`` None is the first form."""
    f32 = torch.float32
    _build.require(tables.ttab, "ttab", f32, (None, 16))
    m = tables.ttab.shape[0]
    _build.require(tables.tsorted, "tsorted", f32, (m, 4))
    _build.require(tables.tbox, "tbox", f32, ((m + TILE_ROWS - 1) // TILE_ROWS, 8))
    _build.require(tables.qtab, "qtab", f32, (None, 16))
    n = tables.qtab.shape[0]
    _build.require(tables.sperm, "sperm", torch.int32, (n,))
    _build.require(tables.tnum, "tnum", torch.int32, ())
    _build.require(tables.qnum, "qnum", torch.int32, ())
    dev = tables.qtab.device
    pose = _pose12(T.to(dev), f32)
    corr = torch.empty((n, 16), dtype=f32, device=dev)
    if n == 0:
        return (*_finish(torch.zeros(44, dtype=torch.float64, device=dev)), corr)
    lib = morton_boxes.library("gicp_swept")
    blocks = (n + SWEPT_BLOCK_ROWS - 1) // SWEPT_BLOCK_ROWS
    partials = torch.empty((blocks, 44), dtype=f32, device=dev)
    args = [tables.ttab.data_ptr(), tables.tsorted.data_ptr(), tables.tbox.data_ptr(),
            tables.tnum.data_ptr(), m, tables.qtab.data_ptr(), tables.sperm.data_ptr(),
            tables.qnum.data_ptr(), n, pose.data_ptr(), float(max_dist_sq),
            float(robust_c), FACTORS.index(tables.factor), _robust_code(robust)]
    if chunks is None:
        args += [corr.data_ptr(), partials.data_ptr()]
    else:
        ws = _swept_workspace(dev, n, blocks)
        args += [int(chunks), corr.data_ptr(), partials.data_ptr(), ws.keys.data_ptr(),
                 ws.tickets.data_ptr()]
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, _stream())
    _build.check(rc, entry)
    return (*_finish(partials.to(torch.float64).sum(0)), corr)


def _gicp_linearize_swept_cuda(tables: GicpTables, T: torch.Tensor,
                               max_dist_sq: float, robust: Optional[str],
                               robust_c: float, chunks: Optional[int] = None):
    """Kernel K6 at ``chunks`` chunks per source block (None: ``swept_plan``)."""
    _build.require(tables.qtab, "qtab", torch.float32, (None, 16))
    if tables.qtab.shape[0] > 0 and chunks is None:
        chunks = swept_plan(tables)
    out = _swept_launch("sgt_gicp_linearize_swept", tables, T, max_dist_sq, robust,
                        robust_c, chunks or 1)
    if tables.qtab.shape[0] > 0:
        gicp_linearize_swept.launches += 1
    return out


def _gicp_linearize_swept_v1(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                             robust: Optional[str] = None, robust_c: float = 1.0):
    """K6's first form (one block per source block, the boxes tested one
    after another): the yardstick of the kernel above, on no path and
    counted nowhere."""
    return _swept_launch("sgt_gicp_linearize_swept_v1", tables, T, max_dist_sq, robust,
                         robust_c, None)


def gicp_linearize_swept(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                         robust: Optional[str] = None, robust_c: float = 1.0):
    """One linearization at T over swept tables: kernel K6 on CUDA, plain
    version on the CPU. Same outputs as ``gicp_linearize_tables``."""
    _require_swept(tables)
    if tables.qtab.device.type == "cpu":
        return gicp_linearize_swept_plain(tables, T, max_dist_sq, robust, robust_c)
    return _gicp_linearize_swept_cuda(tables, T, max_dist_sq, robust, robust_c)


gicp_linearize_swept.launches = 0


# ---------------------------------------------------------------- K1 ----

def _gicp_linearize_listed_cuda(tables: GicpTables, T: torch.Tensor,
                                max_dist_sq: float, robust: Optional[str],
                                robust_c: float, chunks: Optional[int] = None,
                                score: bool = False,
                                out: Optional[LinearizeBuffers] = None):
    """Kernel K1 at ``chunks`` chunks per source block (None: the tables'
    plan), counted on ``gicp_linearize_tables``; ``score``: its score form,
    counted on ``gicp_linearize_score``. ``out``: the output buffers
    (``linearize_buffers``), else new ones. The tables' checks and plan are
    made once per tables (``gicp_prepare`` makes them on the card)."""
    f32 = torch.float32
    if not tables.checked:
        _check_listed(tables)
    n = tables.qtab.shape[0]
    dev = tables.qtab.device
    pose = T
    if not (T.is_cuda and T.dtype == f32 and T.is_contiguous()):
        pose = T.to(device=dev, dtype=f32).contiguous()
    _build.require(pose, "T", f32, (4, 4))
    if out is None:
        out = linearize_buffers(tables)
    corr = out.corr
    if n == 0:
        return (*_finish(out.sums.zero_()), corr)
    lib = morton_boxes.library("gicp_listed")
    blocks = (n + SWEPT_BLOCK_ROWS - 1) // SWEPT_BLOCK_ROWS
    partials, sums = out.partials, out.sums
    ws = _swept_workspace(dev, n, blocks + 1)
    args = [tables.ttab.data_ptr(), tables.tsorted.data_ptr()]
    if score:
        args.append(score_norms(tables).data_ptr())
    args += [tables.tbox.data_ptr(), tables.tnum.data_ptr(), tables.ttab.shape[0],
             tables.qtab.data_ptr(), tables.sperm.data_ptr(), tables.qnum.data_ptr(), n,
             pose.data_ptr(), float(max_dist_sq), float(robust_c),
             FACTORS.index(tables.factor), _robust_code(robust),
             int(chunks or tables.chunks), corr.data_ptr(),
             partials.data_ptr(), ws.keys.data_ptr(), ws.tickets.data_ptr(),
             sums.data_ptr(), _stream()]
    entry = "sgt_gicp_linearize_listed_score" if score else "sgt_gicp_linearize_listed"
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args)
    _build.check(rc, entry)
    (gicp_linearize_score if score else gicp_linearize_tables).launches += 1
    return (*_finish(sums), corr)


def gicp_linearize_tables(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                          robust: Optional[str] = None, robust_c: float = 1.0,
                          mxu_dist: bool = False, route: Optional[str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One linearization at T: (H [6,6] f64, b [6] f64, inliers f64, corr [N,16]).

    ``route`` overrides the tables' own (``"listed"`` works on any tables of
    one pair, ``"swept"`` on tables prepared for it). The listed route is
    kernel K1 on CUDA and its plain version on the CPU. ``mxu_dist`` takes
    the score form on the listed route and is ignored on the swept one, as
    the JAX flag is off its row-major listed path."""
    route = tables.route if route is None else route
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r} (use 'listed' or 'swept')")
    if route == "swept":
        return gicp_linearize_swept(tables, T, max_dist_sq, robust, robust_c)
    if mxu_dist:
        return gicp_linearize_score(tables, T, max_dist_sq, robust, robust_c)
    if tables.qtab.device.type == "cpu":
        return gicp_linearize_listed_plain(tables, T, max_dist_sq, robust, robust_c)
    return _gicp_linearize_listed_cuda(tables, T, max_dist_sq, robust, robust_c)


gicp_linearize_tables.launches = 0


def gicp_linearize_sums(tables: GicpTables, T: torch.Tensor, max_dist_sq: float,
                        robust: Optional[str] = None, robust_c: float = 1.0,
                        out: Optional[LinearizeBuffers] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gicp_linearize_tables`` on the tables' route as (sums [44] float64:
    H 36 | b 6 | e | inliers, corr [N,16]), the input of the LM step. On the
    card's listed route K1 writes them into ``out`` (``linearize_buffers``;
    new ones if None) and nothing else runs; elsewhere they are packed from
    the route's outputs (e is then 0: the step does not read it)."""
    if tables.route == "listed" and tables.qtab.device.type == "cuda":
        out = out if out is not None else linearize_buffers(tables)
        corr = _gicp_linearize_listed_cuda(tables, T, max_dist_sq, robust, robust_c,
                                           out=out)[3]
        return out.sums, corr
    H, b, inliers, corr = gicp_linearize_tables(tables, T, max_dist_sq, robust,
                                                robust_c)
    return torch.cat([H.reshape(36), b, H.new_zeros(1),
                      inliers.reshape(1).to(H.dtype)]), corr


# ---------------------------------------------------------------- K7 ----

_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _lane_tickets(dev: torch.device, bsz: int) -> torch.Tensor:
    """[≥ bsz] int32 counters in which the fleet kernels' lanes count their
    finished blocks. Each lane's last block sets its counter back to 0, so
    the buffer is zero between launches; one buffer per device and stream,
    on which launches run in order."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < bsz:
        t = _tickets[key] = torch.zeros(max(bsz, 64), dtype=torch.int32, device=dev)
    return t


def _require_fleet_swept(tables: GicpTables) -> None:
    _require_fleet(tables)
    if tables.tsorted is None or tables.tbox is None or tables.sperm is None:
        raise ValueError("fleet tables from gicp_fleet_prepare carry the sorted "
                         "target rows, their boxes and the source order")


def fleet_live_tiles(tables: GicpTables, uids: torch.Tensor, Ts: torch.Tensor,
                     max_dist_sq: float) -> torch.Tensor:
    """[B, blocks, tiles] bool: for lane b (pair uids[b] at pose Ts[b]) the
    target tiles that K7 stages for each block of 64 Morton-sorted source
    rows — ``swept_live_tiles`` of the lane's pair. Inactive lanes stage
    none; mask them out with the same ``active`` as the kernel."""
    _require_fleet_swept(tables)
    u = _lane_pairs(tables, uids)
    dev = tables.qtab.device
    return _live_tiles_lanes(tables.qtab[u], tables.sperm[u], tables.qnum[u],
                             _pose12(Ts.to(dev), tables.qtab.dtype), tables.tbox[u],
                             tables.tnum[u], max_dist_sq)


def gicp_linearize_fleet_plain(tables: GicpTables, uids: torch.Tensor,
                               Ts: torch.Tensor, max_dist_sq: float,
                               active: torch.Tensor, robust: Optional[str] = None,
                               robust_c: float = 1.0):
    """Plain PyTorch version of K7; same outputs as ``gicp_linearize_fleet``.
    It searches every valid target row: on a row whose nearest row lies
    within the rejector radius that row is K7's winner too, since the box
    cull never drops an acceptable row (``fleet_live_tiles``); every other
    row is zero with d² = 3e38 in both."""
    _robust_code(robust)
    u = _lane_pairs(tables, uids)
    act = active.to(device=u.device, dtype=torch.bool)
    sums, corr = _linearize_plain_lanes(
        tables.ttab[u], tables.tnum[u], tables.qtab[u],
        torch.where(act, tables.qnum[u], 0), _pose12(Ts, tables.qtab.dtype),
        max_dist_sq, robust, robust_c, tables.factor, zero_unmatched=True)
    return (*_finish(sums), torch.where(act[:, None, None], corr, 0.0))


def _fleet_lanes(tables: GicpTables, uids: torch.Tensor, Ts: torch.Tensor,
                 pose_shape: tuple):
    """Checked lane inputs of the fleet kernels: (uids [B] int32, Ts as
    float32 [B, …, 4, 4] on the tables' device)."""
    dev = tables.qtab.device
    uids = uids.to(device=dev, dtype=torch.int32).contiguous()
    Ts = Ts.to(device=dev, dtype=torch.float32).contiguous()
    _build.require(Ts, "Ts", torch.float32, (uids.shape[0],) + pose_shape)
    return uids, Ts


def _gicp_linearize_fleet_cuda(tables: GicpTables, uids: torch.Tensor,
                               Ts: torch.Tensor, max_dist_sq: float,
                               active: torch.Tensor, robust: Optional[str],
                               robust_c: float):
    f32 = torch.float32
    _build.require(tables.ttab, "ttab", f32, (None, None, 16))
    u, m = tables.ttab.shape[:2]
    _build.require(tables.qtab, "qtab", f32, (u, None, 16))
    n = tables.qtab.shape[1]
    _build.require(tables.tsorted, "tsorted", f32, (u, m, 4))
    _build.require(tables.tbox, "tbox", f32, (u, (m + TILE_ROWS - 1) // TILE_ROWS, 8))
    _build.require(tables.sperm, "sperm", torch.int32, (u, n))
    _build.require(tables.tnum, "tnum", torch.int32, (u,))
    _build.require(tables.qnum, "qnum", torch.int32, (u,))
    dev = tables.qtab.device
    uids, Ts = _fleet_lanes(tables, uids, Ts, (4, 4))
    bsz = uids.shape[0]
    active = active.to(device=dev, dtype=torch.bool).contiguous()
    _build.require(active, "active", torch.bool, (bsz,))
    corr = torch.empty((bsz, n, 16), dtype=f32, device=dev)
    if n == 0 or bsz == 0:
        return (*_finish(torch.zeros((bsz, 44), dtype=torch.float64, device=dev)),
                corr)
    lib = morton_boxes.library("gicp_fleet")
    partials = torch.empty((bsz, (n + SWEPT_BLOCK_ROWS - 1) // SWEPT_BLOCK_ROWS, 44),
                           dtype=f32, device=dev)
    sums = torch.empty((bsz, 44), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sgt_fleet_linearize(
            tables.ttab.data_ptr(), tables.tsorted.data_ptr(), tables.tbox.data_ptr(),
            tables.tnum.data_ptr(), tables.qtab.data_ptr(), tables.sperm.data_ptr(),
            tables.qnum.data_ptr(), u, m, n, uids.data_ptr(), active.data_ptr(), bsz,
            Ts.data_ptr(), float(max_dist_sq), float(robust_c),
            FACTORS.index(tables.factor), _robust_code(robust), corr.data_ptr(),
            partials.data_ptr(), _lane_tickets(dev, bsz).data_ptr(), sums.data_ptr(),
            _stream(),
        )
    _build.check(rc, "gicp_linearize_fleet")
    gicp_linearize_fleet.launches += 1
    return (*_finish(sums), corr)


def gicp_linearize_fleet(tables: GicpTables, uids: torch.Tensor, Ts: torch.Tensor,
                         max_dist_sq: float, active: torch.Tensor,
                         robust: Optional[str] = None, robust_c: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The swept search and K1's finalize for B lanes over fleet tables:
    lane b linearizes pair uids[b] at Ts[b] ([B,4,4]) unless active[b] is
    False. The factor rides in the tables. Returns (H [B,6,6] f64, b [B,6]
    f64, inliers [B] f64, corr [B,N,16]): K1's sums, and K1's corr rows
    where mask = 1; other rows are zero with d² = 3e38, and an inactive
    lane gets zero sums and all-zero corr rows."""
    _require_fleet_swept(tables)
    if tables.ttab.shape[1] > MAX_FLEET_TARGET_ROWS:
        raise ValueError(
            f"fleet registration takes at most {MAX_FLEET_TARGET_ROWS} target "
            f"rows per pair, got {tables.ttab.shape[1]} (use align for "
            "map-scale targets)")
    if tables.qtab.device.type == "cpu":
        return gicp_linearize_fleet_plain(tables, uids, Ts, max_dist_sq, active,
                                          robust, robust_c)
    return _gicp_linearize_fleet_cuda(tables, uids, Ts, max_dist_sq, active,
                                      robust, robust_c)


gicp_linearize_fleet.launches = 0


def _gicp_linearize_fleet_brute(tables: GicpTables, uids: torch.Tensor,
                                Ts: torch.Tensor, max_dist_sq: float,
                                active: torch.Tensor, robust: Optional[str] = None,
                                robust_c: float = 1.0):
    """K1's brute-force kernel with a lane grid dimension (``csrc/gicp_fused.cu``),
    which K7 was before the swept search, for timing K7 against on the card:
    every valid target row for every source row, [B, blocks, 44] partials
    summed by torch. Its corr rows where mask = 0 hold the nearest row, as
    K1's do. Not counted and not on any path."""
    f32 = torch.float32
    _build.require(tables.ttab, "ttab", f32, (None, None, 16))
    u, m = tables.ttab.shape[:2]
    _build.require(tables.qtab, "qtab", f32, (u, None, 16))
    _build.require(tables.tnum, "tnum", torch.int32, (u,))
    _build.require(tables.qnum, "qnum", torch.int32, (u,))
    dev, n = tables.qtab.device, tables.qtab.shape[1]
    uids = uids.to(device=dev, dtype=torch.int32).contiguous()
    bsz = uids.shape[0]
    active = active.to(device=dev, dtype=torch.bool).contiguous()
    _build.require(active, "active", torch.bool, (bsz,))
    poses = _pose12(Ts.to(dev), f32)
    _build.require(poses, "Ts", f32, (bsz, 12))
    corr = torch.empty((bsz, n, 16), dtype=f32, device=dev)
    lib = _build.library("gicp_fused")
    rows = lib.sgt_linearize_block_rows()
    partials = torch.empty((bsz, (n + rows - 1) // rows, 44), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sgt_gicp_linearize_fleet(
            tables.ttab.data_ptr(), tables.tnum.data_ptr(), tables.qtab.data_ptr(),
            tables.qnum.data_ptr(), u, m, uids.data_ptr(), active.data_ptr(), bsz, n,
            poses.data_ptr(), float(max_dist_sq), float(robust_c),
            FACTORS.index(tables.factor), _robust_code(robust), corr.data_ptr(),
            partials.data_ptr(), _stream(),
        )
    _build.check(rc, "gicp_linearize_fleet (brute force)")
    return (*_finish(partials.to(torch.float64).sum(1)), corr)


# ------------------------------------------------------------ K2, K8 ----

def _error_multi_plain_lanes(corr, src, P, live, robust, robust_c):
    """K2's arithmetic over B lanes: corr [B,N,16], src [B,N,≥3] source
    xyz, P [B,K1,12] poses, live [B,N] → [B,K1] float64."""
    px, py, pz = src[:, None, :, 0], src[:, None, :, 1], src[:, None, :, 2]
    col = lambda j: P[:, :, j, None]  # noqa: E731
    c = lambda j: corr[:, None, :, j]  # noqa: E731
    rx = c(0) - (col(0) * px + col(1) * py + col(2) * pz + col(9))
    ry = c(1) - (col(3) * px + col(4) * py + col(5) * pz + col(10))
    rz = c(2) - (col(6) * px + col(7) * py + col(8) * pz + col(11))
    wr0 = c(3) * rx + c(4) * ry + c(5) * rz
    wr1 = c(6) * rx + c(7) * ry + c(8) * rz
    wr2 = c(9) * rx + c(10) * ry + c(11) * rz
    e = 0.5 * (rx * wr0 + ry * wr1 + rz * wr2)  # [B,K1,N]
    if robust is not None:
        e = _robust_w(robust, robust_c, e) * e
    return torch.where(live[:, None, :], e, 0.0).to(torch.float64).sum(-1)


def gicp_error_multi_plain(corr: torch.Tensor, src: torch.Tensor, Ts: torch.Tensor,
                           num_points: torch.Tensor, robust: Optional[str] = None,
                           robust_c: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K2; same output as ``gicp_error_multi``."""
    _robust_code(robust)
    live = (torch.arange(corr.shape[0], device=corr.device) < num_points) & (
        corr[:, 12] > 0.5)
    return _error_multi_plain_lanes(corr[None], src[None], _pose12(Ts, corr.dtype)[None],
                                    live[None], robust, robust_c)[0]


def _gicp_error_multi_v1(corr: torch.Tensor, src: torch.Tensor, Ts: torch.Tensor,
                         num_points: torch.Tensor, robust: Optional[str] = None,
                         robust_c: float = 1.0) -> torch.Tensor:
    """K2's first form (``gicp_error_multi_kernel`` of ``csrc/gicp_fused.cu``:
    poses converted by torch, [blocks, K1] partials summed by torch): the
    yardstick of the step kernel's errors-only mode, on no path and counted
    nowhere."""
    f32 = torch.float32
    _build.require(corr, "corr", f32, (None, 16))
    n = corr.shape[0]
    _build.require(src, "src", f32, (n, 4))
    _build.require(num_points, "num_points", torch.int32, ())
    dev = corr.device
    k1 = Ts.shape[0]
    poses = _pose12(Ts.to(dev), f32)
    if n == 0:
        return torch.zeros(k1, dtype=torch.float64, device=dev)
    lib = _build.library("gicp_fused")
    rows = lib.sgt_trials_block_rows()
    partials = torch.empty(((n + rows - 1) // rows, k1), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sgt_gicp_error_multi(
            corr.data_ptr(), src.data_ptr(), num_points.data_ptr(), n,
            poses.data_ptr(), k1, float(robust_c), _robust_code(robust),
            partials.data_ptr(), _stream(),
        )
    _build.check(rc, "gicp_error_multi (first form)")
    return partials.to(torch.float64).sum(0)


def gicp_error_multi(corr: torch.Tensor, src: torch.Tensor, Ts: torch.Tensor,
                     num_points: torch.Tensor, robust: Optional[str] = None,
                     robust_c: float = 1.0) -> torch.Tensor:
    """[K1] float64 total errors at the poses Ts [K1,4,4] (K1 ≤ 100): on the
    card one launch of the LM step kernel in its errors-only mode
    (``ops/lm_step.py``), on the CPU the plain version."""
    if not 1 <= Ts.shape[0] <= MAX_POSES:
        raise ValueError(f"1 to {MAX_POSES} poses per call, got {Ts.shape[0]}")
    _robust_code(robust)
    if corr.device.type == "cpu":
        return gicp_error_multi_plain(corr, src, Ts, num_points, robust, robust_c)
    from small_gicp_tpu_torch.ops.lm_step import _gicp_error_multi_step

    return _gicp_error_multi_step(corr, src, Ts, num_points, robust, robust_c)


gicp_error_multi.launches = 0


def gicp_error_multi_fleet_plain(corr: torch.Tensor, tables: GicpTables,
                                 uids: torch.Tensor, Ts: torch.Tensor,
                                 robust: Optional[str] = None,
                                 robust_c: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K8; same output as ``gicp_error_multi_fleet``."""
    _robust_code(robust)
    u = _lane_pairs(tables, uids)
    return _error_multi_plain_lanes(corr, tables.qtab[u], _pose12(Ts, corr.dtype),
                                    corr[..., 12] > 0.5, robust, robust_c)


def _gicp_error_multi_fleet_cuda(corr, tables, uids, Ts, robust, robust_c):
    f32 = torch.float32
    _build.require(tables.qtab, "qtab", f32, (None, None, 16))
    u, n = tables.qtab.shape[:2]
    dev = corr.device
    uids, Ts = _fleet_lanes(tables, uids, Ts, (Ts.shape[1], 4, 4))
    bsz, k1 = uids.shape[0], Ts.shape[1]
    _build.require(corr, "corr", f32, (bsz, n, 16))
    if n == 0 or bsz == 0:
        return torch.zeros((bsz, k1), dtype=torch.float64, device=dev)
    lib = _build.library("gicp_fleet")
    rows = lib.sgt_fleet_trial_block_rows()
    partials = torch.empty((bsz, (n + rows - 1) // rows, k1), dtype=f32, device=dev)
    errs = torch.empty((bsz, k1), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sgt_fleet_error_multi(
            corr.data_ptr(), tables.qtab.data_ptr(), u, uids.data_ptr(), bsz, n,
            Ts.data_ptr(), k1, float(robust_c), _robust_code(robust),
            partials.data_ptr(), _lane_tickets(dev, bsz).data_ptr(), errs.data_ptr(),
            _stream(),
        )
    _build.check(rc, "gicp_error_multi_fleet")
    gicp_error_multi_fleet.launches += 1
    return errs


def gicp_error_multi_fleet(corr: torch.Tensor, tables: GicpTables, uids: torch.Tensor,
                           Ts: torch.Tensor, robust: Optional[str] = None,
                           robust_c: float = 1.0) -> torch.Tensor:
    """K2 for B lanes: [B,K1] float64 errors of lane b's frozen corr rows
    [B,N,16] at its poses Ts [B,K1,4,4] (K1 ≤ 100), with the source xyz of
    pair uids[b]. The mask in corr row 12 already holds validity."""
    _require_fleet(tables)
    if Ts.dim() != 4 or not 1 <= Ts.shape[1] <= MAX_POSES:
        raise ValueError(f"Ts must be [B,K1,4,4] with 1 to {MAX_POSES} poses per "
                         f"lane, got {tuple(Ts.shape)}")
    if corr.device.type == "cpu":
        return gicp_error_multi_fleet_plain(corr, tables, uids, Ts, robust, robust_c)
    return _gicp_error_multi_fleet_cuda(corr, tables, uids, Ts, robust, robust_c)


gicp_error_multi_fleet.launches = 0


def _gicp_error_multi_fleet_k2(corr: torch.Tensor, tables: GicpTables,
                               uids: torch.Tensor, Ts: torch.Tensor,
                               robust: Optional[str] = None, robust_c: float = 1.0):
    """K2's kernel with a lane grid dimension (``csrc/gicp_fused.cu``), which
    K8 was before it finished its own sums: poses converted by torch, one
    block of 128 rows per [lane, block], [B, blocks, K1] partials summed by
    torch. For timing K8 against on the card; not counted and not on any
    path."""
    f32 = torch.float32
    _build.require(tables.qtab, "qtab", f32, (None, None, 16))
    u, n = tables.qtab.shape[:2]
    dev = corr.device
    uids = uids.to(device=dev, dtype=torch.int32).contiguous()
    bsz, k1 = uids.shape[0], Ts.shape[1]
    _build.require(corr, "corr", f32, (bsz, n, 16))
    poses = _pose12(Ts.to(dev), f32)
    _build.require(poses, "Ts", f32, (bsz, k1, 12))
    lib = _build.library("gicp_fused")
    rows = lib.sgt_trials_block_rows()
    partials = torch.empty((bsz, (n + rows - 1) // rows, k1), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sgt_gicp_error_multi_fleet(
            corr.data_ptr(), tables.qtab.data_ptr(), u, uids.data_ptr(), bsz, n,
            poses.data_ptr(), k1, float(robust_c), _robust_code(robust),
            partials.data_ptr(), _stream(),
        )
    _build.check(rc, "gicp_error_multi_fleet (K2's kernel)")
    return partials.to(torch.float64).sum(1)
