"""Standalone exact neighbour searches: kernels K9-K12 and their plain
versions.

Counterpart of ``small_gicp_tpu/ops/knn_pallas.py``:

  * ``nearest_neighbor`` (K9) replaces ``nearest_neighbor_pallas``
    (``_nn1_kernel_vpu`` / ``_nn1_kernel``): exact 1-NN, (d² [Q], idx [Q]).
    Both clouds are centred on the mean of the finite target rows, as the
    Pallas wrapper centres them. ``variant="vpu"`` ranks by the difference
    form and returns d² of the centred coordinates; ``"mxu"`` ranks by the
    centred score |t|² − 2 q·t and returns the winner's d² recomputed from
    the uncentred inputs (its tensor-core form is later work).
  * ``knn`` (K10) replaces ``knn_pallas`` (``_make_knn_kernel``): exact
    kNN for k ≤ 64, (d² [Q,k] ascending, idx [Q,k]), difference form, no
    centring, ties to the lower index.
  * ``knn_T`` (K11) replaces ``knn_pallas_T`` (``_make_knn_kernel_T``):
    K10's contract with the other work mapping — a warp holds a few
    queries and its lanes stride the target rows, each lane with its own
    list per query — bit-identical to K10. Reachable by this wrapper only,
    as in the JAX package.
  * ``knn_pruned`` (K12) replaces ``knn_pallas_pruned``
    (``_make_knn_listed_kernel``): K10's contract with work ∝ local
    density: the box walk that K3, K4 and K5 share, over the Morton-sorted
    target and its 256-row tile boxes, with the queries in the same Morton
    order, ``pruned_plan`` threads a query, each query's list seeded with
    the kth d² over its Morton window (or across its 1 m cell where more
    rows than the window share its code) and each block's cull passes
    starting at its median query's box. Ties go to the lower *original* index, so
    K12 equals K10 on every input (the Pallas kernel orders ties by the
    sorted-frame index).

Indices are int32, as in the JAX API. Slots for which no valid target row
is left (k > num_points) hold d² = 3e38 and index 0; the JAX kernels
return sentinel rows with d² > 1e16 there. Both mean "no neighbour" to
every caller; comparisons hold to slots with d² < 1e16.

Bound on the card: Q·M pairs at 9 float32 operations against 16·(Q+M)
bytes in and 8·k·Q out — operations, at every shape a scan produces. K12
is bounded by fewer pairs: the rows of the tiles that lie within a query
block's true kth distance, which depend on the data.
The kernels stream the target through shared memory; K12 culls whole
tiles by their boxes. See ``csrc/knn.cu``.

K9 and K10 split the work two ways so that one launch fills the card at
every query count: each thread of K9 takes 4 queries (K10 one), and ``split_plan`` cuts the target rows into chunks, one grid row
each. Each chunk searches its own rows; the chunks' results are merged in
the same launch by the last block of each query block:

  * K9: a chunk's winner becomes a 64-bit key, the rank's float bits made
    orderable (the score form's rank can be negative) above the row; the
    smallest key over the chunks wins, so ties go to the lower row, and the
    score form's d² is then recomputed from the uncentred rows;
  * K10: a chunk keeps the k first rows in (d², row) order among the rows
    within its bound — the kth smallest d² over a strided sample of its own
    rows, which bounds its own list and so changes nothing — and the
    chunks' lists are merged in (d², row) order.

K11 splits the same way (``warp_plan``: fewer, larger blocks): in a
chunk each query takes a bound from a strided sample of the chunk's rows
(every ``WARP_SAMPLE_STEP``-th; the kth smallest of 32 lanes' minima),
every lane keeps the k first of its rows (every 32nd) within it, the lanes' lists
give the chunk's list, and the last block merges the chunks' lists laid
end to end, lane l taking every 32nd entry.

``nearest_neighbor_split_plain``, ``knn_split_plain`` and
``knn_T_split_plain`` are the plain account of that: for every plan they
equal ``nearest_neighbor_plain`` and ``knn_plain``, which stay the
contract. The first forms of K9, K10 and K11 (one thread or one warp per
query over every row) and of K12 (a thread a query, the boxes tested one
after another) stay as the yardsticks ``_nearest_neighbor_v1``,
``_knn_v1``, ``_knn_T_v1`` and ``_knn_pruned_v1``, reached from no path.

What a search derives from the target alone — K9's centre, the target
half of K12's prologue (the sort and boxes of ``ops/morton_boxes.py``) —
can be passed in (``centre=``, ``target=``); ``KdTree`` computes each once
and keeps it.

On a CUDA tensor every wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version beside it, which repeats the kernel's
arithmetic (and, for K12, its sort, boxes, reach, anchors and walk).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from small_gicp_tpu_torch import _build
from small_gicp_tpu_torch.ops import morton_boxes
from small_gicp_tpu_torch.ops.knn import QUERY_BLOCK, first_k, sq_dists
from small_gicp_tpu_torch.ops.knn_window import morton_codes32
from small_gicp_tpu_torch.ops.morton_boxes import (
    TILE_ROWS,
    PrunedTarget,
    pruned_prepare_target,
)

_BIG = 3.0e38
MAX_K = 64
VARIANTS = ("vpu", "mxu")
BLOCK_QUERIES = morton_boxes.BLOCK_ROWS
# K12's threads a query (the instances of csrc/knn.cu) and the blocks a
# launch aims at per SM (pruned_plan, tools/pruned_walk_sweep.py).
PRUNED_TEAMS = (2, 4, 8)
PRUNED_BLOCKS_PER_SM = 8
# K9's and K10's queries per block, rows per ring stage (chunks are
# multiples of it), K10's least sample step and most sampled rows per chunk
# (sgt_knn_split_geometry of csrc/knn.cu, held against the compiled values
# when the library loads).
NN1_BLOCK_QUERIES = 256
KNN_BLOCK_QUERIES = 64
SPLIT_TILE = 256
SAMPLE_STEP = 8
CHUNK_SAMPLE = 2048
# Blocks that a K9 or K10 launch aims at per SM: the target rows are cut
# into chunks until the query blocks times the chunks reach this many, or
# until a chunk of the capacity is one ring stage.
SPLIT_BLOCKS_PER_SM = 32
# A chunk pays about k insertions into its lists whatever its length, so
# where the query blocks alone put FILLED_BLOCKS_PER_SM blocks on every SM,
# K10's chunks hold at least KNN_ROWS_PER_K rows per neighbour (0: no such
# floor).
FILLED_BLOCKS_PER_SM = 2
KNN_ROWS_PER_K = 512
# K11's queries a warp (up to k = 16; half up to 32, a quarter above), warps
# a block at most, bytes of lane lists a block at most and its bound's
# sample step (kWarpQueries, kWarpMaxWarps, kWarpListBytes, kWarpSampleStep
# of csrc/knn.cu, held against the compiled values when the library loads),
# and the blocks its launch aims at per SM.
WARP_QUERIES = 4
WARP_MAX_WARPS = 8
WARP_LIST_BYTES = 98304
WARP_SAMPLE_STEP = 4
WARP_BLOCKS_PER_SM = 4
LANES = 32
_EMPTY_KEY = 2 ** 63 - 1

Pair = Tuple[torch.Tensor, torch.Tensor]


def _check_k(k: int, what: str) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what} supports 1 <= k <= {MAX_K}, got {k}")


def _query_rows(query: torch.Tensor) -> torch.Tensor:
    """[Q,3] or [Q,4] queries as a tensor whose rows lie 3 or 4 floats
    apart (a [Q,3] view of [Q,4] rows passes as it is)."""
    if query.shape[0] > 1 and query.stride(1) == 1 and query.stride(0) in (3, 4):
        return query
    return query[:, :3].contiguous()


def _masked_sq_dists(q: torch.Tensor, t: torch.Tensor, cols: torch.Tensor
                     ) -> torch.Tensor:
    """[B,3] × [M,3] → [B,M] difference-form d², 3e38 where ``cols`` is
    False or d² is not below 3e38 (the kernels' candidate rule)."""
    d2 = sq_dists(q, t)
    return torch.where(cols[None, :] & (d2 < _BIG), d2, _BIG)


def _empty(query: torch.Tensor, shape) -> Pair:
    return (torch.empty(shape, dtype=query.dtype, device=query.device),
            torch.empty(shape, dtype=torch.int32, device=query.device))


def _require_search(target_points, num_points, query) -> None:
    _build.require(target_points, "target points", torch.float32, (None, 4))
    _build.require(num_points, "num_points", torch.int32, ())
    if query.dim() != 2 or query.shape[1] not in (3, 4):
        raise ValueError(f"queries must be [Q,3] or [Q,4], got {tuple(query.shape)}")
    if query.device != target_points.device or query.dtype != torch.float32:
        raise ValueError("queries must be float32 on the target's device")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def _library():
    """The knn library, its box, warp and split constants held against the
    Python side's (once: a launch pays no check)."""
    morton_boxes.library("knn")
    _build.library_with_geometry(
        "knn", "sgt_knn_warp_geometry",
        (WARP_QUERIES, WARP_MAX_WARPS, WARP_LIST_BYTES, WARP_SAMPLE_STEP))
    return _build.library_with_geometry(
        "knn", "sgt_knn_split_geometry",
        (NN1_BLOCK_QUERIES, KNN_BLOCK_QUERIES, SPLIT_TILE, SAMPLE_STEP, CHUNK_SAMPLE))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(nq: int, mcap: int, block_queries: int, sms: int,
               per_sm: Optional[int] = None) -> int:
    """Chunks of a K9, K10 or K11 launch over ``nq`` queries and a target
    of ``mcap`` rows: as many as it takes for the query blocks times the
    chunks to reach ``per_sm`` (default ``SPLIT_BLOCKS_PER_SM``) blocks on
    each of ``sms`` SMs, but not more than the capacity has ring stages.
    One where the queries alone reach it."""
    per_sm = SPLIT_BLOCKS_PER_SM if per_sm is None else per_sm
    qblocks = _cdiv(max(nq, 1), block_queries)
    return max(1, min(_cdiv(per_sm * sms, qblocks),
                      _cdiv(max(mcap, 1), SPLIT_TILE), 65535))


def warp_block_queries(k: int) -> int:
    """Queries a K11 block holds for k neighbours: warps of
    ``WARP_QUERIES`` queries (half that above k = 16, a quarter above 32),
    as many warps as ``WARP_LIST_BYTES`` of k × 32 lane lists a query
    allow, at least one and at most ``WARP_MAX_WARPS``."""
    qw = max(1, WARP_QUERIES if k <= 16 else WARP_QUERIES // 2 if k <= 32
             else WARP_QUERIES // 4)
    return qw * min(WARP_MAX_WARPS, max(1, WARP_LIST_BYTES // (qw * k * LANES * 8)))


def warp_plan(nq: int, mcap: int, k: int, sms: int) -> int:
    """Chunks of a K11 launch: ``split_plan`` over its blocks, aiming at
    ``WARP_BLOCKS_PER_SM`` of them on each SM."""
    return split_plan(nq, mcap, warp_block_queries(k), sms, WARP_BLOCKS_PER_SM)


def split_chunk(m: int, nsplit: int, tile: int = SPLIT_TILE,
                least: Optional[int] = None) -> int:
    """Rows per chunk when the kernel cuts ``m`` valid rows into ``nsplit``
    chunks of at least ``least`` rows (default ``tile``): equal multiples of
    ``tile``; trailing chunks may be empty."""
    return max(least or tile, _cdiv(_cdiv(m, nsplit), tile) * tile)


def knn_least_rows(nq: int, k: int, sms: int) -> int:
    """K10's least rows per chunk (a multiple of SPLIT_TILE) for ``nq``
    queries on a card of ``sms`` SMs."""
    if KNN_ROWS_PER_K and _cdiv(nq, KNN_BLOCK_QUERIES) >= FILLED_BLOCKS_PER_SM * sms:
        return _cdiv(k * KNN_ROWS_PER_K, SPLIT_TILE) * SPLIT_TILE
    return SPLIT_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclass
class _SplitBuffers:
    """K9's per-query keys, K10's per-query shared bounds and the query
    blocks' tickets (all 0 between launches: every launch leaves them so),
    K10's chunk lists."""

    keys: torch.Tensor  # int64 [≥ Q]
    bounds: torch.Tensor  # int32 [≥ Q]
    tickets: torch.Tensor  # int32 [≥ query blocks]
    ws_d: torch.Tensor  # float32 [≥ chunks·k·Q]
    ws_i: torch.Tensor  # int32, the same


_buffers: Dict[Tuple[int, int], _SplitBuffers] = {}


def _split_buffers(dev: torch.device, nq: int, qblocks: int, ws: int) -> _SplitBuffers:
    """The buffers of one device and stream, on which launches run in
    order, grown to hold a launch's needs; zeroed once, at allocation."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    b = _buffers.get(key)
    if b is None:
        b = _buffers[key] = _SplitBuffers(*(torch.zeros(0, dtype=t, device=dev) for t in (
            torch.int64, torch.int32, torch.int32, torch.float32, torch.int32)))
    if b.keys.numel() < nq:
        b.keys = torch.zeros(max(nq, 1024), dtype=torch.int64, device=dev)
        b.bounds = torch.zeros(max(nq, 1024), dtype=torch.int32, device=dev)
    if b.tickets.numel() < qblocks:
        b.tickets = torch.zeros(max(qblocks, 1024), dtype=torch.int32, device=dev)
    if b.ws_d.numel() < ws:
        b.ws_d = torch.empty(ws, dtype=torch.float32, device=dev)
        b.ws_i = torch.empty(ws, dtype=torch.int32, device=dev)
    return b


# ------------------------------------------------------------------ K9 ----

def target_centre(target_points: torch.Tensor) -> torch.Tensor:
    """[3] mean of the target rows whose coordinates are all below 1e8 in
    magnitude (padding rows carry 1e9)."""
    t = target_points[:, :3]
    finite = (t.abs() < 1e8).all(dim=-1, keepdim=True)
    denom = torch.clamp(finite.sum(), min=1)
    return torch.where(finite, t, 0.0).sum(dim=0) / denom


def nearest_neighbor_plain(target_points: torch.Tensor, num_points: torch.Tensor,
                           query: torch.Tensor, variant: str = "vpu",
                           centre: Optional[torch.Tensor] = None) -> Pair:
    """Plain PyTorch version of K9, same centring and operation order."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (use 'vpu' or 'mxu')")
    nq, m = query.shape[0], target_points.shape[0]
    if nq == 0:
        return _empty(query, (0,))
    c = target_centre(target_points) if centre is None else centre
    t = target_points[:, :3]
    tc, qc = t - c, query[:, :3] - c
    cols = torch.arange(m, device=t.device) < num_points
    if variant == "mxu":
        tn = tc[:, 0] * tc[:, 0] + tc[:, 1] * tc[:, 1] + tc[:, 2] * tc[:, 2]
    ds, ids = [], []
    for s in range(0, nq, QUERY_BLOCK):
        q = qc[s:s + QUERY_BLOCK]
        if m == 0:
            ds.append(q.new_full((q.shape[0],), _BIG))
            ids.append(torch.zeros(q.shape[0], dtype=torch.int64, device=q.device))
            continue
        if variant == "vpu":
            d, i = torch.min(_masked_sq_dists(q, tc, cols), dim=1)  # first minimum
        else:
            dot = (q[:, None, 0] * tc[None, :, 0] + q[:, None, 1] * tc[None, :, 1]
                   + q[:, None, 2] * tc[None, :, 2])
            score = tn[None, :] - 2.0 * dot
            score, i = torch.min(
                torch.where(cols[None, :] & (score < _BIG), score, _BIG), dim=1)
            diff = query[s:s + QUERY_BLOCK, :3] - t[i]
            d = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]
                 + diff[:, 2] * diff[:, 2])
            d = torch.where(score < _BIG, d, _BIG)
        ds.append(d)
        ids.append(i)
    return torch.cat(ds), torch.cat(ids).to(torch.int32)


def _orderable(v: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2³²) whose order is that of the float32 values ``v``
    (no NaN): the high word of K9's key."""
    u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, 0xFFFFFFFF - u, u + 2 ** 31)


def _from_orderable(o: torch.Tensor) -> torch.Tensor:
    u = torch.where(o >= 2 ** 31, o - 2 ** 31, 0xFFFFFFFF - o)
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(torch.float32)


def nearest_neighbor_split_plain(target_points: torch.Tensor, num_points: torch.Tensor,
                                 query: torch.Tensor, variant: str, nsplit: int,
                                 centre: Optional[torch.Tensor] = None,
                                 tile: int = SPLIT_TILE) -> Pair:
    """Plain account of K9 over ``nsplit`` chunks (``split_chunk``; the
    kernel's ``tile`` is SPLIT_TILE): each chunk's first smallest rank
    (strict < in row order), its key — the rank's orderable bits above the
    row, here offset by 2³¹ so that it fits a signed int64 in the same
    order; -0 counts as +0 — the smallest key over the chunks, decoded; the
    score form's d² recomputed from the uncentred rows. Equal to
    ``nearest_neighbor_plain`` for every plan."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (use 'vpu' or 'mxu')")
    nq = query.shape[0]
    c = target_centre(target_points) if centre is None else centre
    t = target_points[:, :3]
    tc, qc = t - c, query[:, :3] - c
    m = min(int(num_points), target_points.shape[0])
    chunk = split_chunk(m, nsplit, tile)
    keys = torch.full((nq,), _EMPTY_KEY, dtype=torch.int64, device=query.device)
    for s in range(nsplit):
        lo = s * chunk
        rows = tc[lo:max(lo, min(m, lo + chunk))]
        if rows.shape[0] == 0:
            continue
        if variant == "vpu":
            rank = sq_dists(qc, rows)
        else:
            tn = rows[:, 0] * rows[:, 0] + rows[:, 1] * rows[:, 1] + rows[:, 2] * rows[:, 2]
            dot = (qc[:, None, 0] * rows[None, :, 0] + qc[:, None, 1] * rows[None, :, 1]
                   + qc[:, None, 2] * rows[None, :, 2])
            rank = tn[None, :] - 2.0 * dot
        v, j = torch.min(torch.where(rank < _BIG, rank, _BIG), dim=1)
        key = (_orderable(v + 0.0) - 2 ** 31) * 2 ** 32 + lo + j
        keys = torch.where(v < _BIG, torch.minimum(keys, key), keys)
    found = keys != _EMPTY_KEY
    rows = torch.where(found, keys & 0xFFFFFFFF, 0)
    d = torch.where(found, _from_orderable((keys >> 32) + 2 ** 31), _BIG)
    if variant == "mxu":
        diff = query[:, :3] - t[rows]
        d = torch.where(found, diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]
                        + diff[:, 2] * diff[:, 2], _BIG)
    return d, rows.to(torch.int32)


def _nn1_inputs(target_points, num_points, query, variant, centre):
    """Checked K9 inputs: (queries rows 3 or 4 floats apart, contiguous
    centre, outputs)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (use 'vpu' or 'mxu')")
    _require_search(target_points, num_points, query)
    q = _query_rows(query)
    if centre is None:
        centre = target_centre(target_points)
    else:
        _build.require(centre, "centre", torch.float32, (3,))
    return q, centre.contiguous(), _empty(q, (q.shape[0],))


def nearest_neighbor(target_points: torch.Tensor, num_points: torch.Tensor,
                     query: torch.Tensor, variant: str = "vpu",
                     centre: Optional[torch.Tensor] = None) -> Pair:
    """Exact 1-NN of each query among the valid target rows:
    (d² [Q], idx [Q] int32). Kernel K9 on CUDA, plain version on the CPU.

    ``centre`` is ``target_centre(target_points)`` when the caller has it
    already (``KdTree`` keeps it); it is computed here otherwise. With it
    the call is the kernel's launch and nothing else."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (use 'vpu' or 'mxu')")
    if target_points.device.type == "cpu":
        return nearest_neighbor_plain(target_points, num_points, query, variant, centre)
    q, centre, (d, i) = _nn1_inputs(target_points, num_points, query, variant, centre)
    nq, mcap = q.shape[0], target_points.shape[0]
    if nq == 0:
        return d, i
    lib = _library()
    nsplit = split_plan(nq, mcap, NN1_BLOCK_QUERIES, _sm_count(q.device.index))
    buf = _split_buffers(q.device, nq, _cdiv(nq, NN1_BLOCK_QUERIES), 0)
    with torch.cuda.device(q.device):
        rc = lib.sgt_nn1(target_points.data_ptr(), num_points.data_ptr(), mcap,
                         q.data_ptr(), q.stride(0), nq, centre.data_ptr(),
                         VARIANTS.index(variant), nsplit, buf.keys.data_ptr(),
                         buf.tickets.data_ptr(), d.data_ptr(), i.data_ptr(), _stream())
    _build.check(rc, "nearest_neighbor")
    nearest_neighbor.launches += 1
    return d, i


nearest_neighbor.launches = 0


def _nearest_neighbor_v1(target_points: torch.Tensor, num_points: torch.Tensor,
                         query: torch.Tensor, variant: str = "vpu",
                         centre: Optional[torch.Tensor] = None) -> Pair:
    """K9's first form (one thread per query over every row), for timing
    K9 against on the card. Not counted and not on any path."""
    q, centre, (d, i) = _nn1_inputs(target_points, num_points, query, variant, centre)
    if q.shape[0] == 0:
        return d, i
    with torch.cuda.device(q.device):
        rc = _library().sgt_nn1_v1(
            target_points.data_ptr(), num_points.data_ptr(), target_points.shape[0],
            q.data_ptr(), q.stride(0), q.shape[0], centre.data_ptr(),
            VARIANTS.index(variant), d.data_ptr(), i.data_ptr(), _stream())
    _build.check(rc, "nearest_neighbor (v1)")
    return d, i


# ------------------------------------------------------------ K10, K11 ----

def knn_plain(target_points: torch.Tensor, num_points: torch.Tensor,
              query: torch.Tensor, k: int) -> Pair:
    """Plain PyTorch version of K10 and K11: difference-form brute force,
    stable sort (ties to the lower index)."""
    nq, m = query.shape[0], target_points.shape[0]
    if nq == 0:
        return _empty(query, (0, k))
    t = target_points[:, :3]
    ids = torch.arange(m, device=t.device)
    cols = ids < num_points
    ds, idx = [], []
    for s in range(0, nq, QUERY_BLOCK):
        d, i = first_k(_masked_sq_dists(query[s:s + QUERY_BLOCK, :3], t, cols), ids, k)
        ds.append(d)
        idx.append(i)
    return torch.cat(ds), torch.cat(idx)


def _sampled_bound(d2: torch.Tensor, k: int) -> torch.Tensor:
    """[B] kth smallest of the columns 0, step, 2·step, … of ``d2`` [B,L]
    (3e38 if they are fewer than k), step = max(SAMPLE_STEP, ceil(L /
    CHUNK_SAMPLE)): K10's bound over a chunk of L rows."""
    sample = d2[:, ::max(SAMPLE_STEP, _cdiv(d2.shape[1], CHUNK_SAMPLE))]
    if sample.shape[1] < k:
        return d2.new_full((d2.shape[0],), _BIG)
    return torch.sort(sample, dim=1).values[:, k - 1]


def knn_split_plain(target_points: torch.Tensor, num_points: torch.Tensor,
                    query: torch.Tensor, k: int, nsplit: int,
                    tile: int = SPLIT_TILE, shared: bool = False,
                    least: Optional[int] = None) -> Pair:
    """Plain account of K10 over ``nsplit`` chunks of at least ``least``
    rows (``split_chunk``; the kernel's ``tile`` is SPLIT_TILE): each
    chunk's k first rows in (d², row) order among the rows with d² within
    its bound (the kth smallest d² over a strided sample of the chunk's own
    rows, where the chunk holds more than ``tile`` rows), then the chunks'
    lists merged in (d², row) order. Equal to ``knn_plain`` for every
    plan.

    Any chunk's bound bounds the query's kth d² over the whole target, so
    every chunk may filter by the smallest of them (``shared``): the kernel
    trades bounds between a query's chunks as they run, and its own lists'
    kth once full, which leaves the merge unchanged."""
    nq = query.shape[0]
    if nq == 0:
        return _empty(query, (0, k))
    m = min(int(num_points), target_points.shape[0])
    chunk = split_chunk(m, nsplit, tile, least)
    t = target_points[:, :3]
    chunks = []
    for s in range(nsplit):
        lo = s * chunk
        ids = torch.arange(lo, max(lo, min(m, lo + chunk)), device=t.device)
        d2 = _masked_sq_dists(query[:, :3], t[ids], ids >= 0)
        bound = (_sampled_bound(d2, k) if ids.shape[0] > tile
                 else d2.new_full((nq,), _BIG))
        chunks.append((ids, d2, bound))
    tightest = torch.stack([b for _, _, b in chunks]).amin(dim=0)
    lists_d, lists_i = [], []
    for ids, d2, bound in chunks:
        reach = tightest if shared else bound
        d, i = first_k(torch.where(d2 <= reach[:, None], d2, _BIG), ids, k)
        lists_d.append(d)
        lists_i.append(i)
    # Chunks ascend by row: a stable sort of the lists in chunk order is the
    # (d², row) order.
    d_all, i_all = torch.cat(lists_d, dim=1), torch.cat(lists_i, dim=1)
    d_sorted, pos = torch.sort(d_all, dim=1, stable=True)
    return d_sorted[:, :k], i_all.gather(1, pos[:, :k])


_NO_ROW = 2 ** 40  # the row of a padding entry: after every real row


def _lex_order(d: torch.Tensor, i: torch.Tensor, dim: int) -> Pair:
    """(d, i) sorted along ``dim`` in (d², row) order: by row, then stably
    by d²."""
    by_row = torch.argsort(i, dim=dim, stable=True)
    d, i = torch.gather(d, dim, by_row), torch.gather(i, dim, by_row)
    by_d = torch.argsort(d, dim=dim, stable=True)
    return torch.gather(d, dim, by_d), torch.gather(i, dim, by_d)


def _lane_lists(d: torch.Tensor, i: torch.Tensor, k: int, lex: bool) -> Pair:
    """Entry j of the rows of (d [B,L], i [B,L] int64) goes to lane j mod
    32; each lane keeps its k first entries, in (d², row) order where
    ``lex``, else by a stable sort on d² (its entries then come in row
    order). Returns the 32 lists side by side, [B, 32·k], padding entries
    (3e38, _NO_ROW) where a lane holds fewer than k."""
    b, n = d.shape
    per_lane = max(k, _cdiv(n, LANES))
    pad = per_lane * LANES - n
    d = torch.cat([d, d.new_full((b, pad), _BIG)], dim=1).view(b, per_lane, LANES)
    i = torch.cat([i, i.new_full((b, pad), _NO_ROW)], dim=1).view(b, per_lane, LANES)
    if lex:
        d, i = _lex_order(d, i, 1)
    else:
        by_d = torch.argsort(d, dim=1, stable=True)
        d, i = torch.gather(d, 1, by_d), torch.gather(i, 1, by_d)
    return d[:, :k].reshape(b, -1), i[:, :k].reshape(b, -1)


def _lex_first_k_flat(d: torch.Tensor, i: torch.Tensor, k: int) -> Pair:
    """The k first of the rows of (d, i) in (d², row) order; empty slots as
    d² 3e38 and row 0."""
    d, i = _lex_order(d, i, 1)
    d, i = d[:, :k], i[:, :k]
    return d, torch.where(d < _BIG, i, 0).to(torch.int32)


def _lane_bound(d2: torch.Tensor, k: int) -> torch.Tensor:
    """[B] K11's bound over a chunk of L rows (``d2`` [B,L]): its columns 0,
    ``WARP_SAMPLE_STEP``, … as the sample, sample s dealt to lane s mod 32;
    each lane's t-th smallest (t = 1 up to k = 32, 2 above; 3e38 for a lane
    with fewer samples); the ⌈k/t⌉-th smallest of the 32 lanes' values. At
    least k distinct rows lie at or below it."""
    sample = d2[:, ::WARP_SAMPLE_STEP]
    t = 1 if k <= 32 else 2
    ns = sample.shape[1]
    per_lane = _cdiv(ns, LANES) * LANES
    lanes = torch.cat([sample, sample.new_full((d2.shape[0], per_lane - ns), _BIG)], dim=1)
    lanes = lanes.view(d2.shape[0], -1, LANES)  # [B, samples a lane, lane]
    if lanes.shape[1] < t:
        return d2.new_full((d2.shape[0],), _BIG)
    tth = torch.sort(lanes, dim=1).values[:, t - 1]  # [B, 32]
    return torch.sort(tth, dim=1).values[:, _cdiv(k, t) - 1]


def knn_T_split_plain(target_points: torch.Tensor, num_points: torch.Tensor,
                      query: torch.Tensor, k: int, nsplit: int,
                      tile: int = SPLIT_TILE) -> Pair:
    """Plain account of K11 over ``nsplit`` chunks (``split_chunk``; the
    kernel's ``tile`` is SPLIT_TILE), step by step: in each non-empty chunk
    each query's bound B — ``_lane_bound`` over the chunk's rows lo, lo +
    step, … where the chunk holds more than ``tile`` rows, else 3e38; lane
    l's list, the k first in (d², row) order of the chunk's rows with row ≡
    l (mod 32) and d² ≤ B; the chunk's list, the k first of its lanes'
    lists. With one chunk that is the result; with more, the chunks' lists
    are laid end to end, lane l of the merge keeps the k first of entries l,
    l + 32, …, and the result is the k first of the lanes' lists. Equal to
    ``knn_plain`` for every plan."""
    nq = query.shape[0]
    if nq == 0:
        return _empty(query, (0, k))
    m = min(int(num_points), target_points.shape[0])
    chunk = split_chunk(m, nsplit, tile)
    t = target_points[:, :3]
    out_d, out_i = [], []
    for b0 in range(0, nq, QUERY_BLOCK):
        q = query[b0:b0 + QUERY_BLOCK, :3]
        lists_d, lists_i = [], []
        for s in range(nsplit):
            lo = s * chunk
            ids = torch.arange(lo, max(lo, min(m, lo + chunk)), device=t.device)
            if ids.shape[0] == 0:
                continue  # the merge skips empty chunks
            d2 = _masked_sq_dists(q, t[ids], ids >= 0)
            if ids.shape[0] > tile:
                d2 = torch.where(d2 <= _lane_bound(d2, k)[:, None], d2, _BIG)
            # A chunk starts at a multiple of 32: row lo + j is lane j mod 32.
            d, i = _lane_lists(d2, ids.expand_as(d2), k, lex=False)
            d, i = _lex_order(d, i, 1)
            lists_d.append(d[:, :k])
            lists_i.append(i[:, :k])
        if not lists_d:
            d = q.new_full((q.shape[0], k), _BIG)
            i = torch.zeros((q.shape[0], k), dtype=torch.int32, device=q.device)
        elif nsplit == 1:
            d, i = _lex_first_k_flat(lists_d[0], lists_i[0], k)
        else:
            d, i = _lane_lists(torch.cat(lists_d, dim=1), torch.cat(lists_i, dim=1), k,
                               lex=True)
            d, i = _lex_first_k_flat(d, i, k)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def _knn_launch(wrapper, entry: str, target_points, num_points, query, k) -> Pair:
    """Launch the K10 v1 / K11 v1 entry ``entry`` (one thread or one warp
    per query over every row) and count it on ``wrapper`` (None:
    uncounted)."""
    _require_search(target_points, num_points, query)
    q = _query_rows(query)
    nq = q.shape[0]
    d, i = _empty(q, (nq, k))
    if nq == 0:
        return d, i
    lib = _library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(
            target_points.data_ptr(), num_points.data_ptr(), target_points.shape[0],
            q.data_ptr(), q.stride(0), nq, k, d.data_ptr(), i.data_ptr(), _stream())
    _build.check(rc, entry)
    if wrapper is not None:
        wrapper.launches += 1
    return d, i


def knn(target_points: torch.Tensor, num_points: torch.Tensor, query: torch.Tensor,
        k: int) -> Pair:
    """Exact kNN, k ≤ 64: (d² [Q,k] ascending, idx [Q,k] int32). Kernel K10
    on CUDA, plain version on the CPU."""
    _check_k(k, "knn")
    if target_points.device.type == "cpu":
        return knn_plain(target_points, num_points, query, k)
    _require_search(target_points, num_points, query)
    q = _query_rows(query)
    nq, mcap = q.shape[0], target_points.shape[0]
    d, i = _empty(q, (nq, k))
    if nq == 0:
        return d, i
    lib = _library()
    sms = _sm_count(q.device.index)
    nsplit = split_plan(nq, mcap, KNN_BLOCK_QUERIES, sms)
    buf = _split_buffers(q.device, nq, _cdiv(nq, KNN_BLOCK_QUERIES),
                         nsplit * k * nq if nsplit > 1 else 0)
    with torch.cuda.device(q.device):
        rc = lib.sgt_knn(target_points.data_ptr(), num_points.data_ptr(), mcap,
                         q.data_ptr(), q.stride(0), nq, k, nsplit,
                         knn_least_rows(nq, k, sms),
                         buf.ws_d.data_ptr(), buf.ws_i.data_ptr(), buf.bounds.data_ptr(),
                         buf.tickets.data_ptr(), d.data_ptr(), i.data_ptr(), _stream())
    _build.check(rc, "knn")
    knn.launches += 1
    return d, i


knn.launches = 0


def _knn_v1(target_points: torch.Tensor, num_points: torch.Tensor, query: torch.Tensor,
            k: int) -> Pair:
    """K10's first form (one thread per query over every row, a bound over
    2,048 sampled rows), for timing K10 against on the card. Not counted
    and not on any path."""
    _check_k(k, "knn")
    return _knn_launch(None, "sgt_knn_v1", target_points, num_points, query, k)


def knn_T(target_points: torch.Tensor, num_points: torch.Tensor, query: torch.Tensor,
          k: int) -> Pair:
    """``knn`` with a warp per few queries (kernel K11); bit-identical to
    it. Plain version on the CPU."""
    _check_k(k, "knn_T")
    if target_points.device.type == "cpu":
        return knn_plain(target_points, num_points, query, k)
    _require_search(target_points, num_points, query)
    q = _query_rows(query)
    nq, mcap = q.shape[0], target_points.shape[0]
    d, i = _empty(q, (nq, k))
    if nq == 0:
        return d, i
    lib = _library()
    nsplit = warp_plan(nq, mcap, k, _sm_count(q.device.index))
    buf = _split_buffers(q.device, nq, _cdiv(nq, warp_block_queries(k)),
                         nsplit * k * nq if nsplit > 1 else 0)
    with torch.cuda.device(q.device):
        rc = lib.sgt_knn_warp(target_points.data_ptr(), num_points.data_ptr(), mcap,
                              q.data_ptr(), q.stride(0), nq, k, nsplit,
                              buf.ws_d.data_ptr(), buf.ws_i.data_ptr(),
                              buf.tickets.data_ptr(), d.data_ptr(), i.data_ptr(),
                              _stream())
    _build.check(rc, "knn_T")
    knn_T.launches += 1
    return d, i


knn_T.launches = 0


def _knn_T_v1(target_points: torch.Tensor, num_points: torch.Tensor, query: torch.Tensor,
              k: int) -> Pair:
    """K11's first form (one warp per query over every row, staged
    synchronously, cold lists, no split), for timing K11 against on the
    card. Not counted and not on any path."""
    _check_k(k, "knn_T")
    return _knn_launch(None, "sgt_knn_warp_v1", target_points, num_points, query, k)


# ----------------------------------------------------------------- K12 ----

@dataclass
class PrunedQueries:
    """The query half of K12's prologue: it changes with every query set."""

    qperm: torch.Tensor  # [Q] int64, sorted position → query row
    qkey: torch.Tensor  # [Q] int32, the queries' sorted Morton codes


def pruned_prepare_queries(target: PrunedTarget, query: torch.Tensor) -> PrunedQueries:
    """Sort the queries by the target's Morton code (int32 codes, one sort;
    the kernel finds each query's insertion position among the target's
    sorted codes itself)."""
    qkey, qperm = torch.sort(morton_codes32(query[:, :3], 1.0, target.origin),
                             stable=True)
    return PrunedQueries(qperm=qperm, qkey=qkey)


def pruned_query_positions(target: PrunedTarget, queries: PrunedQueries
                           ) -> torch.Tensor:
    """[Q] int64: each sorted query's insertion position among the target's
    sorted codes (the first whose code is not below the query's), as K12
    finds it by binary search over the valid rows (padding rows sort last,
    above every code)."""
    return torch.searchsorted(target.tkey, queries.qkey.to(target.tkey.dtype))


def pruned_plan(nq: int, sms: int, per_sm: Optional[int] = None) -> int:
    """Threads a query of K12 for ``nq`` queries on a card of ``sms`` SMs:
    the fewest of ``PRUNED_TEAMS`` whose blocks of ``BLOCK_QUERIES // team``
    queries reach ``per_sm`` (default ``PRUNED_BLOCKS_PER_SM``) blocks on
    every SM, else the most."""
    per_sm = PRUNED_BLOCKS_PER_SM if per_sm is None else per_sm
    for team in PRUNED_TEAMS:
        if _cdiv(nq * team, BLOCK_QUERIES) >= per_sm * sms:
            return team
    return PRUNED_TEAMS[-1]


def knn_pruned_plain(target_points: torch.Tensor, num_points: torch.Tensor,
                     query: torch.Tensor, k: int,
                     target: Optional[PrunedTarget] = None,
                     team: int = PRUNED_TEAMS[0],
                     cull_pass: int = morton_boxes.CULL_PASS) -> Pair:
    """Plain PyTorch version of K12: the same prologue, each query's reach
    over the ``bound_window(k)`` sorted target rows around its insertion
    position (or, where more target rows than that share its code, over as
    many rows spread evenly across them), and the box walk of
    ``morton_boxes.walk_lists_plain`` with
    ``team`` threads a query and passes of ``cull_pass`` boxes, each
    block's passes anchored at the box of its median query's insertion
    position. Equal to ``knn_plain`` for every team and pass length."""
    nq = query.shape[0]
    out_d = torch.full((nq, k), _BIG, dtype=query.dtype, device=query.device)
    out_i = torch.zeros((nq, k), dtype=torch.int32, device=query.device)
    if target is None:
        target = pruned_prepare_target(target_points, num_points)
    m = min(int(num_points), target_points.shape[0])
    if nq == 0 or m == 0:
        return out_d, out_i
    queries = pruned_prepare_queries(target, query)
    pos = pruned_query_positions(target, queries)
    end = torch.searchsorted(target.tkey, queries.qkey.to(target.tkey.dtype) + 1)
    q = query[queries.qperm, :3]
    xyz = target.tsorted[:, :3]
    w = morton_boxes.bound_window(k)
    run = torch.clamp(end, max=m) - pos
    long_run = run > w
    lo = torch.where(long_run, pos, torch.clamp(torch.clamp(pos - w // 2, max=m - w),
                                                  min=0))
    hi = torch.where(long_run, end, lo + w)
    step = torch.where(long_run, -(-run // w), 1)
    reach = morton_boxes.window_reach(xyz, m, q, lo, w, k, hi, step)
    block = BLOCK_QUERIES // team
    mids = torch.clamp(torch.arange(block // 2, nq + block // 2, block, device=pos.device),
                       max=nq - 1)
    anchors = (torch.clamp(pos[mids], max=m - 1) // TILE_ROWS).tolist()
    d, i = morton_boxes.walk_lists_plain(xyz, target.tperm, target.tbox, m, q, reach,
                                         anchors, k, team, cull_pass)
    out_d[queries.qperm], out_i[queries.qperm] = d, i
    return out_d, out_i


def knn_pruned_launch(target: PrunedTarget, num_points: torch.Tensor,
                      query: torch.Tensor, queries: PrunedQueries, k: int,
                      team: Optional[int] = None) -> Pair:
    """Kernel K12 alone, over a finished prologue: ``query`` float32 CUDA
    rows 3 or 4 floats apart, as ``knn_pruned`` passes them; ``team``
    threads a query (default ``pruned_plan``)."""
    _check_k(k, "knn_pruned")
    _require_search(target.tsorted, num_points, query)
    nq, mcap = query.shape[0], target.tsorted.shape[0]
    _build.require(target.tkey, "sorted codes", torch.int64, (mcap,))
    _build.require(queries.qperm, "qperm", torch.int64, (nq,))
    _build.require(queries.qkey, "qkey", torch.int32, (nq,))
    d, i = _empty(query, (nq, k))
    if nq == 0:
        return d, i
    lib = _library()
    if team is None:
        team = pruned_plan(nq, _sm_count(query.device.index))
    with torch.cuda.device(query.device):
        rc = lib.sgt_knn_pruned(
            target.tsorted.data_ptr(), num_points.data_ptr(), mcap,
            target.tbox.data_ptr(), target.tkey.data_ptr(), query.data_ptr(),
            query.stride(0), nq, queries.qperm.data_ptr(), queries.qkey.data_ptr(), k,
            morton_boxes.bound_window(k), int(team), d.data_ptr(), i.data_ptr(),
            _stream())
    _build.check(rc, "knn_pruned")
    knn_pruned.launches += 1
    return d, i


def _knn_pruned_v1(target: PrunedTarget, num_points: torch.Tensor, query: torch.Tensor,
                   queries: PrunedQueries, k: int,
                   qpos: Optional[torch.Tensor] = None) -> Pair:
    """K12's first form (a thread a query, the seed tiles, then every other
    box tested one after another and staged synchronously) over a finished
    prologue and the queries' insertion positions ``qpos`` [Q] int32
    (``pruned_query_positions``; computed here if None): the yardstick of
    the kernel above, on no path and counted nowhere."""
    _check_k(k, "knn_pruned")
    _require_search(target.tsorted, num_points, query)
    nq = query.shape[0]
    d, i = _empty(query, (nq, k))
    if nq == 0:
        return d, i
    if qpos is None:
        qpos = pruned_query_positions(target, queries).to(torch.int32)
    qperm = queries.qperm.to(torch.int32)
    lib = _library()
    with torch.cuda.device(query.device):
        rc = lib.sgt_knn_pruned_v1(
            target.tsorted.data_ptr(), num_points.data_ptr(), target.tsorted.shape[0],
            target.tbox.data_ptr(), query.data_ptr(), query.stride(0), nq,
            qperm.data_ptr(), qpos.data_ptr(), k, d.data_ptr(), i.data_ptr(), _stream())
    _build.check(rc, "knn_pruned_v1")
    return d, i


def knn_pruned(target_points: torch.Tensor, num_points: torch.Tensor,
               query: torch.Tensor, k: int,
               target: Optional[PrunedTarget] = None) -> Pair:
    """Exact kNN, k ≤ 64, with work ∝ local density: K10's results through
    a box walk over the Morton-sorted target. Kernel K12 on CUDA, plain
    version on the CPU. ``target`` is ``pruned_prepare_target(target_points,
    num_points)`` when the caller has it already (``KdTree`` keeps it)."""
    _check_k(k, "knn_pruned")
    if target_points.device.type == "cpu":
        return knn_pruned_plain(target_points, num_points, query, k, target)
    _require_search(target_points, num_points, query)
    q = _query_rows(query)
    if q.shape[0] == 0:
        return _empty(q, (0, k))
    if target is None:
        target = pruned_prepare_target(target_points, num_points)
    return knn_pruned_launch(target, num_points, q, pruned_prepare_queries(target, q), k)


knn_pruned.launches = 0
