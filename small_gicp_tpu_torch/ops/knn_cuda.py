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
    centring, ties to the lower index. One thread per query.
  * ``knn_T`` (K11) replaces ``knn_pallas_T`` (``_make_knn_kernel_T``):
    K10's contract with the other work mapping — one warp per query —
    bit-identical to K10. Reachable by this wrapper only, as in the JAX
    package.
  * ``knn_pruned`` (K12) replaces ``knn_pallas_pruned``
    (``_make_knn_listed_kernel``): K10's contract with work ∝ local
    density: Morton-sorted target, 256-row tile boxes, a seed pass over
    the five tiles around each query block's anchor, then only the tiles
    whose box is within the block's kth-distance bound. Ties go to the
    lower *original* index, so K12 equals K10 on every input (the Pallas
    kernel orders ties by the sorted-frame index).

Indices are int32, as in the JAX API. Slots for which no valid target row
is left (k > num_points) hold d² = 3e38 and index 0; the JAX kernels
return sentinel rows with d² > 1e16 there. Both mean "no neighbour" to
every caller; comparisons hold to slots with d² < 1e16.

Bound on the card: Q·M pairs at 9 float32 operations against 16·(Q+M)
bytes in and 8·k·Q out — operations, at every shape a scan produces. K12
is bounded by fewer pairs: the rows of the tiles that lie within a query
block's true kth distance, which depend on the data.
The kernels stream the target through shared memory; K10 bounds each
query's scan by the kth distance over a strided sample so that its list
insertions stay few; K12 skips whole tiles by a block-uniform branch.
See ``csrc/knn.cu``.

What a search derives from the target alone — K9's centre, the target
half of K12's prologue — can be passed in (``centre=``, ``target=``);
``KdTree`` computes each once and keeps it.

On a CUDA tensor every wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version beside it, which repeats the kernel's
arithmetic (and, for K12, its sort, boxes, seed and pruning rule).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from small_gicp_tpu_torch import _build
from small_gicp_tpu_torch.ops.knn import QUERY_BLOCK, sq_dists
from small_gicp_tpu_torch.ops.knn_window import morton_codes32

_BIG = 3.0e38
MAX_K = 64
VARIANTS = ("vpu", "mxu")
# Geometry of the pruned search: kTile, kKnnThreads and kSeedTiles of
# csrc/knn.cu, held against the compiled values when the library loads.
TILE_ROWS = 256
BLOCK_QUERIES = 64
SEED_TILES = 5

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


def _first_k(d2: torch.Tensor, ids: torch.Tensor, k: int) -> Pair:
    """k smallest columns of each row by stable sort; ``ids`` [L] names the
    columns. Empty slots: d² 3e38, index 0."""
    if d2.shape[1] < k:
        d2 = torch.cat([d2, d2.new_full((d2.shape[0], k - d2.shape[1]), _BIG)], dim=1)
        ids = torch.cat([ids, ids.new_zeros(k - ids.shape[0])])
    d_sorted, pos = torch.sort(d2, dim=1, stable=True)
    d_k = d_sorted[:, :k]
    idx = ids[pos[:, :k]]
    return d_k, torch.where(d_k < _BIG, idx, 0).to(torch.int32)


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


_geometry_checked = False


def _library():
    """The knn library; on its first load the pruned search's geometry is
    read back so that the prologue and the plain version cannot drift from
    the compiled kernel unnoticed."""
    global _geometry_checked
    lib = _build.library("knn")
    if not _geometry_checked:
        got = (ctypes.c_int * 3)()
        lib.sgt_knn_geometry(got)
        if tuple(got) != (TILE_ROWS, BLOCK_QUERIES, SEED_TILES):
            raise RuntimeError(
                f"csrc/knn.cu was compiled with (tile rows, block queries, seed "
                f"tiles) = {tuple(got)}; ops/knn_cuda.py has "
                f"{(TILE_ROWS, BLOCK_QUERIES, SEED_TILES)}")
        _geometry_checked = True
    return lib


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
    _require_search(target_points, num_points, query)
    q = _query_rows(query)
    nq = q.shape[0]
    d, i = _empty(q, (nq,))
    if nq == 0:
        return d, i
    if centre is None:
        centre = target_centre(target_points)
    else:
        _build.require(centre, "centre", torch.float32, (3,))
    centre = centre.contiguous()
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.sgt_nn1(target_points.data_ptr(), num_points.data_ptr(),
                         target_points.shape[0], q.data_ptr(), q.stride(0), nq,
                         centre.data_ptr(), VARIANTS.index(variant), d.data_ptr(),
                         i.data_ptr(), _stream())
    _build.check(rc, "nearest_neighbor")
    nearest_neighbor.launches += 1
    return d, i


nearest_neighbor.launches = 0


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
        d, i = _first_k(_masked_sq_dists(query[s:s + QUERY_BLOCK, :3], t, cols), ids, k)
        ds.append(d)
        idx.append(i)
    return torch.cat(ds), torch.cat(idx)


def _knn_launch(wrapper, entry: str, target_points, num_points, query, k) -> Pair:
    """Launch the K10 / K11 entry ``entry`` and count it on ``wrapper``."""
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
    wrapper.launches += 1
    return d, i


def knn(target_points: torch.Tensor, num_points: torch.Tensor, query: torch.Tensor,
        k: int) -> Pair:
    """Exact kNN, k ≤ 64: (d² [Q,k] ascending, idx [Q,k] int32), one thread
    per query. Kernel K10 on CUDA, plain version on the CPU."""
    _check_k(k, "knn")
    if target_points.device.type == "cpu":
        return knn_plain(target_points, num_points, query, k)
    return _knn_launch(knn, "sgt_knn", target_points, num_points, query, k)


knn.launches = 0


def knn_T(target_points: torch.Tensor, num_points: torch.Tensor, query: torch.Tensor,
          k: int) -> Pair:
    """``knn`` with one warp per query (kernel K11); bit-identical to it."""
    _check_k(k, "knn_T")
    if target_points.device.type == "cpu":
        return knn_plain(target_points, num_points, query, k)
    return _knn_launch(knn_T, "sgt_knn_warp", target_points, num_points, query, k)


knn_T.launches = 0


# ----------------------------------------------------------------- K12 ----

@dataclass
class PrunedTarget:
    """The target half of the pruned search's prologue. It depends on the
    target alone, so a caller that searches one target repeatedly builds it
    once (``KdTree.pruned_target``)."""

    tsorted: torch.Tensor  # [M,4] Morton-sorted x y z | original row (int32 bits)
    tperm: torch.Tensor  # [M] int64, sorted position → original row
    tbox: torch.Tensor  # [ceil(M/256), 8]: lo 3, 0, hi 3, 0 over valid rows
    tkey: torch.Tensor  # [M] int64 sorted keys: the code, 2³¹ for padding rows
    origin: torch.Tensor  # [3] min corner of the valid rows, the codes' origin


@dataclass
class PrunedQueries:
    """The query half: it changes with every query set."""

    qperm: torch.Tensor  # [Q] int32, sorted position → query row
    qpos: torch.Tensor  # [Q] int32, sorted position → position in tsorted


def pruned_prepare_target(target_points: torch.Tensor, num_points: torch.Tensor
                          ) -> PrunedTarget:
    """Sort the target by Morton code (cell 1.0, origin at the valid rows'
    min corner) and box every 256 sorted rows. Valid rows sort first,
    whatever their code. No host read of ``num_points``."""
    dev, dt = target_points.device, target_points.dtype
    t = target_points[:, :3]
    m = t.shape[0]
    valid = torch.arange(m, device=dev) < num_points
    if m > 0:
        origin = torch.where(valid[:, None], t, torch.inf).amin(dim=0)
        origin = torch.where(torch.isfinite(origin), origin, 0.0)
    else:
        origin = torch.zeros(3, dtype=dt, device=dev)
    codes = morton_codes32(t, 1.0, origin).to(torch.int64)
    tkey, tperm = torch.sort(torch.where(valid, codes, 2 ** 31), stable=True)
    tsorted = torch.empty((m, 4), dtype=dt, device=dev)
    tsorted[:, :3] = t[tperm]
    if dt == torch.float32:
        tsorted[:, 3] = tperm.to(torch.int32).view(torch.float32)
    else:
        tsorted[:, 3] = 0.0

    ntiles = (m + TILE_ROWS - 1) // TILE_ROWS
    padded = torch.zeros((ntiles * TILE_ROWS, 3), dtype=dt, device=dev)
    padded[:m] = tsorted[:, :3]
    live = (torch.arange(ntiles * TILE_ROWS, device=dev) < num_points)[:, None]
    tbox = torch.zeros((ntiles, 8), dtype=dt, device=dev)
    if ntiles > 0:
        tbox[:, 0:3] = torch.where(live, padded, _BIG).view(ntiles, TILE_ROWS, 3).amin(1)
        tbox[:, 4:7] = torch.where(live, padded, -_BIG).view(ntiles, TILE_ROWS, 3).amax(1)
    return PrunedTarget(tsorted=tsorted, tperm=tperm, tbox=tbox, tkey=tkey,
                        origin=origin)


def pruned_prepare_queries(target: PrunedTarget, query: torch.Tensor) -> PrunedQueries:
    """Sort the queries by the target's Morton code and find each one's
    insertion position among the sorted target rows."""
    codes = morton_codes32(query[:, :3], 1.0, target.origin).to(torch.int64)
    qkey, qperm = torch.sort(codes, stable=True)
    qpos = torch.searchsorted(target.tkey, qkey)
    return PrunedQueries(qperm=qperm.to(torch.int32), qpos=qpos.to(torch.int32))


def _lex_first_k(q: torch.Tensor, rows: torch.Tensor, orig: torch.Tensor, k: int
                 ) -> Pair:
    """k nearest of the sorted-frame ``rows`` [L,3] in (d², original index)
    order: columns are put in ascending original index (the minor key), then
    stably sorted by d² (the major key)."""
    order = torch.argsort(orig, stable=True)
    d2 = _masked_sq_dists(q, rows[order], torch.ones_like(order, dtype=torch.bool))
    return _first_k(d2, orig[order], k)


def knn_pruned_plain(target_points: torch.Tensor, num_points: torch.Tensor,
                     query: torch.Tensor, k: int,
                     target: Optional[PrunedTarget] = None) -> Pair:
    """Plain PyTorch version of K12: the same prologue, then for every block
    of 64 Morton-sorted queries the seed tiles, the block's kth-distance
    bound, the tiles whose box gap² is within it, and a search over those
    rows in the sorted frame mapped back to original rows. (The kernel also
    tightens the bound as it walks; the rows it skips beyond that cannot
    enter a list either.)"""
    nq = query.shape[0]
    out_d, out_i = _empty(query, (nq, k))
    if nq == 0:
        return out_d, out_i
    if target is None:
        target = pruned_prepare_target(target_points, num_points)
    tab = pruned_prepare_queries(target, query)
    m = min(int(num_points), target_points.shape[0])
    ntiles = (m + TILE_ROWS - 1) // TILE_ROWS
    rows, orig, tbox = target.tsorted[:, :3], target.tperm, target.tbox
    tile_of_row = torch.arange(m, device=query.device) // TILE_ROWS
    for b0 in range(0, nq, BLOCK_QUERIES):
        qrows = tab.qperm[b0:b0 + BLOCK_QUERIES].long()
        q = query[qrows, :3]
        sel = torch.zeros(0, dtype=torch.int64, device=query.device)
        if ntiles > 0:
            mid = min(b0 + BLOCK_QUERIES // 2, nq - 1)
            anchor = min(max(int(tab.qpos[mid]), 0), m - 1) // TILE_ROWS
            s_lo = max(0, anchor - SEED_TILES // 2)
            s_hi = min(ntiles - 1, anchor + SEED_TILES // 2)
            seed = slice(s_lo * TILE_ROWS, min(m, (s_hi + 1) * TILE_ROWS))
            d, _ = _lex_first_k(q, rows[seed], orig[seed], k)
            bound = d[:, k - 1].max()
            lo, hi = q.amin(dim=0), q.amax(dim=0)
            g = torch.clamp(torch.maximum(tbox[:ntiles, 0:3] - hi,
                                          lo - tbox[:ntiles, 4:7]), min=0.0)
            gap2 = g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2]
            keep = ~(gap2 > bound)
            keep[s_lo:s_hi + 1] = True
            sel = keep[tile_of_row].nonzero()[:, 0]
        out_d[qrows], out_i[qrows] = _lex_first_k(q, rows[sel], orig[sel], k)
    return out_d, out_i


def knn_pruned_launch(target: PrunedTarget, num_points: torch.Tensor,
                      query: torch.Tensor, queries: PrunedQueries, k: int) -> Pair:
    """Kernel K12 alone, over a finished prologue: ``query`` float32 CUDA
    rows 3 or 4 floats apart, as ``knn_pruned`` passes them."""
    _check_k(k, "knn_pruned")
    _require_search(target.tsorted, num_points, query)
    nq = query.shape[0]
    d, i = _empty(query, (nq, k))
    if nq == 0:
        return d, i
    lib = _library()
    with torch.cuda.device(query.device):
        rc = lib.sgt_knn_pruned(
            target.tsorted.data_ptr(), num_points.data_ptr(), target.tsorted.shape[0],
            target.tbox.data_ptr(), query.data_ptr(), query.stride(0), nq,
            queries.qperm.data_ptr(), queries.qpos.data_ptr(), k, d.data_ptr(),
            i.data_ptr(), _stream())
    _build.check(rc, "knn_pruned")
    knn_pruned.launches += 1
    return d, i


def knn_pruned(target_points: torch.Tensor, num_points: torch.Tensor,
               query: torch.Tensor, k: int,
               target: Optional[PrunedTarget] = None) -> Pair:
    """Exact kNN, k ≤ 64, with work ∝ local density: K10's results through
    a Morton-sorted, box-pruned search. Kernel K12 on CUDA, plain version
    on the CPU. ``target`` is ``pruned_prepare_target(target_points,
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
