"""Morton (z-order) codes and the multi-shift Morton-banded kNN searches,
in torch.

Counterpart of ``small_gicp_tpu/ops/knn_window.py``; the codes are
integer-exact against it. ``morton_codes32`` orders the target and the
queries of the pruned kNN search (``ops/knn_cuda.py``). ``morton_codes``
(21 bits an axis) orders the points along S shifted z-order curves, and
``knn_windowed`` / ``knn_windowed_query`` take each query's candidates from
the ±W rows around it on every curve: exact distances inside at most
S·(2W+1) candidates, duplicates dropped, the k nearest kept. The search is
approximate (≥ 97 % set recall at k = 20 with S = 4, W = 64 on LiDAR-like
clouds) and costs O((M+Q)·log + Q·S·W) instead of the exact O(Q·M).

These are torch ops on either device, as the JAX package's are XLA ops:
sorts, gathers and row sorts, no kernel. ``jax.lax.sort`` and
``lax.top_k`` put the lower index first on ties, so every ranking here is
a stable ``torch.sort``. The valid rows are the first ``num_points``
(``arange < num_points``): these searches take front-packed clouds.
Missed slots hold d² = inf, the JAX contract (the exact searches use
3e38); the covariance estimator treats both as invalid.
"""

from __future__ import annotations

import functools

import torch

_INT32_MAX = 2 ** 31 - 1
_INT64_MAX = torch.iinfo(torch.int64).max

# Fixed grid translations (units of the cell), spanning several octree
# levels so that no pair of neighbours sits on the same quadrant boundary
# on every curve: the JAX package's constants.
_SHIFTS = (
    (0.0, 0.0, 0.0),
    (39.55, 24.45, 15.11),
    (14.33, 45.76, 26.17),
    (54.62, 8.13, 35.89),
    (21.71, 33.28, 51.43),
    (47.06, 52.99, 7.61),
)


@functools.lru_cache(maxsize=None)
def _shift_table(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """[6,3] ``_SHIFTS`` on ``device``; made once (a copy of host values
    waits for the card)."""
    return torch.tensor(_SHIFTS, dtype=dtype, device=device)


def _dilate21(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 21 bits of int64 ``x`` to every third bit."""
    x = x & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """0-d tensor of ``value`` in ``like``'s dtype and device, filled on the
    device (a tensor argument is moved there)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=like.dtype)
    return torch.full((), value, dtype=like.dtype, device=like.device)


def morton_codes(points_xyz: torch.Tensor, cell) -> torch.Tensor:
    """[N,3] coordinates → [N] int64 Morton codes at ``cell`` resolution, 21
    bits an axis, offset 2^20 as the voxel keys are. Rows with a coordinate
    out of that range or not finite get the largest int64 (sort last)."""
    inv = torch.ones((), dtype=points_xyz.dtype, device=points_xyz.device) / _scalar(
        cell, points_xyz)
    c = torch.floor(points_xyz * inv)
    finite_c = torch.isfinite(c)
    # Clamp in floating point first: a float beyond the int64 range has no
    # defined integer conversion. The clamp keeps every out-of-range cell
    # out of range.
    ci = torch.where(finite_c, c, 0.0).clamp(-2.0 ** 22, 2.0 ** 22).to(torch.int64) + (1 << 20)
    in_range = torch.all((ci >= 0) & (ci < (1 << 21)) & finite_c, dim=-1)
    code = (_dilate21(ci[..., 2]) << 2) | (_dilate21(ci[..., 1]) << 1) | _dilate21(ci[..., 0])
    return torch.where(in_range, code, _INT64_MAX)


def _dilate10_32(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 ``x`` to every third bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


@functools.lru_cache(maxsize=None)
def _axis_bits(device: torch.device):
    """([3·1024] int32: cell c of axis a dilated and shifted into place at
    a·1024 + c, [3] int32: the axes' offsets a·1024). A code is the sum of
    its three axes' entries (their bits never overlap): one gather in place
    of the shifts and masks."""
    c = _dilate10_32(torch.arange(1024, dtype=torch.int32, device=device))
    return (torch.cat([c, c << 1, c << 2]),
            torch.tensor([0, 1024, 2048], dtype=torch.int32, device=device))


def morton_codes32(points_xyz: torch.Tensor, cell, origin=None) -> torch.Tensor:
    """[N,3] coordinates → [N] int32 Morton codes at ``cell`` resolution,
    10 bits per axis.

    ``origin`` anchors cell 0 (pass the cloud's min corner); the default
    origin is −512·cell. Coordinates outside the 1024-cell range clamp to
    the boundary cell; only rows with a non-finite coordinate get the
    largest int32, so they sort last.
    """
    inv = torch.ones((), dtype=points_xyz.dtype, device=points_xyz.device) / cell
    if origin is None:
        rel = points_xyz * inv + 512.0
    else:
        rel = (points_xyz - origin) * inv
    c = torch.floor(rel)
    finite_c = torch.isfinite(c)
    # Clamp in floating point first: a float beyond the int32 range has no
    # defined integer conversion.
    bits, offsets = _axis_bits(c.device)
    ci = torch.where(finite_c, c, 0.0).clamp(0.0, 1023.0).to(torch.int32) + offsets
    code = bits[ci].sum(dim=-1, dtype=torch.int32)
    return torch.where(finite_c.all(dim=-1), code, _INT32_MAX)


def _check_band(k: int, window: int, shifts: int) -> int:
    if not 1 <= shifts <= len(_SHIFTS):
        raise ValueError(f"shifts must be in [1, {len(_SHIFTS)}]")
    band = 2 * window + 1
    if k > shifts * band:
        raise ValueError(f"k={k} exceeds total candidates {shifts * band}")
    return band


def _band_d2(xp: torch.Tensor, start: torch.Tensor, band: int, q: torch.Tensor
             ) -> torch.Tensor:
    """[Q,band] d² from queries ``q`` [Q,3] to rows start … start+band-1 of
    the padded curve table ``xp`` (indices past its end read its last row, as
    an XLA gather clamps); padding rows (+inf) give inf, never nan."""
    cols = torch.arange(band, device=xp.device)
    win = xp[torch.clamp(start[:, None] + cols[None, :], max=xp.shape[0] - 1)]
    d = win - q[:, None, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return torch.where(torch.isfinite(d2), d2, torch.inf)


def _dedup_top_k(d_cat: torch.Tensor, i_cat: torch.Tensor, k: int, shifts: int):
    """The k nearest distinct ids of each row of the candidates (d² [Q,C],
    ids [Q,C]): the top-(S·k) cut, the (id, d²) order with repeats masked to
    inf, then the top k, each ranking by stable sort as ``lax.top_k`` and
    ``lax.sort`` rank."""
    cut = min(shifts * k, d_cat.shape[1])
    d_cut, pos = torch.sort(d_cat, dim=1, stable=True)
    d_cut, i_cut = d_cut[:, :cut], torch.gather(i_cat, 1, pos[:, :cut])
    # Two keys (id, then d²) as two stable sorts: by d², then by id.
    by_id = torch.sort(i_cut, dim=1, stable=True)[1]
    i_srt = torch.gather(i_cut, 1, by_id)
    d_srt = torch.gather(d_cut, 1, by_id)
    dup = torch.zeros_like(i_srt, dtype=torch.bool)
    dup[:, 1:] = i_srt[:, 1:] == i_srt[:, :-1]
    d_srt = torch.where(dup, torch.inf, d_srt)
    d_k, pos = torch.sort(d_srt, dim=1, stable=True)
    return d_k[:, :k], torch.gather(i_srt, 1, pos[:, :k])


def knn_windowed(points: torch.Tensor, num_points, k: int, window: int = 64,
                 cell=1.0, shifts: int = 4):
    """Approximate self-kNN of a front-packed cloud: points [N,4] (or [N,3]),
    rows ≥ ``num_points`` padding. k counts the point itself (at d² 0);
    ``window`` is the band half-width W, ``shifts`` the number of curves S,
    ``cell`` the Morton cell.

    Returns (sq_dists [N,k], idx [N,k] int32) in the cloud's row order,
    ascending, no repeated index; missed and padded slots hold inf.
    """
    n = points.shape[0]
    dt, dev = points.dtype, points.device
    xyz = points[:, :3]
    w, s = int(window), int(shifts)
    band = _check_band(k, w, s)
    cell_t = _scalar(cell, xyz)
    rows = torch.arange(n, device=dev)
    valid = rows < num_points
    xyz_m = torch.where(valid[:, None], xyz, torch.inf)
    pad = xyz.new_full((w, 3), torch.inf)
    shift_tab = _shift_table(dev, dt)

    d_all, i_all = [], []
    for si in range(s):
        codes = torch.where(valid, morton_codes(xyz + shift_tab[si] * cell_t, cell_t),
                            _INT64_MAX)
        perm = torch.sort(codes, stable=True)[1]
        xs = xyz_m[perm]  # curve order; padding rows +inf
        # Curve row i pairs with curve rows i-W … i+W: rows i … i+2W of the
        # W-padded table.
        d2 = _band_d2(torch.cat([pad, xs, pad]), rows, band, xs)
        src = torch.clamp(rows[:, None] + torch.arange(band, device=dev)[None, :] - w,
                          0, n - 1)
        idx = perm[src].to(torch.int32)
        inv = torch.empty_like(perm)
        inv[perm] = rows  # back to row order
        d_all.append(d2[inv])
        i_all.append(idx[inv])
    return _dedup_top_k(torch.cat(d_all, dim=1), torch.cat(i_all, dim=1), k, s)


def knn_windowed_query(target_points: torch.Tensor, target_num, query_xyz: torch.Tensor,
                       k: int, window: int = 64, cell=1.0, shifts: int = 4):
    """Approximate kNN of queries [Q,3] in a front-packed target [M,4]: the
    target sorted along the S curves, each query placed on every curve by
    ``searchsorted`` and its candidates the ±W target rows around that place.

    Returns (sq_dists [Q,k], idx [Q,k] int32), ascending, no repeated index;
    missed slots hold inf.
    """
    m = target_points.shape[0]
    dt, dev = target_points.dtype, target_points.device
    txyz = target_points[:, :3]
    qxyz = query_xyz[:, :3].to(dt)
    w, s = int(window), int(shifts)
    band = _check_band(k, w, s)
    cell_t = _scalar(cell, txyz)
    trows = torch.arange(m, device=dev)
    valid_t = trows < target_num
    txyz_m = torch.where(valid_t[:, None], txyz, torch.inf)
    pad = txyz.new_full((w, 3), torch.inf)
    shift_tab = _shift_table(dev, dt)
    cols = torch.arange(band, device=dev)

    d_all, i_all = [], []
    for si in range(s):
        shift = shift_tab[si] * cell_t
        codes_t = torch.where(valid_t, morton_codes(txyz + shift, cell_t), _INT64_MAX)
        codes_sorted, perm = torch.sort(codes_t, stable=True)
        xs = txyz_m[perm]
        pos = torch.searchsorted(codes_sorted, morton_codes(qxyz + shift, cell_t))
        # Target rows pos-W … pos+W sit at pos … pos+2W of the padded table.
        d_all.append(_band_d2(torch.cat([pad, xs, pad]), pos, band, qxyz))
        src = torch.clamp(pos[:, None] + cols[None, :] - w, 0, m - 1)
        i_all.append(perm[src].to(torch.int32))
    return _dedup_top_k(torch.cat(d_all, dim=1), torch.cat(i_all, dim=1), k, s)
