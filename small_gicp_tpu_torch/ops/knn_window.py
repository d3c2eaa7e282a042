"""Morton (z-order) codes, in torch.

Counterpart of ``morton_codes32`` in ``small_gicp_tpu/ops/knn_window.py``,
integer-exact against it. The pruned kNN search (``ops/knn_cuda.py``)
sorts its target and its queries by these codes; the windowed approximate
searches of that module are not ported yet.
"""

from __future__ import annotations

import functools

import torch

_INT32_MAX = 2 ** 31 - 1


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
