"""Closed-form 3x3 and 6x6 linear algebra, in torch.

Counterpart of ``small_gicp_tpu/ops/eigh3.py``: the smallest eigenvector
of a symmetric 3x3 (normals and plane-regularised covariances), the
adjugate 3x3 inverse with its determinant guard, and the damped 6x6
Cholesky solve of the optimizer. All are batched over leading
dimensions and written out in elementwise torch ops.
"""

from __future__ import annotations

import math

import torch


def smallest_eigvec3x3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3].

    Trigonometric root of the characteristic cubic, then the kernel of
    A − λ₀I as the largest cross product of its rows. A ≈ c·I returns
    e₀ = (1, 0, 0).
    """
    dtype = A.dtype
    tiny = 1e-30 if dtype == torch.float64 else 1e-20
    eye = torch.eye(3, dtype=dtype, device=A.device)
    A = 0.5 * (A + A.transpose(-1, -2))

    scale = torch.amax(torch.abs(A), dim=(-1, -2), keepdim=True)
    s = torch.where(scale > tiny, scale, torch.ones_like(scale))
    As = A / s

    q = (As[..., 0, 0] + As[..., 1, 1] + As[..., 2, 2]) / 3.0
    B = As - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-1, -2)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    safe_p = torch.where(p > tiny, p, torch.ones_like(p))
    r = torch.clamp(detB / (2.0 * safe_p**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    # Roots q + 2p·cos(phi + 2πk/3); phi ∈ [0, π/3] ⇒ k=1 is the smallest.
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    C = As - lam0[..., None, None] * eye
    c01 = torch.linalg.cross(C[..., 0, :], C[..., 1, :])
    c02 = torch.linalg.cross(C[..., 0, :], C[..., 2, :])
    c12 = torch.linalg.cross(C[..., 1, :], C[..., 2, :])
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    v = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    nv = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    ok = (nv > tiny) & (p > tiny)[..., None]
    e0 = torch.zeros_like(v)
    e0[..., 0] = 1.0
    return torch.where(ok, v / torch.where(ok, nv, torch.ones_like(nv)), e0)


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 inverse by adjugate; |det| < 1e-30 gives the zero matrix."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    bad = torch.abs(det) < 1e-30
    inv_det = torch.where(bad, torch.zeros_like(det),
                          1.0 / torch.where(bad, torch.ones_like(det), det))
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], dim=-1),
            torch.stack([co10, co11, co12], dim=-1),
            torch.stack([co20, co21, co22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def solve6x6(H: torch.Tensor, b: torch.Tensor,
             damping: torch.Tensor) -> torch.Tensor:
    """Solve (H + damping·I) x = b for symmetric 6x6 H by Cholesky.

    Batched: H [..., 6, 6], b [..., 6], damping [...] broadcast together
    (the LM trials share H and differ in damping).
    """
    damping = torch.as_tensor(damping, dtype=H.dtype, device=H.device)
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    A = H + damping[..., None, None] * eye
    b = b.expand(A.shape[:-1])
    return _cholesky_solve6(A, b)


def _cholesky_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cholesky solve of [..., 6, 6] SPD systems, one column at a time.

    A non-positive pivot (indefinite H from rounding) is clamped to 1e-30,
    which yields a large but finite step that the LM accept test rejects.
    """
    n = 6
    L = torch.zeros_like(A)
    for j in range(n):
        # s[i] = A[i, j] − Σ_{k<j} L[i, k]·L[j, k] for rows i ≥ j
        s = A[..., j:, j] - torch.sum(
            L[..., j:, :j] * L[..., j:j + 1, :j], dim=-1
        )
        diag = torch.sqrt(torch.clamp(s[..., 0], min=1e-30))
        L[..., j, j] = diag
        L[..., j + 1:, j] = s[..., 1:] / diag[..., None]
    y = torch.zeros_like(b)
    for i in range(n):
        y[..., i] = (b[..., i] - torch.sum(L[..., i, :i] * y[..., :i], dim=-1)
                     ) / L[..., i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[..., i] = (y[..., i] - torch.sum(L[..., i + 1:, i] * x[..., i + 1:],
                                           dim=-1)) / L[..., i, i]
    return x
