"""SE(3)/SO(3) exponential maps, the skew operator and pose hygiene, in torch.

Counterpart of ``small_gicp_tpu/utils/lie.py``. Twist order is
[rx ry rz tx ty tz] (rotation first) and pose updates right-multiply,
T ← T · se3_exp(delta). The small-angle branches are selected with
``torch.where`` on a clamped angle, so every function is batched over
leading dimensions and branch-free.
"""

from __future__ import annotations

import math

import torch

_SMALL_ANGLE = 1e-5
_C_TAYLOR_ANGLE = 1e-2  # switch point for the cancellation-prone c coeff


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector: [..., 3] → [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _rotation_coeffs(theta_sq: torch.Tensor):
    """(sinθ/θ, (1−cosθ)/θ², (θ−sinθ)/θ³) with small-angle Taylor branches.

    (1−cosθ) is formed as 2·sin²(θ/2) (no cancellation), and the
    (θ−sinθ)/θ³ coefficient switches to its series below θ = 0.01.
    """
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    one = torch.ones_like(theta)
    small = theta < _SMALL_ANGLE
    safe_theta = torch.where(small, one, theta)
    safe_sq = safe_theta * safe_theta

    sin_t = torch.sin(safe_theta)
    sin_half = torch.sin(0.5 * safe_theta)
    a_exact = sin_t / safe_theta
    b_exact = 2.0 * sin_half * sin_half / safe_sq

    a_taylor = 1.0 - theta_sq / 6.0 * (1.0 - theta_sq / 20.0)
    b_taylor = 0.5 - theta_sq / 24.0 * (1.0 - theta_sq / 30.0)

    a = torch.where(small, a_taylor, a_exact)
    b = torch.where(small, b_taylor, b_exact)

    small_c = theta < _C_TAYLOR_ANGLE
    safe_theta_c = torch.where(small_c, one, theta)
    c_exact = (safe_theta_c - torch.sin(safe_theta_c)) / (
        safe_theta_c * safe_theta_c * safe_theta_c
    )
    c_taylor = (1.0 / 6.0) * (1.0 - theta_sq / 20.0 * (1.0 - theta_sq / 42.0))
    c = torch.where(small_c, c_taylor, c_exact)
    return a, b, c


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of an so(3) vector: [..., 3] → [..., 3, 3] (Rodrigues)."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    a, b, _ = _rotation_coeffs(theta_sq)
    W = skew(omega)
    W2 = W @ W
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def se3_exp(twist: torch.Tensor) -> torch.Tensor:
    """SE(3) exp of a twist [..., 6] = [rx ry rz tx ty tz] → [..., 4, 4]."""
    omega = twist[..., :3]
    nu = twist[..., 3:]
    theta_sq = torch.sum(omega * omega, dim=-1)
    a, b, c = _rotation_coeffs(theta_sq)

    W = skew(omega)
    W2 = W @ W
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ nu[..., None])[..., 0]

    T = torch.zeros(twist.shape[:-1] + (4, 4), dtype=twist.dtype,
                    device=twist.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse of so3_exp: [..., 3, 3] → [..., 3], valid for θ < π.

    θ comes from atan2(sinθ, cosθ), which stays accurate near 0 and π.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )  # = 2 sinθ · axis
    sin_theta = 0.5 * torch.linalg.vector_norm(w, dim=-1)
    cos_theta = 0.5 * (trace - 1.0)
    theta = torch.atan2(sin_theta, cos_theta)
    small = theta < _SMALL_ANGLE
    safe_sin = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    scale_exact = theta / (2.0 * safe_sin)
    scale_taylor = 0.5 + theta * theta / 12.0
    scale = torch.where(small, scale_taylor, scale_exact)
    return w * scale[..., None]


def rotation_error_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angle between two rotations in degrees."""
    dR = Ra.transpose(-1, -2) @ Rb
    return torch.linalg.vector_norm(so3_log(dR), dim=-1) * (180.0 / math.pi)


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform [R t; 0 1]."""
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = torch.eye(4, dtype=T.dtype, device=T.device)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -(R.T @ t)
    return Ti


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """T with its rotation block re-projected onto SO(3) by one Newton sweep,
    R ← R(1.5I − 0.5RᵀR), batched over leading dims; the translation is
    untouched. Float32 pose products drift off the manifold over hundreds
    of compositions; one sweep restores orthogonality to float32 roundoff
    for inputs within ~1e-3 of SO(3)."""
    R = T[..., :3, :3]
    RtR = R.transpose(-1, -2) @ R
    eye3 = torch.eye(3, dtype=T.dtype, device=T.device)
    out = T.clone()
    out[..., :3, :3] = R @ (1.5 * eye3 - 0.5 * RtR)
    return out
