"""SE(3) helpers of the reference, in the dtype of their inputs."""

from __future__ import annotations

import math

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] → [..., 3, 3] cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def se3_exp(twist: torch.Tensor) -> torch.Tensor:
    """[6] twist [ω | ν] → [4,4]: rotation by Rodrigues' formula, translation
    V·ν, with the series of the coefficients below θ² = 1e-10."""
    w, v = twist[:3], twist[3:]
    th2 = torch.dot(w, w)
    th = torch.sqrt(th2)
    if float(th2) < 1e-10:
        a, b, c = 1.0 - th2 / 6.0, 0.5 - th2 / 24.0, 1.0 / 6.0 - th2 / 120.0
    else:
        a, b, c = torch.sin(th) / th, (1.0 - torch.cos(th)) / th2, (th - torch.sin(th)) / (th2 * th)
    W = skew(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device)
    T = torch.eye(4, dtype=twist.dtype, device=twist.device)
    T[:3, :3] = eye + a * W + b * W2
    T[:3, 3] = (eye + b * W + c * W2) @ v
    return T


def pose_gap(T_a, T_b):
    """(rotation gap in degrees, translation gap in metres) between two
    [4,4] poses, in float64."""
    A = torch.as_tensor(T_a, dtype=torch.float64)
    B = torch.as_tensor(T_b, dtype=torch.float64, device=A.device)
    R = A[:3, :3].T @ B[:3, :3]
    c = float(torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0))
    # acos loses precision near 0: take the angle from the skew part there.
    s = float(torch.linalg.vector_norm(torch.stack(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]))) / 2.0
    ang = math.atan2(s, c)
    return math.degrees(ang), float(torch.linalg.vector_norm(A[:3, 3] - B[:3, 3]))
