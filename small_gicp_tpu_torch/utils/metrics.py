"""Trajectory accuracy metrics: APE and RPE of the translation, in numpy.

Counterpart of ``small_gicp_tpu/utils/metrics.py``: the conventions of
evo's ``ape --pose_relation trans_part -a`` and ``rpe --delta D
--pose_relation trans_part``, which the reference's accuracy scripts use
(scripts/plot_odometry_accuracy.py:25-36), without the evo package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_kitti_trajectory(path: str) -> np.ndarray:
    """KITTI pose file (12 values a row, 3x4 row-major) → [F,4,4]."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :] = rows
    return out


def umeyama_alignment(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid (no-scale) T with dst ≈ T·src (Umeyama 1991, evo's -a flag);
    src, dst: [F,3] positions."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = mu_d - R @ mu_s
    return T


def ape_translation(est: np.ndarray, gt: np.ndarray, align: bool = True
                    ) -> Tuple[float, float]:
    """Absolute pose error of the translation part, (mean, std), after a
    rigid alignment of the positions unless ``align`` is False."""
    p_est, p_gt = est[:, :3, 3], gt[:, :3, 3]
    if align:
        T = umeyama_alignment(p_est, p_gt)
        p_est = p_est @ T[:3, :3].T + T[:3, 3]
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return float(err.mean()), float(err.std())


def rpe_translation(est: np.ndarray, gt: np.ndarray, delta: int = 100
                    ) -> Tuple[float, float]:
    """Relative pose error of the translation over a fixed frame delta,
    (mean, std); (0, 0) when the trajectory is shorter than ``delta``."""
    errs = []
    for i in range(len(est) - delta):
        d_est = np.linalg.inv(est[i]) @ est[i + delta]
        d_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(d_gt) @ d_est
        errs.append(np.linalg.norm(e[:3, 3]))
    if not errs:
        return 0.0, 0.0
    errs = np.asarray(errs)
    return float(errs.mean()), float(errs.std())
