"""Helpers the drivers share: seeded draws, scan pools made on the device,
noisy initial guesses, and the comparison of a registration's answer with
the reference's."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from gicp_bench import synthetic
from gicp_bench.reference import gicp as ref_gicp
from gicp_bench.reference import preprocess as ref_pre
from gicp_bench.reference.lie import pose_gap, se3_exp
from gicp_bench.reference.precision import F64, Precision

# Covariances are compared by each row's largest entry gap scaled by the
# reference neighbourhood's conditioning (λ₁ − λ₀)/λ₂: the regularised
# covariance I − (1 − 1e-3)·v₀v₀ᵀ turns with v₀, which float rounding of the
# moments moves by about (rounding)·λ₂/(λ₁ − λ₀), so the scaled gap is the
# rounding of the moments themselves, whatever the row's shape. The 99th
# percentile over rows leaves out the few rows whose k-th neighbour is a
# near tie that float32 and float64 break differently.
COV_QUANTILE = 0.99


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_cached(device) -> None:
    """Return the caching allocator's free blocks (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def rng(seed: int, salt: int) -> np.random.Generator:
    """An independent generator for each (seed, purpose)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), salt]))


def se3_exp_np(tw: np.ndarray) -> np.ndarray:
    """[P,6] twists → [P,4,4] float64 (Rodrigues)."""
    out = np.tile(np.eye(4), (tw.shape[0], 1, 1))
    for i, t in enumerate(tw):
        w, v = t[:3], t[3:]
        th = float(np.linalg.norm(w))
        W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        if th < 1e-8:
            a, b, c = 1.0, 0.5, 1.0 / 6.0
        else:
            a, b, c = math.sin(th) / th, (1 - math.cos(th)) / th**2, (th - math.sin(th)) / th**3
        out[i, :3, :3] = np.eye(3) + a * W + b * W @ W
        out[i, :3, 3] = (np.eye(3) + b * W + c * W @ W) @ v
    return out


def noisy_guesses(T_rel: np.ndarray, g: np.random.Generator, sigma_rot: float,
                  sigma_trans: float) -> np.ndarray:
    """T_rel [P,4,4] · exp(twist), twist ~ N(0, σ_rot² I₃ | σ_trans² I₃)."""
    tw = np.concatenate([g.normal(size=(len(T_rel), 3)) * sigma_rot,
                         g.normal(size=(len(T_rel), 3)) * sigma_trans], axis=1)
    return T_rel @ se3_exp_np(tw)


class ScanPool:
    """Frames of the configuration's scanner on its loop, made on the
    device: ``n_frames`` consecutive ones from a start drawn from the seed,
    or, with ``ids``, those frames of the loop (the same for every seed)."""

    def __init__(self, config: dict, n_frames: int, seed: int, device,
                 frame_dist: float = None, pad_rows: int = None, ids=None):
        sc, wo = config["scanner"], config["world"]
        lap = 2 * math.pi * wo["radius"] / (frame_dist or config["frame_dist"])
        self.start = int(rng(seed, 1).integers(0, int(round(lap))))
        self.ids = (self.start + np.arange(n_frames) if ids is None
                    else np.asarray(ids, dtype=np.int64))
        n_frames = len(self.ids)
        self.frame_dist = frame_dist or config["frame_dist"]
        self.poses = synthetic.loop_trajectory(self.ids, radius=wo["radius"],
                                               frame_dist=self.frame_dist)
        world = synthetic.make_world(seed=wo["seed"], radius=wo["radius"])
        frames, counts = synthetic.generate_frames(
            self.poses, world, int(rng(seed, 2).integers(0, 1 << 62)),
            rings=sc["rings"], azimuth_steps=sc["azimuth_steps"],
            max_range=sc["max_range"], noise=sc["noise"], device=device)
        if pad_rows is not None and pad_rows > frames.shape[1]:
            pad = torch.empty((n_frames, pad_rows, 4), dtype=frames.dtype, device=device)
            pad[:, :, :3] = synthetic.PAD_SENTINEL
            pad[:, :, 3] = 0.0
            pad[:, :frames.shape[1]] = frames
            frames = pad
        self.frames, self.counts = frames, counts
        self.counts_host = counts.cpu().numpy()

    def raw(self, i: int) -> torch.Tensor:
        """Frame i's returns [n,4] (no padding rows)."""
        return self.frames[i, :int(self.counts_host[i])]

    def relative(self, i_target: int, i_source: int) -> np.ndarray:
        return synthetic.relative_pose(self.poses[i_target], self.poses[i_source])


def pair_pool(config: dict, pairs: int, seed: int, device) -> ScanPool:
    """``pairs`` pairs of consecutive frames spread evenly round the loop,
    the same for every seed (the seed moves the sensor noise): pair p is
    frames 2p (the target) and 2p + 1 (the source) of the pool."""
    lap = 2 * math.pi * config["world"]["radius"] / config["frame_dist"]
    starts = np.round(np.arange(pairs) * lap / pairs).astype(np.int64)
    return ScanPool(config, 2 * pairs, seed, device,
                    ids=np.stack([starts, starts + 1], 1).reshape(-1))


class RefClouds:
    """The reference's preprocessing of a pool's frames, made once each."""

    def __init__(self, pool: ScanPool, leaf: float, k: int, prec: Precision = F64,
                 max_points: int = None):
        self.pool, self.leaf, self.k, self.prec = pool, leaf, k, prec
        self.max_points = max_points
        self.cache: Dict[int, tuple] = {}

    def __call__(self, i: int):
        if i not in self.cache:
            raw = self.pool.raw(i)[:, :3]
            self.cache[i] = ref_pre.preprocess(raw, self.leaf, self.k, self.prec,
                                               self.max_points)
        return self.cache[i]


def cloud_gaps(points: torch.Tensor, num: int, covs: torch.Tensor, ref):
    """A program cloud (rows in key order) against the reference's (keys,
    means, covs, eigenvalues): (voxels off in count, the largest point gap
    in metres, each row's scaled covariance gap [n])."""
    _, means, rcovs, ev = ref
    n = min(num, means.shape[0])
    p = points[:n, :3].to(means.device, torch.float64)
    gap = float((p - means[:n].double()).norm(dim=1).max()) if n else 0.0
    c = covs[:n].to(means.device, torch.float64)
    ev = ev[:n].double()
    cond = (ev[:, 1] - ev[:, 0]) / ev[:, 2].clamp(min=1e-30)
    rows = (c - rcovs[:n].double()).abs().amax((1, 2)) * cond
    return abs(num - means.shape[0]), gap, rows


def cloud_numbers(gaps) -> Dict[str, float]:
    """The numbers of a list of ``cloud_gaps``."""
    rows = torch.cat([g[2] for g in gaps])
    return {"voxels_off": sum(g[0] for g in gaps),
            "point_gap_m": max(g[1] for g in gaps),
            "cov_gap_p99": float(torch.quantile(rows.cpu(), COV_QUANTILE))}


def live(points: torch.Tensor, num: int, covs: torch.Tensor):
    """A cloud's first ``num`` rows as the reference takes them: (points
    [n,3], covariances [n,3,3]) in float64."""
    return points[:num, :3].double(), covs[:num].double()


def grid_of(cloud, config: dict, prec: Precision = F64) -> ref_gicp.Grid:
    return ref_gicp.Grid(cloud[0], config["max_correspondence_distance"], prec)


def reference_registration(tgt, src, T0, config: dict, prec: Precision = F64,
                           grid: ref_gicp.Grid = None):
    """The reference's registration of the cloud ``src`` to ``tgt`` (each
    (points, covariances)) from T0."""
    T0 = torch.as_tensor(T0, dtype=prec.dtype, device=tgt[0].device)
    return ref_gicp.gicp_lm(tgt[0], tgt[1], src[0], src[1], T0, prec,
                            **lm_settings(config), grid=grid)


def as_answer(r) -> dict:
    """A reference ``Result`` in the form of the program's answers."""
    return dict(T=r.T.cpu().numpy(), iterations=r.iterations, inliers=r.inliers,
                converged=r.converged, H=r.H.cpu(), b=r.b.cpu(), error=r.error)


def last_linearization_pose(T, H, b) -> torch.Tensor:
    """The pose a registration last linearized at, from its answer: T·exp(−δ)
    with δ = −H⁻¹b, its last step (the LM damping, λ ≪ H, left out). Only
    for answers whose last step was accepted (converged ones)."""
    T = torch.as_tensor(T, dtype=torch.float64)
    H = torch.as_tensor(H, dtype=torch.float64, device=T.device)
    b = torch.as_tensor(b, dtype=torch.float64, device=T.device)
    delta = -torch.linalg.solve(H, b)
    return T @ se3_exp(-delta)


def answer_numbers(answer: dict, tgt, src, config: dict, grid=None,
                   ref=None) -> Dict[str, float]:
    """One answer ({T, iterations, inliers, converged, H, b, error}) of a
    registration of ``src`` to ``tgt`` against the reference. For a
    converged answer: its last linearization's inlier count, H and error
    against the reference's at the same pose (relative gaps). With ``ref``,
    the reference's registration from the same guess over the same clouds:
    the pose's gap, the iterations off and whether both converged alike."""
    out = {"inliers_gap": 0.0, "H_gap": 0.0, "error_gap": 0.0}
    if answer["converged"]:
        dev = tgt[0].device
        T = torch.as_tensor(answer["T"], dtype=torch.float64, device=dev)
        T_lin = last_linearization_pose(T, answer["H"], answer["b"])
        H, n, e = ref_gicp.linearization(
            tgt[0], tgt[1], src[0], src[1], T_lin, T, F64,
            max_dist=config["max_correspondence_distance"], grid=grid)
        Hp = torch.as_tensor(answer["H"], dtype=torch.float64, device=H.device)
        out["H_gap"] = float(torch.linalg.norm(Hp - H) / torch.linalg.norm(H))
        out["inliers_gap"] = abs(int(answer["inliers"]) - n) / max(n, 1)
        out["error_gap"] = abs(float(answer["error"]) - e) / max(abs(e), 1e-30)
    if ref is not None:
        dr, dt = pose_gap(answer["T"], ref.T.cpu())
        out.update(rot_gap_deg=dr, trans_gap_m=dt,
                   iters_off=abs(int(answer["iterations"]) - ref.iterations),
                   converged_off=int(bool(answer["converged"]) != ref.converged))
    return out


def registration_numbers(rows: List[Dict[str, float]], keys) -> Dict[str, float]:
    """The largest of each number in ``keys`` over the compared answers
    (``converged_off`` summed)."""
    return {k: (sum(r[k] for r in rows) if k == "converged_off"
                else max((r[k] for r in rows), default=0.0)) for k in keys}


def lm_settings(config: dict) -> dict:
    return dict(max_dist=config["max_correspondence_distance"],
                max_iterations=config["max_iterations"],
                max_inner_iterations=config["max_inner_iterations"],
                rotation_eps=config["rotation_eps"],
                translation_eps=config["translation_eps"])
