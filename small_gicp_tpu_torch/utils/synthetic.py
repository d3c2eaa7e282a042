"""Synthetic LiDAR scan generator.

The port's own copy of ``small_gicp_tpu/utils/synthetic.py``: an analytic
outdoor world (ground plane, pillars, boxes), a spinning multi-ring range
scanner and a circular trajectory with exact ground-truth poses. The host
generator (numpy) returns bit-identical scans for the same arguments.
``rings=64, azimuth_steps=1800`` gives a KITTI HDL-64-like frame of about
108k points. ``generate_sequence_device`` runs the same raycaster as torch
ops on a device (default: the card), writing padded frames straight into
device memory, with range noise, ray dropout and moving objects; its
random stream is torch's, so its frames agree with JAX's in statistics,
not bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch


@dataclass
class SyntheticWorld:
    """Analytic scene: z=0 ground + vertical cylinders + axis-aligned boxes."""

    cyl_xy: np.ndarray  # [K,2]
    cyl_r: np.ndarray  # [K]
    cyl_h: np.ndarray  # [K]
    box_min: np.ndarray  # [B,3]
    box_max: np.ndarray  # [B,3]


def make_world(
    seed: int = 0,
    radius: float = 80.0,
    corridor: float = 22.0,
    n_cylinders: int = 260,
    n_boxes: int = 70,
) -> SyntheticWorld:
    """Scatter pillars and buildings in an annulus around the loop path
    (radius ± corridor) so every frame sees structure at many ranges."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n_cylinders)
    rad = radius + rng.uniform(-corridor, corridor, n_cylinders)
    # keep a clear band on the path itself
    rad += np.sign(rad - radius) * 3.5
    cyl_xy = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
    cyl_r = rng.uniform(0.15, 0.8, n_cylinders)
    cyl_h = rng.uniform(2.0, 9.0, n_cylinders)

    angb = rng.uniform(0, 2 * np.pi, n_boxes)
    radb = radius + rng.uniform(-corridor, corridor, n_boxes)
    radb += np.sign(radb - radius) * 8.0
    cx, cy = radb * np.cos(angb), radb * np.sin(angb)
    sx = rng.uniform(2.0, 8.0, n_boxes)
    sy = rng.uniform(2.0, 8.0, n_boxes)
    sz = rng.uniform(3.0, 12.0, n_boxes)
    box_min = np.stack([cx - sx / 2, cy - sy / 2, np.zeros(n_boxes)], axis=1)
    box_max = np.stack([cx + sx / 2, cy + sy / 2, sz], axis=1)
    return SyntheticWorld(cyl_xy, cyl_r, cyl_h, box_min, box_max)


def loop_trajectory(
    n_frames: int = 600,
    radius: float = 80.0,
    frame_dist: float = 1.2,
    sensor_height: float = 1.8,
) -> np.ndarray:
    """[F,4,4] ground-truth sensor poses driving a circular loop.

    frame_dist ~1.2 m matches KITTI's ~10 Hz at urban speed. A full lap
    is 2*pi*radius/frame_dist frames (~419 at the defaults), so 600
    frames revisit the first ~43% of the loop on the second lap after
    the LRU horizon has evicted it.
    """
    dtheta = frame_dist / radius
    theta = np.arange(n_frames) * dtheta
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    poses[:, 0, 3] = radius * np.cos(theta)
    poses[:, 1, 3] = radius * np.sin(theta)
    poses[:, 2, 3] = sensor_height + 0.15 * np.sin(theta * 5)
    # yaw follows the path tangent
    yaw = theta + np.pi / 2
    c, s = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0], poses[:, 0, 1] = c, -s
    poses[:, 1, 0], poses[:, 1, 1] = s, c
    return poses


def _ray_scene_t(world: SyntheticWorld, origin: np.ndarray, dirs: np.ndarray,
                 max_range: float) -> np.ndarray:
    """Min positive hit distance per ray (origin [3], dirs [M,3]) against
    ground plane, cylinders and boxes; max_range where nothing is hit."""
    M = dirs.shape[0]
    t_best = np.full(M, max_range)

    # ground z=0
    dz = dirs[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_g = -origin[2] / dz
    hit = (dz < -1e-9) & (t_g > 0.05) & (t_g < t_best)
    t_best[hit] = t_g[hit]

    # cylinders: |o_xy + t d_xy - c|^2 = r^2, hit if z within [0, h]
    oc = origin[None, :2] - world.cyl_xy  # [K,2]
    d_xy = dirs[:, :2]  # [M,2]
    a = np.sum(d_xy * d_xy, axis=1)[:, None]  # [M,1]
    b = 2.0 * (d_xy @ oc.T)  # [M,K]
    cterm = (np.sum(oc * oc, axis=1) - world.cyl_r**2)[None, :]  # [1,K]
    disc = b * b - 4 * a * cterm
    with np.errstate(invalid="ignore"):
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_c = (-b - sq) / (2 * np.maximum(a, 1e-12))
    z_at = origin[2] + t_c * dirs[:, 2:3]
    valid = (disc > 0) & (t_c > 0.05) & (z_at >= 0.0) & (z_at <= world.cyl_h[None, :])
    t_c = np.where(valid, t_c, max_range)
    t_best = np.minimum(t_best, t_c.min(axis=1))

    # boxes: slab test
    if len(world.box_min):
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dirs  # [M,3]
        t0 = (world.box_min[None, :, :] - origin[None, None, :]) * inv[:, None, :]
        t1 = (world.box_max[None, :, :] - origin[None, None, :]) * inv[:, None, :]
        tmin = np.minimum(t0, t1).max(axis=2)  # [M,B]
        tmax = np.maximum(t0, t1).min(axis=2)
        valid = (tmax >= tmin) & (tmin > 0.05)
        t_b = np.where(valid, tmin, max_range)
        t_best = np.minimum(t_best, t_b.min(axis=1))

    return t_best


def lidar_scan(
    world: SyntheticWorld,
    pose: np.ndarray,
    rings: int = 32,
    azimuth_steps: int = 512,
    max_range: float = 75.0,
    noise: float = 0.012,
    rng: np.random.Generator | None = None,
    dropout: float = 0.0,
) -> np.ndarray:
    """Simulate one spinning-scanner frame; returns [M,3] points in the
    SENSOR frame (what the sensor delivers and what the odometry engines
    consume). Rays that exit the scene are dropped, like real no-return;
    `dropout` additionally drops each returning ray with that
    probability (rain / dark surfaces)."""
    if rng is None:
        rng = np.random.default_rng(0)
    elev = np.deg2rad(np.linspace(-25.0, 3.0, rings))
    az = np.linspace(0, 2 * np.pi, azimuth_steps, endpoint=False)
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az), np.sin(az)
    # sensor-frame directions [rings*az, 3]
    d_sens = np.stack(
        [
            (ce[:, None] * ca[None, :]).ravel(),
            (ce[:, None] * sa[None, :]).ravel(),
            np.broadcast_to(se[:, None], (rings, azimuth_steps)).ravel(),
        ],
        axis=1,
    )
    R, t = pose[:3, :3], pose[:3, 3]
    d_world = d_sens @ R.T
    t_hit = _ray_scene_t(world, t, d_world, max_range)
    got = t_hit < max_range * 0.999
    if dropout > 0.0:
        got &= rng.uniform(size=t_hit.shape) >= dropout
    t_hit = t_hit + rng.normal(scale=noise, size=t_hit.shape)
    return (d_sens[got] * t_hit[got, None]).astype(np.float32)


def generate_sequence(
    n_frames: int = 600,
    seed: int = 0,
    radius: float = 80.0,
    frame_dist: float = 1.2,
    rings: int = 32,
    azimuth_steps: int = 512,
    noise: float = 0.012,
    progress: bool = False,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Build (scans, ground-truth poses) for a full loop sequence."""
    world = make_world(seed=seed, radius=radius)
    poses = loop_trajectory(n_frames, radius=radius, frame_dist=frame_dist)
    rng = np.random.default_rng(seed + 1)
    scans = []
    for i, T in enumerate(poses):
        scans.append(
            lidar_scan(world, T, rings=rings, azimuth_steps=azimuth_steps,
                       noise=noise, rng=rng)
        )
        if progress and (i + 1) % 100 == 0:
            print(f"  generated {i + 1}/{n_frames} frames", flush=True)
    return scans, poses


# ======================================================================
# On-device scan generation
# ======================================================================


def world_arrays(world: SyntheticWorld):
    """SyntheticWorld → tuple of float32 arrays for the device raycaster."""
    return (
        world.cyl_xy.astype(np.float32),
        world.cyl_r.astype(np.float32),
        world.cyl_h.astype(np.float32),
        world.box_min.astype(np.float32),
        world.box_max.astype(np.float32),
    )


def _cyl_hits(origin, dirs, centers, radii, heights, max_range: float):
    """[M] least positive hit distance of rays against vertical cylinders."""
    oc = origin[None, :2] - centers  # [K,2]
    d_xy = dirs[:, :2]
    a = torch.sum(d_xy * d_xy, dim=1)[:, None]
    b = 2.0 * (d_xy @ oc.T)
    cterm = (torch.sum(oc * oc, dim=1) - radii**2)[None, :]
    disc = b * b - 4 * a * cterm
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_c = (-b - sq) / (2 * torch.clamp(a, min=1e-12))
    z_at = origin[2] + t_c * dirs[:, 2:3]
    valid = (disc > 0) & (t_c > 0.05) & (z_at >= 0.0) & (z_at <= heights[None, :])
    return torch.amin(torch.where(valid, t_c, max_range), dim=1)


def generate_sequence_device(
    n_frames: int = 600,
    seed: int = 0,
    radius: float = 80.0,
    frame_dist: float = 1.2,
    rings: int = 32,
    azimuth_steps: int = 512,
    max_range: float = 75.0,
    noise: float = 0.012,
    pad_frames_to: int | None = None,
    dropout: float = 0.0,
    n_dynamic: int = 0,
    dynamic_speed: float = 0.35,
    *,
    device=None,
):
    """Generate the sequence on ``device`` (default: the card).

    Returns (frames [F,M,4] padded homogeneous float32 on the device, counts
    [F] int32 on the device, ground-truth poses [F,4,4] numpy): the inputs of
    ``JitOdometry.feed_preloaded``. Each frame's returns come first, in ray
    order; rays without a return are padding rows. ``noise`` is the range
    noise's sigma in metres, ``dropout`` each ray's no-return probability,
    and ``n_dynamic`` cylinders drive the loop corridor at
    ±``dynamic_speed``·U(0.6, 1.4) frame-dists a frame (half with the sensor,
    half against it), their returns inconsistent from frame to frame as real
    traffic's are. Noise and dropout draw from a ``torch.Generator`` seeded
    with ``seed + 1`` on the device; the world, the poses and the objects'
    paths are the JAX package's.
    """
    from small_gicp_tpu_torch.point_cloud import pad_row, resolve_device

    dev = resolve_device(device)
    world = make_world(seed=seed, radius=radius)
    cyl_xy, cyl_r, cyl_h, box_min, box_max = (
        torch.from_numpy(a).to(dev) for a in world_arrays(world))
    poses = loop_trajectory(n_frames, radius=radius, frame_dist=frame_dist)
    F = n_frames if pad_frames_to is None else pad_frames_to

    rng_dyn = np.random.default_rng(seed + 7)
    if n_dynamic > 0:
        theta0 = rng_dyn.uniform(0, 2 * np.pi, n_dynamic)
        rel = dynamic_speed * np.where(np.arange(n_dynamic) % 2 == 0, 1.0, -1.0) \
            * rng_dyn.uniform(0.6, 1.4, n_dynamic)
        lat = rng_dyn.uniform(-6.0, 6.0, n_dynamic)
        th = theta0[None, :] + np.arange(n_frames)[:, None] * (frame_dist / radius) \
            * rel[None, :]
        r_dyn = radius + lat[None, :]
        dyn_xy = np.stack([r_dyn * np.cos(th), r_dyn * np.sin(th)],
                          axis=-1).astype(np.float32)  # [F, D, 2]
        dyn_r = rng_dyn.uniform(0.4, 1.1, n_dynamic).astype(np.float32)
        dyn_h = rng_dyn.uniform(1.4, 2.6, n_dynamic).astype(np.float32)
        dyn_xy, dyn_r, dyn_h = (torch.from_numpy(a).to(dev)
                                for a in (dyn_xy, dyn_r, dyn_h))

    elev = np.deg2rad(np.linspace(-25.0, 3.0, rings))
    az = np.linspace(0, 2 * np.pi, azimuth_steps, endpoint=False)
    d_sens = torch.from_numpy(np.stack([
        (np.cos(elev)[:, None] * np.cos(az)[None, :]).ravel(),
        (np.cos(elev)[:, None] * np.sin(az)[None, :]).ravel(),
        np.broadcast_to(np.sin(elev)[:, None], (rings, azimuth_steps)).ravel(),
    ], axis=1).astype(np.float32)).to(dev)
    M = d_sens.shape[0]
    poses_dev = torch.from_numpy(poses.astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    pad = pad_row(torch.float32, dev)

    frames = torch.empty((F, M, 4), dtype=torch.float32, device=dev)
    frames[n_frames:] = pad
    counts = torch.zeros(F, dtype=torch.int32, device=dev)
    ones = torch.ones((M, 1), dtype=torch.float32, device=dev)
    for i in range(n_frames):
        T = poses_dev[i]
        origin, dirs = T[:3, 3], d_sens @ T[:3, :3].T
        dz = dirs[:, 2]
        t_g = -origin[2] / torch.where(torch.abs(dz) > 1e-9, dz, 1e-9)
        t_best = torch.where((dz < -1e-9) & (t_g > 0.05) & (t_g < max_range), t_g,
                             max_range)
        t_best = torch.minimum(t_best, _cyl_hits(origin, dirs, cyl_xy, cyl_r, cyl_h,
                                                 max_range))
        if n_dynamic > 0:
            t_best = torch.minimum(t_best, _cyl_hits(origin, dirs, dyn_xy[i], dyn_r,
                                                     dyn_h, max_range))
        inv = 1.0 / torch.where(torch.abs(dirs) > 1e-9, dirs, 1e-9)
        t0 = (box_min[None, :, :] - origin[None, None, :]) * inv[:, None, :]
        t1 = (box_max[None, :, :] - origin[None, None, :]) * inv[:, None, :]
        tmin = torch.amax(torch.minimum(t0, t1), dim=2)
        tmax = torch.amin(torch.maximum(t0, t1), dim=2)
        valid = (tmax >= tmin) & (tmin > 0.05)
        t_best = torch.minimum(t_best, torch.amin(torch.where(valid, tmin, max_range),
                                                  dim=1))
        got = t_best < max_range * 0.999
        if dropout > 0.0:
            got &= torch.rand(M, generator=gen, device=dev) >= dropout
        t_hit = t_best + noise * torch.randn(M, generator=gen, device=dev)
        frame = torch.where(got[:, None], torch.cat([d_sens * t_hit[:, None], ones], 1),
                            pad)
        order = torch.argsort((~got).to(torch.uint8), stable=True)
        frames[i] = frame[order]
        counts[i] = got.sum()
    return frames, counts, poses
