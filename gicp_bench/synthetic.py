"""The benchmark's scan generator: a frozen copy of the port's synthetic
world (``utils/synthetic.py``: ``make_world``, ``loop_trajectory``,
``generate_sequence_device``), kept here so that a change to the program
cannot move the inputs the benchmark measures.

An analytic outdoor world (ground plane, pillars, boxes) is raycast by a
spinning multi-ring scanner from exact ground-truth poses on a circular
loop. ``rings=64, azimuth_steps=1800`` gives a frame of about 108k returns,
the size of a KITTI HDL-64E frame. Frames are made on the device in a few
large torch calls a frame, range noise drawn from a ``torch.Generator`` on
that device; a frame's returns come first, in ray order, and rays without a
return are padding rows (sentinel xyz, w = 0).

Only the world's layout uses numpy's generator (a few hundred numbers); it
is the same world for every seed, so that every seed gives the same amount
of work, and the seed moves the noise and where on the loop a run starts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PAD_SENTINEL = 1.0e9


@dataclass
class World:
    """Analytic scene: z=0 ground + vertical cylinders + axis-aligned boxes."""

    cyl_xy: np.ndarray  # [K,2]
    cyl_r: np.ndarray  # [K]
    cyl_h: np.ndarray  # [K]
    box_min: np.ndarray  # [B,3]
    box_max: np.ndarray  # [B,3]


def make_world(seed: int = 0, radius: float = 80.0, corridor: float = 22.0,
               n_cylinders: int = 260, n_boxes: int = 70) -> World:
    """Pillars and buildings in an annulus around the loop path (radius ±
    corridor), with a clear band on the path itself."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n_cylinders)
    rad = radius + rng.uniform(-corridor, corridor, n_cylinders)
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
    return World(cyl_xy, cyl_r, cyl_h, box_min, box_max)


def loop_trajectory(frame_ids, radius: float = 80.0, frame_dist: float = 1.2,
                    sensor_height: float = 1.8) -> np.ndarray:
    """[F,4,4] float64 sensor-to-world poses of the frames ``frame_ids`` on a
    circular loop driven at ``frame_dist`` metres a frame, yaw along the
    path's tangent."""
    theta = np.asarray(frame_ids, dtype=np.float64) * (frame_dist / radius)
    poses = np.tile(np.eye(4), (len(theta), 1, 1))
    poses[:, 0, 3] = radius * np.cos(theta)
    poses[:, 1, 3] = radius * np.sin(theta)
    poses[:, 2, 3] = sensor_height + 0.15 * np.sin(theta * 5)
    yaw = theta + np.pi / 2
    c, s = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0], poses[:, 0, 1] = c, -s
    poses[:, 1, 0], poses[:, 1, 1] = s, c
    return poses


def _cyl_hits(origin, dirs, centers, radii, heights, max_range: float):
    """[M] least positive hit distance of rays against vertical cylinders."""
    oc = origin[None, :2] - centers
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


def generate_frames(poses: np.ndarray, world: World, noise_seed: int, *,
                    rings: int = 64, azimuth_steps: int = 1800,
                    max_range: float = 75.0, noise: float = 0.012,
                    device=None):
    """Scans of ``world`` from each pose of ``poses`` [F,4,4], made on
    ``device``: (frames [F,M,4] float32 padded homogeneous rows in the sensor
    frame, counts [F] int32), both on the device; M = rings·azimuth_steps.
    Range noise of sigma ``noise`` metres draws from a ``torch.Generator``
    on the device seeded with ``noise_seed``."""
    dev = torch.device(device)
    cyl_xy, cyl_r, cyl_h, box_min, box_max = (
        torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)
        for a in (world.cyl_xy, world.cyl_r, world.cyl_h, world.box_min,
                  world.box_max))
    elev = np.deg2rad(np.linspace(-25.0, 3.0, rings))
    az = np.linspace(0, 2 * np.pi, azimuth_steps, endpoint=False)
    d_sens = torch.from_numpy(np.stack([
        (np.cos(elev)[:, None] * np.cos(az)[None, :]).ravel(),
        (np.cos(elev)[:, None] * np.sin(az)[None, :]).ravel(),
        np.broadcast_to(np.sin(elev)[:, None], (rings, azimuth_steps)).ravel(),
    ], axis=1).astype(np.float32)).to(dev)
    M = d_sens.shape[0]
    poses_dev = torch.from_numpy(np.asarray(poses, dtype=np.float32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(noise_seed) % (1 << 63))
    pad = torch.tensor([PAD_SENTINEL, PAD_SENTINEL, PAD_SENTINEL, 0.0],
                       dtype=torch.float32, device=dev)
    F = len(poses)
    frames = torch.empty((F, M, 4), dtype=torch.float32, device=dev)
    counts = torch.zeros(F, dtype=torch.int32, device=dev)
    ones = torch.ones((M, 1), dtype=torch.float32, device=dev)
    for i in range(F):
        T = poses_dev[i]
        origin, dirs = T[:3, 3], d_sens @ T[:3, :3].T
        dz = dirs[:, 2]
        t_g = -origin[2] / torch.where(torch.abs(dz) > 1e-9, dz, 1e-9)
        t_best = torch.where((dz < -1e-9) & (t_g > 0.05) & (t_g < max_range), t_g,
                             max_range)
        t_best = torch.minimum(t_best, _cyl_hits(origin, dirs, cyl_xy, cyl_r, cyl_h,
                                                 max_range))
        inv = 1.0 / torch.where(torch.abs(dirs) > 1e-9, dirs, 1e-9)
        t0 = (box_min[None, :, :] - origin[None, None, :]) * inv[:, None, :]
        t1 = (box_max[None, :, :] - origin[None, None, :]) * inv[:, None, :]
        tmin = torch.amax(torch.minimum(t0, t1), dim=2)
        tmax = torch.amin(torch.maximum(t0, t1), dim=2)
        valid = (tmax >= tmin) & (tmin > 0.05)
        t_best = torch.minimum(t_best, torch.amin(torch.where(valid, tmin, max_range),
                                                  dim=1))
        got = t_best < max_range * 0.999
        t_hit = t_best + noise * torch.randn(M, generator=gen, device=dev)
        frame = torch.where(got[:, None], torch.cat([d_sens * t_hit[:, None], ones], 1),
                            pad)
        order = torch.argsort((~got).to(torch.uint8), stable=True)
        frames[i] = frame[order]
        counts[i] = got.sum()
    return frames, counts


def relative_pose(T_target: np.ndarray, T_source: np.ndarray) -> np.ndarray:
    """T_target_source = T_target⁻¹ · T_source (float64)."""
    return np.linalg.solve(T_target, T_source)
