"""LiDAR odometry benchmark CLI, a clone of the reference's
odometry_benchmark (src/benchmark/odometry_benchmark.cpp:6-94): reads a
directory of KITTI ``.bin`` (or ``.ply``) scans, runs the chosen odometry
engine, writes an evo-compatible KITTI trajectory and prints the same
key=value and registration_time_stats lines.

Counterpart of ``small_gicp_tpu/apps/odometry_benchmark.py``, with the same
flags and lines, plus ``--device`` (default: the card).

    python -m small_gicp_tpu_torch.apps.odometry_benchmark <dataset_path> <output_path>
        [--engine small_gicp|small_gicp_model|...|gicp_model_fused|...]
        [--num_threads N] [--num_neighbors K] [--downsampling_resolution R]
        [--voxel_resolution V] [--max_scans N] [--device cuda|cpu]

The ``small_*`` engines are the streaming engines (``models/odometry.py``,
one scan at a time); the others run ``models/odometry_scan.JitOdometry``
over chunks of 16 frames copied to the device before timing, and print
the steady-state ms a frame (the chunks after the first).
"""

from __future__ import annotations

import argparse
import os
import sys

JIT_ENGINES = (
    "gicp_model", "gicp_model_fused", "vgicp_model", "vgicp_model_fused",
    "plane_icp_model", "plane_icp_model_fused",
    "gicp_scan", "plane_icp_scan", "icp_scan",
)


def build_parser() -> argparse.ArgumentParser:
    from small_gicp_tpu_torch.models.odometry import ENGINES

    p = argparse.ArgumentParser(
        prog="odometry_benchmark",
        description="LiDAR odometry benchmark on the port",
    )
    p.add_argument("dataset_path", help="directory of *.bin (KITTI) or *.ply scans")
    p.add_argument("output_path", help="output trajectory file (KITTI 3x4-row format)")
    p.add_argument("--visualize", action="store_true", help="accepted for parity; no-op")
    p.add_argument("--num_threads", type=int, default=4,
                   help="parity only; the card decides parallelism (default: 4)")
    p.add_argument("--num_neighbors", type=int, default=20,
                   help="covariance-estimation neighbors (default: 20)")
    p.add_argument("--downsampling_resolution", type=float, default=0.25)
    p.add_argument("--voxel_resolution", type=float, default=2.0)
    p.add_argument(
        "--engine", default="small_gicp",
        choices=sorted(ENGINES) + sorted(JIT_ENGINES),
        help="small_* = per-frame streaming engines (reference registry "
             "parity); the others run models/odometry_scan's chunked loop "
             "with the frames copied to the device first",
    )
    p.add_argument("--max_scans", type=int, default=None,
                   help="only process the first N scans")
    p.add_argument("--max_scan_points", type=int, default=131072)
    p.add_argument("--max_downsampled", type=int, default=32768)
    p.add_argument("--max_frame_motion", type=float, default=None,
                   help="motion sanity clamp in meters (off by default): "
                        "reject alignments deviating more than this from "
                        "the constant-velocity prediction and coast on "
                        "the prediction instead")
    p.add_argument("--map_voxel_capacity", type=int, default=None,
                   help="voxel slots of the incremental map (default "
                        "map_capacity // 4)")
    p.add_argument("--model_prepared_rows", type=int, default=None,
                   help="compact the map-side target to this many live "
                        "rows before the fused prepare (_fused engines; "
                        "live rows beyond the budget are dropped). Default off")
    p.add_argument("--map_capacity", type=int, default=131072,
                   help="model-map point capacity (model engines)")
    p.add_argument("--num_offsets", type=int, default=1, choices=(1, 7, 27),
                   help="model-map voxel search pattern (reference "
                        "set_search_offsets default 1; 7 restores the "
                        "full rejector-radius basin at 1 m voxels)")
    p.add_argument("--predict_motion", action="store_true",
                   help="constant-velocity initial guess (not in the reference)")
    p.add_argument("--solve_dtype", default="same", choices=("same", "float64"),
                   help="dtype of the optimizer's 6x6 Newton solves")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def load_scans(dataset_path: str, limit=None, max_points: int = 1 << 21):
    """The scans of a directory, in name order (``*.bin`` KITTI, else
    ``*.ply``), as a prefetching stream of [N,3] float32 arrays: the native
    loader parses scan i+1 on a background thread while scan i registers."""
    from small_gicp_tpu_torch.native import DatasetLoader
    from small_gicp_tpu_torch.utils.io import list_kitti_scans

    paths = list_kitti_scans(dataset_path)
    if not paths:
        paths = sorted(os.path.join(dataset_path, n)
                       for n in os.listdir(dataset_path) if n.endswith(".ply"))
    if not paths:
        raise SystemExit(f"no *.bin or *.ply scans in {dataset_path}")
    if limit is not None:
        paths = paths[:limit]
    return DatasetLoader(paths, max_points=max_points)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from small_gicp_tpu_torch.models.odometry import (
        OdometryParams,
        create_odometry,
        write_trajectory,
    )
    from small_gicp_tpu_torch.point_cloud import resolve_device

    dev = resolve_device(args.device)
    print(f"dataset_path={args.dataset_path}")
    print(f"output_path={args.output_path}")
    print(f"registration_engine={args.engine}")
    print(f"num_threads={args.num_threads}")
    print(f"num_neighbors={args.num_neighbors}")
    print(f"downsampling_resolution={args.downsampling_resolution}")
    print(f"voxel_resolution={args.voxel_resolution}")

    params = OdometryParams(
        num_threads=args.num_threads,
        num_neighbors=args.num_neighbors,
        downsampling_resolution=args.downsampling_resolution,
        voxel_resolution=args.voxel_resolution,
        max_scan_points=args.max_scan_points,
        max_downsampled=args.max_downsampled,
        map_capacity=args.map_capacity,
        map_voxel_capacity=args.map_voxel_capacity,
        max_frame_motion=args.max_frame_motion,
        num_offsets=args.num_offsets,
        predict_motion=args.predict_motion,
        model_prepared_rows=args.model_prepared_rows,
        solve_dtype=args.solve_dtype,
    )
    frames = load_scans(args.dataset_path, args.max_scans)
    if args.engine in JIT_ENGINES:
        from small_gicp_tpu_torch.models.odometry_scan import JitOdometry

        odom = JitOdometry(params, engine=args.engine, chunk_frames=16, device=dev)
        frames = list(frames)
        frames_dev, counts_dev = odom.preload(frames)
        poses = odom.feed_preloaded(frames_dev, counts_dev, n_real=len(frames))
        steady = odom.chunk_times_ms[1:] or odom.chunk_times_ms
        ms = float(np.mean(steady)) / odom.chunk_frames
        print(f"num_frames={len(poses)}")
        print(f"registration_time_stats={ms:.3f} [msec/scan] "
              "(steady-state, frames preloaded to HBM)")
    else:
        odom = create_odometry(args.engine, params, device=dev)
        poses = odom.estimate(frames)
        print(f"num_frames={len(poses)}")
        print(odom.report())

    write_trajectory(args.output_path, poses)
    print(f"saved={args.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
