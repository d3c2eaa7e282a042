"""Voxelgrid downsampling benchmark CLI, a clone of the reference's
downsampling_benchmark (src/benchmark/downsampling_benchmark.cpp) and the
counterpart of ``small_gicp_tpu/apps/downsampling_benchmark.py``, with the
same flags and lines plus ``--device`` (default: the card): the
throughput of ``voxelgrid_sampling`` at several leaf sizes, on a scan
(``.bin`` or ``.ply``, read by the native loader) or on uniform random
points.

    python -m small_gicp_tpu_torch.apps.downsampling_benchmark [input]
        [--num_points N] [--resolutions R ...] [--trials T] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

REPS = 20


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="downsampling_benchmark")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("--num_points", type=int, default=131072)
    p.add_argument("--resolutions", type=float, nargs="+",
                   default=[0.1, 0.25, 0.5, 1.0])
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)

    import torch

    from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
    from small_gicp_tpu_torch.point_cloud import PointCloud, resolve_device

    dev = resolve_device(args.device)
    if args.input:
        from small_gicp_tpu_torch.native import read_kitti_bin, read_ply_xyz

        pts = (read_kitti_bin(args.input) if args.input.endswith(".bin")
               else read_ply_xyz(args.input))
    else:
        rng = np.random.default_rng(0)
        pts = rng.uniform(-80, 80, size=(args.num_points, 3)).astype(np.float32)

    cloud = PointCloud.from_points(pts, device=dev)
    print(f"backend={dev.type} num_points={len(pts)}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for res in args.resolutions:
        n_out = int(voxelgrid_sampling(cloud, res).num_points)
        best = float("inf")
        for _ in range(args.trials):
            sync()
            t0 = time.perf_counter()
            for _ in range(REPS):
                voxelgrid_sampling(cloud, res)
            sync()
            best = min(best, (time.perf_counter() - t0) / REPS)
        print(json.dumps({
            "resolution": res, "points_in": len(pts), "points_out": n_out,
            "msec": round(best * 1e3, 3),
            "points_per_sec": round(len(pts) / best),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
