"""Neighbour-search benchmark CLI: loads one scan (or generates one) and
measures batched exact kNN query throughput of ``KdTree`` across
point-count scales, at the ks the registration pipeline uses (1 for
correspondences, 10-20 for covariances).

Counterpart of ``small_gicp_tpu/apps/kdtree_benchmark.py``, with the same
arguments and JSON lines. "Building" the searcher is free (the cloud is
the structure), so the numbers are query times.

    python -m small_gicp_tpu_torch.apps.kdtree_benchmark [scan.bin|scan.ply]
        [--num_points N] [--ks 1 10 20] [--sizes 4096 ...] [--trials 3]
        [--device cuda|cpu]

On the card each trial times 20 back-to-back searches with CUDA events;
on the CPU it times them with the host clock. The best trial is printed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.point_cloud import PointCloud, resolve_device
from small_gicp_tpu_torch.utils.io import read_kitti_bin, read_ply

REPS = 20


def _search(tree: KdTree, q: torch.Tensor, k: int):
    if k == 1:
        return tree.nearest_neighbor_search(q)
    return tree.knn_search(q, k)


def _seconds_per_search(tree: KdTree, q: torch.Tensor, k: int, reps: int) -> float:
    """Mean seconds of one search over ``reps`` back-to-back searches."""
    if q.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            _search(tree, q, k)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        _search(tree, q, k)
    return (time.perf_counter() - t0) / reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kdtree_benchmark")
    p.add_argument("input", nargs="?", default=None,
                   help="scan file (.ply/.bin); synthetic cloud if omitted")
    p.add_argument("--num_points", type=int, default=65536)
    p.add_argument("--ks", type=int, nargs="+", default=[1, 10, 20])
    p.add_argument("--sizes", type=int, nargs="+",
                   default=[4096, 8192, 16384, 32768])
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.input:
        pts = (read_kitti_bin(args.input) if args.input.endswith(".bin")
               else read_ply(args.input))
    else:
        rng = np.random.default_rng(0)
        pts = rng.uniform(-80, 80, size=(args.num_points, 3)).astype(np.float32)

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backend={dev.type} device={name} num_points={len(pts)}")
    for n in args.sizes:
        sub = pts[np.random.default_rng(1).choice(len(pts), min(n, len(pts)),
                                                  replace=False)]
        cloud = PointCloud.from_points(sub, capacity=n, device=dev)
        tree = KdTree.build(cloud)
        q = torch.as_tensor(sub, dtype=torch.float32, device=dev)
        for k in args.ks:
            _search(tree, q, k)  # first use builds and loads the kernels
            best = min(_seconds_per_search(tree, q, k, REPS)
                       for _ in range(args.trials))
            print(json.dumps({
                "n": n, "k": k, "msec": round(best * 1e3, 3),
                "queries_per_sec": round(len(sub) / best),
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
