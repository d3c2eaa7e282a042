"""Dump the synthetic LiDAR world to KITTI-format files on disk.

Counterpart of ``small_gicp_tpu/apps/dump_synthetic_kitti.py``, with its
flags and line, plus ``--device`` (default: the card): the device
generator's frames (``utils/synthetic.generate_sequence_device``) are
written as ``NNNNNN.bin`` float32 x, y, z, intensity scans with a
``gt.txt`` KITTI trajectory (3x4 rows, relative to the first frame) — the
layout the reference's KittiDataset reads (benchmark/benchmark.hpp:
96-144). The file-driven pipeline then runs end to end as the reference
runs KITTI 00:

    python -m small_gicp_tpu_torch.apps.dump_synthetic_kitti /tmp/synth --frames 300
    python -m small_gicp_tpu_torch.apps.odometry_benchmark /tmp/synth /tmp/out.txt \
        --engine small_gicp_model
    python -m small_gicp_tpu_torch.apps.odometry_accuracy /tmp/synth/gt.txt /tmp/out.txt
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dump_synthetic_kitti")
    p.add_argument("out_dir", help="output directory for *.bin + gt.txt")
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--radius", type=float, default=80.0)
    p.add_argument("--frame-dist", type=float, default=1.2)
    p.add_argument("--noise", type=float, default=0.012,
                   help="Gaussian range-noise sigma in meters")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="per-ray no-return probability")
    p.add_argument("--dynamic", type=int, default=0,
                   help="number of moving cylinder objects in the scene")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from small_gicp_tpu_torch.models.odometry import write_trajectory
    from small_gicp_tpu_torch.utils.io import write_kitti_bin
    from small_gicp_tpu_torch.utils.synthetic import generate_sequence_device

    os.makedirs(args.out_dir, exist_ok=True)
    frames_dev, counts, gt = generate_sequence_device(
        n_frames=args.frames, seed=args.seed, radius=args.radius,
        frame_dist=args.frame_dist, noise=args.noise,
        dropout=args.dropout, n_dynamic=args.dynamic, device=args.device,
    )
    frames = frames_dev.cpu().numpy()
    counts = counts.cpu().numpy()
    for i in range(args.frames):
        write_kitti_bin(os.path.join(args.out_dir, f"{i:06d}.bin"),
                        frames[i, :counts[i], :3])
    # Relative to the first frame, as the estimates are (T_world starts at I).
    gt_rel = np.linalg.inv(gt[0])[None] @ gt
    write_trajectory(os.path.join(args.out_dir, "gt.txt"), gt_rel)
    print(f"wrote {args.frames} scans ({counts.sum()} points) + gt.txt to "
          f"{args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
