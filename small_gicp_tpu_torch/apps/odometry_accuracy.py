"""Odometry accuracy CLI, the counterpart of the reference's
scripts/plot_odometry_accuracy.py (evo_ape / evo_rpe over trajectory
files) and of ``small_gicp_tpu/apps/odometry_accuracy.py``, with the same
flags and lines: APE (Umeyama-aligned) and RPE(delta) of one or more
estimated KITTI-format trajectories against a ground-truth file, as a table.
Host-only (numpy).

    python -m small_gicp_tpu_torch.apps.odometry_accuracy gt.txt est.txt [...]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="odometry_accuracy")
    p.add_argument("ground_truth", help="ground-truth KITTI trajectory file")
    p.add_argument("estimates", nargs="+", help="estimated trajectory files")
    p.add_argument("--rpe_delta", type=int, default=100)
    args = p.parse_args(argv)

    from small_gicp_tpu_torch.utils.metrics import (
        ape_translation,
        load_kitti_trajectory,
        rpe_translation,
    )

    gt = load_kitti_trajectory(args.ground_truth)
    print(f"{'trajectory':30s} {'APE [m]':>18s} {'RPE(%d) [m]' % args.rpe_delta:>18s}")
    for path in args.estimates:
        est = load_kitti_trajectory(path)
        n = min(len(est), len(gt))
        ape_m, ape_s = ape_translation(est[:n], gt[:n])
        rpe_m, rpe_s = rpe_translation(est[:n], gt[:n], delta=args.rpe_delta)
        name = os.path.basename(path)
        print(f"{name:30s} {ape_m:8.3f} +- {ape_s:6.3f} {rpe_m:8.3f} +- {rpe_s:6.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
