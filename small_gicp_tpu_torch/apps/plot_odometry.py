#!/usr/bin/env python3
"""Plot odometry trajectories and timing curves.

Counterpart of ``small_gicp_tpu/apps/plot_odometry.py`` and of the
reference's scripts/plot_odometry*.py (host-only; matplotlib is imported
when ``main`` runs): reads
KITTI-format trajectory files (12 floats per line, row-major 3x4 pose —
the format write_trajectory emits and evo consumes) and renders

  * an XY path plot (estimated vs. optional ground truth), and
  * an optional per-frame timing curve (one float per line, msec).

Usage:
  python -m small_gicp_tpu_torch.apps.plot_odometry est.txt \
      [--gt groundtruth.txt] [--times times.txt] [-o odometry.png]
"""

import argparse

import numpy as np

# Categorical slots 1-2 of the validated default viz palette
# (identity: estimated vs ground truth); text/grid stay neutral ink.
_BLUE = "#2a78d6"
_ORANGE = "#eb6834"
_INK = "#3d3d3a"
_GRID = "#d9d8d0"


def load_trajectory(path: str) -> np.ndarray:
    """[F,3] translations from a KITTI pose file."""
    rows = np.loadtxt(path)
    if rows.ndim == 1:
        rows = rows[None, :]
    return rows.reshape(-1, 3, 4)[:, :, 3]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trajectory", help="estimated trajectory (KITTI format)")
    p.add_argument("--gt", help="ground-truth trajectory (KITTI format)")
    p.add_argument("--times", help="per-frame times, one msec value per line")
    p.add_argument("-o", "--output", default="odometry.png")
    args = p.parse_args(argv)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        raise SystemExit("matplotlib is required for plotting")

    est = load_trajectory(args.trajectory)
    gt = load_trajectory(args.gt) if args.gt else None
    times = np.atleast_1d(np.loadtxt(args.times)) if args.times else None

    ncols = 2 if times is not None else 1
    fig, axes = plt.subplots(1, ncols, figsize=(6.4 * ncols, 5.4))
    axes = np.atleast_1d(axes)

    ax = axes[0]
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 1], color=_ORANGE, lw=2, label="ground truth")
    ax.plot(est[:, 0], est[:, 1], color=_BLUE, lw=2, label="estimated")
    ax.set_xlabel("x [m]", color=_INK)
    ax.set_ylabel("y [m]", color=_INK)
    ax.set_title("Trajectory (XY)", color=_INK)
    ax.set_aspect("equal", adjustable="datalim")
    if gt is not None:
        ax.legend(frameon=False, labelcolor=_INK)

    if times is not None:
        ax = axes[1]
        ax.plot(np.arange(len(times)), times, color=_BLUE, lw=2)
        ax.set_xlabel("frame", color=_INK)
        ax.set_ylabel("time [ms]", color=_INK)
        ax.set_title("Per-frame registration time", color=_INK)

    for ax in axes:
        ax.grid(True, color=_GRID, lw=0.6)
        for spine in ("top", "right"):
            ax.spines[spine].set_visible(False)
        ax.tick_params(colors=_INK)

    fig.tight_layout()
    fig.savefig(args.output, dpi=130)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
