"""Trajectory-scale odometry benchmark on a synthetic LiDAR loop.

Counterpart of ``small_gicp_tpu/apps/synthetic_odometry_benchmark.py``,
with its flags and output lines, plus ``--device`` (default: the card). The
reference's accuracy claim is a KITTI-00 trajectory score (evo APE/RPE,
scripts/plot_odometry_accuracy.py); this app reproduces the experiment's
shape on the synthetic world (utils/synthetic.py): several hundred frames
generated on the device, a closed loop with revisits past the LRU horizon,
exact ground truth. It reports APE mean±std, RPE(delta) and the
steady-state ms a scan of each ``JitOdometry`` engine.

    python -m small_gicp_tpu_torch.apps.synthetic_odometry_benchmark \
        --frames 600 --engines gicp_model,vgicp_model,gicp_scan
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run_engine(engine, frames_dev, counts_dev, n_frames, params, chunk_frames=16,
               covariance_mode="knn", *, device=None):
    from small_gicp_tpu_torch.models.odometry_scan import JitOdometry

    odo = JitOdometry(params, engine=engine, chunk_frames=chunk_frames,
                      covariance_mode=covariance_mode, device=device)
    poses = odo.feed_preloaded(frames_dev, counts_dev, n_real=n_frames)
    # Steady-state ms/scan: the first chunk's wall time includes building
    # the kernels, so report the mean over the remaining chunks.
    steady = odo.chunk_times_ms[1:] or odo.chunk_times_ms
    ms_per_scan = float(np.mean(steady)) / chunk_frames
    return poses, ms_per_scan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--radius", type=float, default=80.0)
    ap.add_argument("--frame-dist", type=float, default=1.2)
    ap.add_argument(
        "--engines", default="gicp_model,vgicp_model,gicp_scan",
        help="comma list of JitOdometry engines (also: vgicp_model_fused, "
             "plane_icp_scan, icp_scan)",
    )
    ap.add_argument("--rpe-delta", type=int, default=100)
    ap.add_argument("--downsample", type=float, default=0.25)
    ap.add_argument("--max-downsampled", type=int, default=16384)
    ap.add_argument("--map-capacity", type=int, default=262144)
    ap.add_argument("--chunk-frames", type=int, default=16)
    ap.add_argument("--lru-horizon", type=int, default=100,
                    help="map LRU horizon in frames (reference set_lru "
                         "default 100); set >= frames to retain the whole "
                         "map (implicit loop closure on revisits)")
    ap.add_argument("--cov-mode", default="knn",
                    choices=("knn", "knn_window", "voxel"),
                    help="per-frame covariance estimator for model engines "
                         "(knn = exact reference semantics; knn_window = "
                         "Morton-banded approximate self-kNN, O(N*S*W))")
    ap.add_argument("--offsets", type=int, default=7,
                    help="model-map voxel search pattern (1/7/27); the "
                         "reference default 1 is narrower than typical "
                         "frame motion at 1 m voxels — see OdometryParams")
    ap.add_argument("--predict-motion", action="store_true",
                    help="constant-velocity initial guess (engines default "
                         "to the reference's raw-previous-pose seeding)")
    ap.add_argument("--save-prefix", default=None,
                    help="write <prefix>_<engine>.txt + <prefix>_gt.txt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    from small_gicp_tpu_torch.models.odometry import OdometryParams, write_trajectory
    from small_gicp_tpu_torch.point_cloud import resolve_device
    from small_gicp_tpu_torch.utils.metrics import ape_translation, rpe_translation
    from small_gicp_tpu_torch.utils.synthetic import generate_sequence_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    n_pad = (
        (args.frames + args.chunk_frames - 1) // args.chunk_frames
        * args.chunk_frames
    )
    frames_dev, counts_dev, gt = generate_sequence_device(
        n_frames=args.frames, seed=args.seed, radius=args.radius,
        frame_dist=args.frame_dist, pad_frames_to=n_pad, device=dev,
    )
    counts_dev.cpu()  # waits for the generator
    print(f"generated {args.frames} frames on device in "
          f"{time.perf_counter() - t0:.1f}s "
          f"({frames_dev.shape[1]} rays/frame)", flush=True)
    gt_rel = np.linalg.inv(gt[0])[None] @ gt
    if args.save_prefix:
        write_trajectory(f"{args.save_prefix}_gt.txt", gt_rel)

    results = {}
    for engine in args.engines.split(","):
        engine = engine.strip()
        params = OdometryParams(
            max_scan_points=int(frames_dev.shape[1]),
            max_downsampled=args.max_downsampled,
            map_capacity=(args.map_capacity if "_model" in engine
                          else args.max_downsampled),
            downsampling_resolution=args.downsample,
            predict_motion=args.predict_motion,
            num_offsets=args.offsets,
            lru_horizon=args.lru_horizon,
        )
        # vgicp map capacity counts voxels, not points
        if engine.startswith("vgicp_model"):
            params.map_capacity = max(args.map_capacity // 4, 65536)
        poses, ms = run_engine(
            engine, frames_dev, counts_dev, args.frames, params,
            chunk_frames=args.chunk_frames, covariance_mode=args.cov_mode,
            device=dev,
        )
        ape = ape_translation(poses, gt_rel)
        rpe = rpe_translation(poses, gt_rel, delta=args.rpe_delta)
        results[engine] = dict(
            ape_mean=round(ape[0], 4), ape_std=round(ape[1], 4),
            rpe_mean=round(rpe[0], 4), rpe_std=round(rpe[1], 4),
            ms_per_scan=round(ms, 2),
        )
        print(f"{engine}: APE {ape[0]:.3f}±{ape[1]:.3f} m, "
              f"RPE({args.rpe_delta}) {rpe[0]:.3f}±{rpe[1]:.3f} m, "
              f"{ms:.1f} ms/scan (steady-state)", flush=True)
        if args.save_prefix:
            write_trajectory(f"{args.save_prefix}_{engine}.txt", poses)

    print(json.dumps({"frames": args.frames, "results": results}))
    return results


if __name__ == "__main__":
    main()
