#!/usr/bin/env python3
"""VGICP scan-to-model odometry over one lap of a benchmark configuration's
synthetic world, against the generator's true poses, at each voxel search
pattern given: whether the map's one-voxel search keeps track at the lap's
frame motion, or the 7-voxel pattern is needed.

    python3 tools/vgicp_offsets_check.py --config gicp_bench/configs/hdl64_vgicp_model.json \\
        --offsets 1 7 --seed 7 [--frames 419] [--device cuda]

from the root of a checkout. The lap is made on the device as the cell
makes it (``gicp_bench/workload.ScanPool``), from a start frame drawn from
the seed, and run through ``JitOdometry(engine=<the config's>)`` in the
configuration's chunks (or ``--engines``' chunks), with only
``num_offsets`` changed, after a short run that builds the kernels. One
JSON line a pattern: the frame rate over the lap, the most voxels the map held, the
estimated trajectory's gap to the truth (both from the lap's first frame)
at the lap's end and at its worst, and each frame's relative-pose error
against the true motion (mean and largest, degrees and metres; the three
worst frames by id with their errors).
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _gap(A: np.ndarray, B: np.ndarray):
    """(rotation gap in degrees, translation gap in metres) of [F,4,4] pose
    pairs."""
    R = np.einsum("fji,fjk->fik", A[:, :3, :3], B[:, :3, :3])
    c = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(c)), np.linalg.norm(A[:, :3, 3] - B[:, :3, 3], axis=1)


def run(config: dict, num_offsets: int, seed: int, frames: int, device,
        engine: str = None) -> dict:
    import torch

    from gicp_bench import workload as wl
    from small_gicp_tpu_torch.models.odometry import OdometryParams
    from small_gicp_tpu_torch.models.odometry_scan import JitOdometry

    params = dataclasses.replace(OdometryParams(**config["odometry_params"]),
                                 num_offsets=num_offsets)
    C = int(config["chunk_frames"])
    pool = wl.ScanPool(config, frames, seed, device, pad_rows=params.max_scan_points)
    engine = engine or config["engine"]
    odo = JitOdometry(params, engine=engine, chunk_frames=C, device=device)
    est, most = [], 0
    wl.sync(device)
    t0 = time.perf_counter()
    for s in range(0, frames - frames % C, C):
        est.append(odo.feed_preloaded(pool.frames[s:s + C], pool.counts[s:s + C], n_real=C))
        if hasattr(odo.carry[2], "num_voxels"):
            most = max(most, int(odo.carry[2].num_voxels))
    wl.sync(device)
    seconds = time.perf_counter() - t0
    est = np.concatenate(est).astype(np.float64)
    truth = pool.poses[:len(est)]
    truth = np.linalg.inv(truth[0])[None] @ truth
    dr, dt = _gap(est, truth)
    rel_e = np.linalg.inv(est[:-1]) @ est[1:]
    rel_t = np.linalg.inv(truth[:-1]) @ truth[1:]
    rr, rt = _gap(rel_e, rel_t)
    worst = np.argsort(-rt)[:3]
    return {"engine": engine, "num_offsets": num_offsets, "seed": seed, "frames": len(est),
            "frames_per_s": len(est) / seconds, "most_voxels": most,
            "capacity": odo.carry[2].capacity,
            "end_gap_deg": float(dr[-1]), "end_gap_m": float(dt[-1]),
            "worst_gap_deg": float(dr.max()), "worst_gap_m": float(dt.max()),
            "rel_mean_deg": float(rr.mean()), "rel_max_deg": float(rr.max()),
            "rel_mean_m": float(rt.mean()), "rel_max_m": float(rt.max()),
            "worst_frames": [[int(pool.ids[i + 1]), float(rr[i]), float(rt[i])] for i in worst]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--offsets", type=int, nargs="+", default=[1, 7])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--frames", type=int, default=419)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engines", nargs="+", default=[None],
                    help="odometry engines to run (default: the configuration's)")
    args = ap.parse_args(argv)

    import torch

    with open(args.config) as f:
        config = json.load(f)
    dev = torch.device(args.device)
    # One short run first, so that no timed run includes building the kernels.
    run(config, args.offsets[0], args.seed, 2 * int(config["chunk_frames"]), dev)
    for engine in args.engines:
        for k in args.offsets:
            print(json.dumps(run(config, k, args.seed, args.frames, dev, engine)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
