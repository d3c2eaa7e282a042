"""Weak-scaling benchmark of the scale-out modes: one JSON line per mode.

Counterpart of ``small_gicp_tpu/apps/pod_scaling.py``. It brings up the
process group (``multihost.initialize``: torchrun's environment, or the
explicit ``--coordinator``/``--num-processes``/``--process-id``), builds
the mesh over every rank and runs the modes with FIXED WORK PER RANK, so
that the ideal wall time stays flat as ranks are added. Rank 0 prints

    {"mode": "batch", "devices": 8, "processes": 8, "units": 64, "wall_ms": ...,
     "throughput": ..., "per_device": ..., "device": "NVIDIA H100 ...",
     "efficiency": ...}

one line per mode; ``efficiency`` (per-rank throughput over the baseline's)
appears with ``--baseline-json``. Modes:

  * batch — [B] independent registrations split over the ranks
    (``parallel/sharding.align_batch``); one gather;
  * point — ONE registration with the source rows split
    (``align_point_sharded``); 44 float64 sums and K+1 trial errors
    all-reduced an LM iteration;
  * fleet — the problem queue split, one fleet a rank
    (``parallel/fleet.align_fleet_sharded``); one gather.

Usage, one card a rank (NCCL):

    torchrun --nproc-per-node=1 -m small_gicp_tpu_torch.apps.pod_scaling \\
        --save-baseline base.json
    torchrun --nproc-per-node=N -m small_gicp_tpu_torch.apps.pod_scaling \\
        --baseline-json base.json

Without torchrun it runs as a single rank (a one-rank group over a file
store in a temporary directory). ``--device cpu`` runs gloo ranks on the
CPU. The pairs are the JAX app's synthetic surface pairs, made from a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from small_gicp_tpu_torch.parallel import multihost
from small_gicp_tpu_torch.parallel.fleet import align_fleet_sharded
from small_gicp_tpu_torch.parallel.sharding import (
    align_batch,
    align_point_sharded,
    stack_clouds,
)
from small_gicp_tpu_torch.point_cloud import PointCloud, resolve_device
from small_gicp_tpu_torch.utils.lie import se3_exp


def make_pair(n: int, rng, device):
    """A noisy structured cloud of ``n`` points (covariances 0.01·I) and a
    rigidly moved copy, as the JAX app's pair."""
    pts = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    pts[:, 2] = np.sin(pts[:, 0] * 0.3) + 0.05 * rng.normal(size=n)
    covs = (torch.eye(3) * 0.01).expand(n, 3, 3).contiguous().to(device)
    tw = np.r_[rng.normal(size=3) * 0.02, rng.normal(size=3) * 0.1].astype(np.float32)
    T = se3_exp(torch.as_tensor(tw)).numpy()
    src = (np.c_[pts, np.ones(n)] @ T.T)[:, :3].astype(np.float32)
    target = PointCloud.from_points(pts, device=device).replace(covs=covs)
    source = PointCloud.from_points(src, device=device).replace(covs=covs.clone())
    return target, source


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pod_scaling")
    ap.add_argument("--modes", default="batch,point,fleet")
    ap.add_argument("--points", type=int, default=4096,
                    help="source points per rank (point mode) / per pair")
    ap.add_argument("--problems-per-device", type=int, default=8,
                    help="registrations per rank (batch/fleet modes)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--baseline-json", default=None,
                    help="per-rank baseline from --save-baseline")
    ap.add_argument("--save-baseline", default=None)
    ap.add_argument("--coordinator", default=None,
                    help="host:port or an init URL (file:///path); else torchrun's "
                         "environment")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for gloo")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        if args.coordinator is None and "WORLD_SIZE" not in os.environ:
            multihost.initialize(f"file://{tmp}/store", 1, 0, device=dev)
        else:
            multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                                 device=dev)
        try:
            return _run(args, dev)
        finally:
            dist.destroy_process_group()


def _run(args, dev: torch.device) -> int:
    rank, n_proc, _ = multihost.process_info()
    mesh = multihost.global_mesh("data", device=dev)
    n_dev = mesh.size()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rng = np.random.default_rng(0)

    def noise(p):
        tw = np.c_[rng.normal(size=(p, 3)) * 0.02,
                   rng.normal(size=(p, 3)) * 0.1].astype(np.float32)
        return se3_exp(torch.as_tensor(tw)).to(dev)

    baseline = {}
    if args.baseline_json:
        with open(args.baseline_json) as f:
            baseline = json.load(f)

    def barrier():
        """Every rank has drained its work: the slowest closes the clock."""
        flag = torch.ones(1, device=dev)
        dist.all_reduce(flag, group=mesh.get_group(0))
        float(flag)

    def measure(name, units, run):
        run()  # warm-up: kernel builds and first calls
        barrier()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            run()
        barrier()
        wall = (time.perf_counter() - t0) / args.reps
        thr = units / wall
        rec = {"mode": name, "devices": n_dev, "processes": n_proc, "units": units,
               "wall_ms": wall * 1e3, "throughput": thr, "per_device": thr / n_dev,
               "device": kind}
        if name in baseline:
            rec["efficiency"] = rec["per_device"] / baseline[name]
        if rank == 0:
            print(json.dumps(rec), flush=True)
        return rec["per_device"]

    results = {}
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    eye = torch.eye(4, device=dev)
    if "batch" in modes:
        b = args.problems_per_device * n_dev
        pairs = [make_pair(args.points, rng, dev) for _ in range(b)]
        targets = stack_clouds([p[0] for p in pairs])
        sources = stack_clouds([p[1] for p in pairs])
        Ts = noise(b)
        results["batch"] = measure("batch", b, lambda: align_batch(
            targets, sources, Ts, mesh=mesh, registration_type="gicp"))
    if "point" in modes:
        # Weak scaling over the source rows: the source grows with the mesh,
        # the replicated target (searched by every rank) stays as it is.
        n = args.points * n_dev
        target, small = make_pair(args.points, rng, dev)
        source = PointCloud(points=small.points.repeat(n_dev, 1),
                            num_points=torch.tensor(n, dtype=torch.int32, device=dev),
                            covs=small.covs.repeat(n_dev, 1, 1))
        results["point"] = measure("point", n, lambda: align_point_sharded(
            target, source, eye, mesh, registration_type="gicp"))
    if "fleet" in modes:
        p = args.problems_per_device * n_dev
        target, source = make_pair(args.points, rng, dev)
        Ts = noise(p)
        results["fleet"] = measure("fleet", p, lambda: align_fleet_sharded(
            target, source, Ts, mesh,
            num_lanes_per_device=min(8, args.problems_per_device)))

    if args.save_baseline and rank == 0:
        with open(args.save_baseline, "w") as f:
            json.dump(results, f)
        print(f"# baseline saved to {args.save_baseline}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
