"""Overhead of the scale-out modes over mesh sizes 1..N, at fixed total work.

Counterpart of ``small_gicp_tpu/apps/scaling_benchmark.py``. For each mesh
size (1, 2, 4, ... up to ``--devices``) it starts that many gloo ranks on
this host (``multihost.run_ranks``), each on the same device: the CPU with
``--device cpu``, or else one card that all ranks share. All ranks compete
for that one device, so with the total work fixed the ideal wall time stays
flat as ranks are added, and every increase is the modes' own overhead:
process-group collectives, the split, the gathers, gloo's copies through
the host. It measures that overhead, not scaling across devices; scaling
needs one card a rank (``apps/pod_scaling.py`` under torchrun over NCCL).

Modes (as the JAX app's): ``batch_dp`` (``--devices`` pairs of
points/devices each through ``align_batch``), ``point_sp`` (one
registration of ``--points`` source rows through ``align_point_sharded``:
two all-reduces an LM iteration) and ``sharded_map`` (VGICP against a
Gaussian map of 512·devices slots through ``sharded_model_align``: three
collectives in each search). ``floor_ms_per_collective`` is one all-reduce
of the point mode's 44 float64 sums, timed alone; at one rank the unsharded
calls are timed beside. Times are the best of ``--reps`` after a warm-up,
each closed by a reduction over the ranks (the slowest rank closes it).

Usage:
    python -m small_gicp_tpu_torch.apps.scaling_benchmark --devices 4 --points 8192
    python -m small_gicp_tpu_torch.apps.scaling_benchmark --device cpu --devices 2

Prints a table and one JSON line ``{"points", "device", "ms_by_devices"}``.
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

from small_gicp_tpu_torch.apps.pod_scaling import make_pair
from small_gicp_tpu_torch.models.registration import align_impl
from small_gicp_tpu_torch.models.voxelmap import GaussianVoxelMap
from small_gicp_tpu_torch.parallel import multihost
from small_gicp_tpu_torch.parallel.map_sharding import sharded_model_align
from small_gicp_tpu_torch.parallel.sharding import (
    align_batch,
    align_point_sharded,
    stack_clouds,
)
from small_gicp_tpu_torch.point_cloud import resolve_device

MODES = ("batch_dp", "point_sp", "sharded_map")
FLOOR_REPS = 64
MESH_TIMEOUT_S = 600.0  # the ranks of one mesh size, in all


def _rank(args) -> None:
    """One rank of one mesh size: times every mode, rank 0 prints them."""
    dev = resolve_device(args.device)
    multihost.initialize(f"file://{args.store}", args.world, args.rank,
                         [0] if dev.type == "cuda" else None, device=dev, backend="gloo")
    try:
        mesh = multihost.global_mesh("data", device=dev)
        group = mesh.get_group(0)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0)
        rng = np.random.default_rng(0)
        b = args.devices
        pairs = [make_pair(args.points // b, rng, dev) for _ in range(b)]
        targets = stack_clouds([p[0] for p in pairs])
        sources = stack_clouds([p[1] for p in pairs])
        inits = torch.eye(4, device=dev).expand(b, 4, 4)
        target, source = make_pair(args.points, rng, dev)
        vm = GaussianVoxelMap.build(target, 1.0, capacity=512 * args.devices)
        eye = torch.eye(4, device=dev)
        sums = torch.zeros(44, dtype=torch.float64, device=dev)

        def closed():
            flag = torch.ones(1, device=dev)
            dist.all_reduce(flag, group=group)
            float(flag)

        def best_ms(fn, reps=args.reps):
            fn()
            closed()
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                closed()
                best = min(best, time.perf_counter() - t0)
            return best * 1e3

        def floor():
            for _ in range(FLOOR_REPS):
                dist.all_reduce(sums, group=group)

        out = {
            "floor_ms_per_collective": best_ms(floor) / FLOOR_REPS,
            "batch_dp": best_ms(lambda: align_batch(targets, sources, inits, mesh=mesh,
                                                    registration_type="gicp")),
            "point_sp": best_ms(lambda: align_point_sharded(target, source, eye, mesh,
                                                            registration_type="gicp")),
            "sharded_map": best_ms(lambda: sharded_model_align(vm, source, eye, mesh)),
        }
        if args.world == 1:
            out["unsharded"] = {
                "batch_dp": best_ms(lambda: [align_impl(
                    pairs[i][0], pairs[i][1], None, eye, registration_type="gicp")
                    for i in range(b)]),
                "point_sp": best_ms(lambda: align_impl(
                    target, source, None, eye, registration_type="gicp", use_fused="never")),
                "sharded_map": best_ms(lambda: align_impl(
                    vm, source, None, eye, registration_type="gicp")),
            }
        if args.rank == 0:
            print("RESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scaling_benchmark")
    ap.add_argument("--devices", type=int, default=8, help="largest mesh size")
    ap.add_argument("--points", type=int, default=8192,
                    help="total source points (fixed across mesh sizes)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args)
        return 0

    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    meshes = [1]
    while meshes[-1] * 2 <= args.devices:
        meshes.append(meshes[-1] * 2)
    if args.devices != meshes[-1] or args.points % args.devices:
        raise ValueError("--devices must be a power of two and --points a multiple of it")
    by = {}
    for nd in meshes:
        with tempfile.TemporaryDirectory() as tmp:
            runs = multihost.run_ranks(lambda r: [
                sys.executable, "-m", "small_gicp_tpu_torch.apps.scaling_benchmark",
                "--devices", str(args.devices), "--points", str(args.points),
                "--reps", str(args.reps), "--device", dev.type, "--rank", str(r),
                "--world", str(nd), "--store", os.path.join(tmp, "store")], nd,
                timeout=MESH_TIMEOUT_S)
        for r, (rc, log) in enumerate(runs):
            if rc:
                print(f"mesh size {nd}, rank {r} exited {rc}:\n{log[-4000:]}",
                      file=sys.stderr)
                return 1
        by[nd] = json.loads(next(line for line in runs[0][1].splitlines()
                                 if line.startswith("RESULT "))[len("RESULT "):])

    results = {mode: {nd: by[nd][mode] for nd in meshes}
               for mode in ("floor_ms_per_collective",) + MODES}
    results["unsharded"] = by[1]["unsharded"]
    print(f"fixed total work: {args.points} source points; gloo ranks sharing {kind}; "
          f"mesh sizes {meshes}")
    print(f"{'mode':26s} " + " ".join(f"{nd:>9d}rk" for nd in meshes)
          + "  unsharded   overhead@max")
    for mode in MODES:
        curve = results[mode]
        row = " ".join(f"{curve[nd]:>11.3f}" for nd in meshes)
        print(f"{mode:26s} {row} {results['unsharded'][mode]:>10.3f}   "
              f"{curve[meshes[-1]] / curve[1]:.2f}x")
    print("floor ms per collective    " + " ".join(
        f"{results['floor_ms_per_collective'][nd]:>11.4f}" for nd in meshes))
    print(json.dumps({"points": args.points, "device": kind, "ms_by_devices": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
