#!/usr/bin/env python3
"""Time K3 and K1 on one card over their tuning constants, beside their
first forms, at the scan pair's shapes of ``chip_smoke.py`` phases 4-5.

    python3 tools/scan_walk_sweep.py [NAME=VALUE,... ...] [--per-sm 16 32 64]

Each variant (default: one with the compiled constants) is a copy of the
package under ``build/scan_walk_sweep/`` with the named ``constexpr int``
constants of ``csrc/`` set so (``tools/box_walk_sweep.py``'s
``make_variant``) — for example K3's ``kTeam`` (threads a query, in
``csrc/cov_fused.cu``; it also sets ``cov_fused_cuda.MOMENTS_TEAM``):
``kTeam=2 kTeam=8``; each copy runs in its own process and builds its own
libraries. Within it, on the synthetic HDL-64-like pair (frames 0
and 1 of ``generate_sequence(rings=64, azimuth_steps=1800)``, 0.25 m voxels,
≈21k points): K3 on the target cloud (k = 10 and 20) takes turns with its
first form (CUDA events around one call, median of 20: ``ms``, ``v1_ms``)
and each is timed alone by torch.profiler over 20 calls (``alone_ms``,
``v1_alone_ms``); then, for each ``SWEPT_BLOCKS_PER_SM`` of ``--per-sm``
(the chunk plan K1 shares with K6), K1 (GICP at a noisy pose) the same way
against its first form, with the source in Morton order and in its row
order (``order``) and
with a rejector radius of 1 m and of inf (``radius``). Every result is
checked against the first form (K3: equal; K1: equal masks, inliers and
winners). The two frames are generated once into
``build/scan_walk_sweep/frames.npz``. One JSON line per timing goes to
standard output and to ``chiprun_out/scan_walk_sweep.jsonl``.
"""

import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from box_walk_sweep import make_variant  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "build" / "scan_walk_sweep"

RUN = r"""
import json, re, subprocess, sys
import numpy as np, torch
from small_gicp_tpu_torch import _build
_build.SIGNATURES = {n: _build.SIGNATURES[n]
                     for n in ("cov_fused", "gicp_listed", "gicp_fused")}
from small_gicp_tpu_torch.ops import gicp_fused_cuda as gf
from small_gicp_tpu_torch.ops.cov_fused_cuda import (
    MOMENTS_TEAM, _knn_moments_rows_v1, knn_moments_rows)
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.morton_boxes import pruned_prepare_target
from small_gicp_tpu_torch.ops.normals import estimate_normals_covariances
from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.utils.lie import se3_exp

variant, frames, out = sys.argv[1], sys.argv[3], sys.argv[4]
per_sm_list = [int(x) for x in sys.argv[2].split(",")]
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True,
                      check=True).stdout.strip().splitlines()[0]
dev = torch.device("cuda")
data = np.load(frames)
scans = [data["scan0"], data["scan1"]]
poses = data["poses"]


def turns(fns, reps=20):
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, f in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(); f(); b.record(); b.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in times.items()}


def alone(fn, pattern, reps=20):
    # ms per call of the device kernels whose name matches ``pattern``,
    # profiled after a warm-up step; None if the profiler lost a kernel
    # three times.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and re.search(pattern, e.key)]
        if sum(e.count for e in ours) == reps:
            return sum(e.self_device_time_total for e in ours) / 1e3 / reps
    return None


def emit(**rec):
    rec.update(variant=variant, card=card)
    line = json.dumps(rec)
    print(line, flush=True)
    with open(out, "a") as f:
        f.write(line + "\n")


tgt, src = (voxelgrid_sampling(PointCloud.from_points(s, device=dev), 0.25)
            for s in scans)
m, n = int(tgt.num_points), int(src.num_points)
target = pruned_prepare_target(tgt.points, tgt.num_points)
for k in (10, 20):
    new = lambda: knn_moments_rows(tgt.points, tgt.num_points, k, target=target)
    old = lambda: _knn_moments_rows_v1(tgt.points, tgt.num_points, k)
    same = torch.equal(new(), old())
    ms = turns({"new": new, "v1": old})
    emit(kernel="K3", rows=m, k=k, team=MOMENTS_TEAM, ms=ms["new"], v1_ms=ms["v1"],
         alone_ms=alone(new, r"knn_moments_kernel(?!_v1)"),
         v1_alone_ms=alone(old, "knn_moments_kernel_v1"), equal=same)
    if not same:
        sys.exit(f"{variant} K3 k={k}: differs from its first form")

tgt = estimate_normals_covariances(tgt, num_neighbors=10)
src = estimate_normals_covariances(src, num_neighbors=10)
noise = se3_exp(torch.tensor([0.02, -0.01, 0.015, 0.15, -0.1, 0.05],
                             dtype=torch.float64)).numpy()
T = torch.as_tensor(np.linalg.inv(poses[0]) @ poses[1] @ noise, dtype=torch.float32,
                    device=dev)
tables = gf.gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                         "gicp", tgt.covs, src.covs)
rows = gf.gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                       "gicp", tgt.covs, src.covs)
rows.sperm = torch.arange(src.capacity, dtype=torch.int32, device=dev)
for radius in (1.0, float("inf")):
    ref = gf._gicp_linearize_v1(tables, T, radius)
    mask = ref[3][:, 12] > 0.5
    for per_sm in per_sm_list:
        gf.SWEPT_BLOCKS_PER_SM = per_sm
        for order, tab in (("morton", tables), ("rows", rows)):
            new = lambda: gf.gicp_linearize_tables(tab, T, radius)
            old = lambda: gf._gicp_linearize_v1(tab, T, radius)
            got = new()
            same = (torch.equal(got[3][:, 12] > 0.5, mask) and int(got[2]) == int(ref[2])
                    and torch.equal(got[3][mask][:, [0, 1, 2, 13]],
                                    ref[3][mask][:, [0, 1, 2, 13]]))
            h_rel = ((got[0] - ref[0]).abs().max() / ref[0].abs().max()).item()
            ms = turns({"new": new, "v1": old})
            emit(kernel="K1", rows=m, q=n, radius=radius, per_sm=per_sm, order=order,
                 chunks=gf.swept_plan(tab), ms=ms["new"], v1_ms=ms["v1"],
                 alone_ms=alone(new, "gicp_linearize_listed_kernel"),
                 v1_alone_ms=alone(old, "gicp_linearize_kernel<"), equal=same,
                 h_rel=h_rel)
            if not same:
                sys.exit(f"{variant} K1 {order} per_sm={per_sm} radius={radius}: "
                         "differs from its first form")
"""


def frames_file() -> Path:
    """Frames 0 and 1 of chip_smoke.py's sequence, generated once."""
    path = WORK / "frames.npz"
    if not path.exists():
        sys.path.insert(0, str(ROOT))
        import numpy as np

        from small_gicp_tpu_torch.utils.synthetic import generate_sequence

        scans, poses = generate_sequence(n_frames=2, rings=64, azimuth_steps=1800)
        WORK.mkdir(parents=True, exist_ok=True)
        np.savez(path, poses=np.stack(poses), scan0=scans[0], scan1=scans[1])
    return path


def main() -> None:
    args = sys.argv[1:]
    per_sm = "32"
    if "--per-sm" in args:
        at = args.index("--per-sm")
        end = next((i for i in range(at + 1, len(args)) if args[i].startswith("--")),
                   len(args))
        per_sm = ",".join(args[at + 1:end])
        args = args[:at] + args[end:]
    variants = args or [""]
    out = ROOT / "chiprun_out" / "scan_walk_sweep.jsonl"
    out.parent.mkdir(exist_ok=True)
    frames = frames_file()
    failed = []
    for v in variants:
        root = make_variant(v, WORK)
        env = dict(os.environ, PYTHONPATH=str(root))
        rc = subprocess.run([sys.executable, "-c", RUN, v, per_sm, str(frames), str(out)],
                            cwd=root, env=env).returncode
        if rc != 0:
            failed.append(v)
    if failed:
        raise SystemExit(f"variants that failed: {failed}")


if __name__ == "__main__":
    main()
