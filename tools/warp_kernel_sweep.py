#!/usr/bin/env python3
"""Time K11 and K5 on one card over their tuning constants, beside their
first forms, at the shapes of ``chip_smoke.py`` phases 7 and 8.

    python3 tools/warp_kernel_sweep.py [NAME=VALUE,... ...] [--per-sm 2 4 8]

Each variant (default: one with the compiled constants) is a copy of the
package under ``build/warp_kernel_sweep/`` with the named ``constexpr int``
constants of ``csrc/`` set so (``tools/box_walk_sweep.py``'s
``make_variant``, which also sets the Python constants that repeat them) —
K11's ``kWarpQueries`` (queries a warp holds up to k = 16),
``kWarpMaxWarps`` (warps a block at most), ``kWarpListBytes`` (bytes of
lane lists a block at most), ``kWarpStage`` (rows a ring stage),
``kWarpSampleStep`` (its bound's sample step) and ``kScanBatch`` (rows a
lane loads before their distances) in
``csrc/knn.cu``, K5's ``kWarpTeam`` (lanes a query) and ``kWarpBatch`` in
``csrc/cov_fused.cu`` — for example ``kWarpQueries=8 kWarpTeam=16``; each
copy runs in its own process, builds its own knn and cov_fused libraries
and prints ptxas's report on the two kernels. Within it, on frame 0 of the synthetic HDL-64-like sequence
(``generate_sequence(rings=64, azimuth_steps=1800)``; downsampled at
0.25 m, ≈21k rows, and raw, ≈108k rows), for each ``WARP_BLOCKS_PER_SM``
of ``--per-sm`` (K11's chunk plan): K11 on the downsampled cloud's first Q
rows as queries (Q = 1, 64, 4,096 and all; k = 10, and k = 20 at all) and
on the raw cloud against itself (k = 20) takes turns with its first form
and K10 (CUDA events around one call, median of 20, 3 on the raw cloud:
``ms``, ``v1_ms``, ``knn_ms``), and each is timed alone by torch.profiler
over 20 calls (``alone_ms``, ``v1_alone_ms``, ``knn_alone_ms``); then K5
over the cloud's kept sort (k = 10 and 20 downsampled, k = 10 raw) the
same way against its first form and K3. Every result is checked equal to
the first form's (and K5's to K3's). Frame 0 is generated once into
``build/warp_kernel_sweep/frames.npz``. One JSON line per timing goes to
standard output and to ``chiprun_out/warp_kernel_sweep.jsonl``.
"""

import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from box_walk_sweep import make_variant  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "build" / "warp_kernel_sweep"

RUN = r"""
import json, re, subprocess, sys
import numpy as np, torch
from small_gicp_tpu_torch import _build
_build.SIGNATURES = {n: _build.SIGNATURES[n] for n in ("knn", "cov_fused")}
from small_gicp_tpu_torch.ops import cov_fused_cuda as cf
from small_gicp_tpu_torch.ops import knn_cuda as kc
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.morton_boxes import pruned_prepare_target
from small_gicp_tpu_torch.point_cloud import PointCloud

variant, frames, out = sys.argv[1], sys.argv[3], sys.argv[4]
per_sm_list = [int(x) for x in sys.argv[2].split(",")]
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True,
                      check=True).stdout.strip().splitlines()[0]
dev = torch.device("cuda")
scan = np.load(frames)["scan0"]
_build.build_all()
for name in ("knn", "cov_fused"):
    # ptxas's report on the two kernels (registers, stack, shared memory).
    lines = _build.build_log(name).splitlines()
    for at, line in enumerate(lines):
        if "Compiling entry" in line and re.search("warp_split_kernel|warp_walk_kernel", line):
            kernel = re.search(r"(knn_[a-z_]+_kernel)ILi(\d+)E", line)
            for info in lines[at + 1:at + 4]:
                if "registers" in info or "stack frame" in info:
                    print(f"[{variant}] [{kernel.group(1)}<{kernel.group(2)}>] "
                          f"{info.strip()}")


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


down = voxelgrid_sampling(PointCloud.from_points(scan, device=dev), 0.25)
raw = PointCloud.from_points(scan, device=dev)
clouds = {"scan": (down.points, down.num_points), "raw": (raw.points, raw.num_points)}
failed = []
m = int(down.num_points)
cases = [("scan", 1, 10), ("scan", 64, 10), ("scan", 4096, 10), ("scan", m, 10),
         ("scan", m, 20), ("raw", int(raw.num_points), 20)]
sms = torch.cuda.get_device_properties(dev).multi_processor_count
for per_sm in per_sm_list:
    kc.WARP_BLOCKS_PER_SM = per_sm
    for cloud, nq, k in cases:
        pts, num = clouds[cloud]
        q = pts[:nq, :3]
        new = lambda: kc.knn_T(pts, num, q, k)
        old = lambda: kc._knn_T_v1(pts, num, q, k)
        k10 = lambda: kc.knn(pts, num, q, k)
        a, b = new(), old()
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        reps = 3 if cloud == "raw" else 20
        ms = turns({"new": new, "v1": old, "knn": k10}, reps)
        emit(kernel="K11", cloud=cloud, q=nq, rows=int(num), k=k, per_sm=per_sm,
             chunks=kc.warp_plan(nq, pts.shape[0], k, sms),
             block_queries=kc.warp_block_queries(k), ms=ms["new"], v1_ms=ms["v1"],
             knn_ms=ms["knn"], alone_ms=alone(new, "knn_warp_split_kernel"),
             v1_alone_ms=alone(old, "knn_warp_kernel_v1"),
             knn_alone_ms=alone(k10, "knn_split_kernel"), equal=same)
        if not same:
            failed.append(("K11", cloud, nq, k, per_sm))
for cloud, k in (("scan", 10), ("scan", 20), ("raw", 10)):
    pts, num = clouds[cloud]
    target = pruned_prepare_target(pts, num)
    new = lambda: cf.knn_moments_rows_q(pts, num, k, target=target)
    old = lambda: cf._knn_moments_rows_q_v1(pts, num, k)
    k3 = lambda: cf.knn_moments_rows(pts, num, k, target=target)
    got = new()
    same = torch.equal(got, old()) and torch.equal(got, k3())
    reps = 3 if cloud == "raw" else 20
    ms = turns({"new": new, "v1": old, "k3": k3}, reps)
    emit(kernel="K5", cloud=cloud, rows=int(num), k=k, team=cf.MOMENTS_Q_TEAM,
         ms=ms["new"], v1_ms=ms["v1"], k3_ms=ms["k3"],
         alone_ms=alone(new, "knn_moments_warp_walk_kernel"),
         v1_alone_ms=alone(old, "knn_moments_warp_kernel_v1"),
         k3_alone_ms=alone(k3, r"knn_moments_kernel(?!_v1)"), equal=same)
    if not same:
        failed.append(("K5", cloud, k))
if failed:
    sys.exit(f"{variant}: differs from the first forms at {failed}")
"""


def frames_file() -> Path:
    """Frame 0 of chip_smoke.py's sequence, generated once."""
    path = WORK / "frames.npz"
    if not path.exists():
        sys.path.insert(0, str(ROOT))
        import numpy as np

        from small_gicp_tpu_torch.utils.synthetic import generate_sequence

        scans, _ = generate_sequence(n_frames=1, rings=64, azimuth_steps=1800)
        WORK.mkdir(parents=True, exist_ok=True)
        np.savez(path, scan0=scans[0])
    return path


def main() -> None:
    args = sys.argv[1:]
    per_sm = "4"
    if "--per-sm" in args:
        at = args.index("--per-sm")
        end = next((i for i in range(at + 1, len(args)) if args[i].startswith("--")),
                   len(args))
        per_sm = ",".join(args[at + 1:end])
        args = args[:at] + args[end:]
    variants = args or [""]
    out = ROOT / "chiprun_out" / "warp_kernel_sweep.jsonl"
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
