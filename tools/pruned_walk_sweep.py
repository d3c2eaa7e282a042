#!/usr/bin/env python3
"""Time K12 on one card over its teams and tuning constants, beside its first
form, at the shapes of ``chip_smoke.py`` phase 7.

    python3 tools/pruned_walk_sweep.py [NAME=VALUE,... ...] [--teams 2 4 8]

Each variant (default: one with the compiled constants) is a copy of the
package under ``build/pruned_walk_sweep/`` with the named ``constexpr int``
constants of ``csrc/`` set so (``tools/box_walk_sweep.py``'s
``make_variant``, which also sets the Python constants that repeat them) —
for example ``kCullPass=128`` (boxes a cull pass tests, in
``csrc/common.cuh``); each copy runs in its own process, builds its own knn
library and prints ptxas's report on K12's instances. Within it, on frame 0
of the synthetic HDL-64-like sequence (``generate_sequence(rings=64,
azimuth_steps=1800)``; downsampled at 0.25 m, ≈21k rows, and raw, ≈108k
rows), for each team of ``--teams`` (threads a query: 64 / team queries a
block), K12 over the cloud's kept sort with the cloud's first Q rows as
queries (Q = 64, 4,096 and all, k = 10; all at k = 20; the raw cloud
against itself at k = 20) takes turns with its first form (CUDA events
around one launch over a finished prologue, median of 20, 3 on the raw
cloud: ``ms``, ``v1_ms``) and each is timed alone by torch.profiler over 20
calls (``alone_ms``, ``v1_alone_ms``); ``planned`` is the team that
``pruned_plan`` picks there. Every result is checked equal to the first
form's. Frame 0 is generated once into ``build/pruned_walk_sweep/frames.npz``.
One JSON line per timing goes to standard output and to
``chiprun_out/pruned_walk_sweep.jsonl``.
"""

import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from box_walk_sweep import make_variant  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "build" / "pruned_walk_sweep"

RUN = r"""
import json, re, subprocess, sys
import numpy as np, torch
from small_gicp_tpu_torch import _build
_build.SIGNATURES = {n: _build.SIGNATURES[n] for n in ("knn",)}
from small_gicp_tpu_torch.ops import knn_cuda as kc
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.morton_boxes import pruned_prepare_target
from small_gicp_tpu_torch.point_cloud import PointCloud

variant, frames, out = sys.argv[1], sys.argv[3], sys.argv[4]
teams = [int(x) for x in sys.argv[2].split(",")]
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True,
                      check=True).stdout.strip().splitlines()[0]
dev = torch.device("cuda")
scan = np.load(frames)["scan0"]
_build.build_all()
# ptxas's report on K12's instances (registers, stack, shared memory).
lines = _build.build_log("knn").splitlines()
for at, line in enumerate(lines):
    found = re.search(r"knn_pruned_walk_kernelILi(\d+)ELi(\d+)E", line)
    if "Compiling entry" in line and found:
        for info in lines[at + 1:at + 4]:
            if "registers" in info or "stack frame" in info:
                print(f"[{variant}] [knn_pruned_walk_kernel<{found.group(1)}, "
                      f"{found.group(2)}>] {info.strip()}")


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
targets = {name: pruned_prepare_target(*c) for name, c in clouds.items()}
m = int(down.num_points)
cases = [("scan", 64, 10), ("scan", 4096, 10), ("scan", m, 10), ("scan", m, 20),
         ("raw", int(raw.num_points), 20)]
sms = torch.cuda.get_device_properties(dev).multi_processor_count
failed = []
for cloud, nq, k in cases:
    pts, num = clouds[cloud]
    target = targets[cloud]
    q = pts[:nq, :3]
    queries = kc.pruned_prepare_queries(target, q)
    qpos = kc.pruned_query_positions(target, queries).to(torch.int32)
    old = lambda: kc._knn_pruned_v1(target, num, q, queries, k, qpos)
    want = old()
    reps = 3 if cloud == "raw" else 20
    v1_alone = alone(old, "knn_pruned_kernel_v1")
    for team in teams:
        new = lambda: kc.knn_pruned_launch(target, num, q, queries, k, team=team)
        got = new()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ms = turns({"new": new, "v1": old}, reps)
        emit(kernel="K12", cloud=cloud, q=nq, rows=int(num), k=k, team=team,
             planned=kc.pruned_plan(nq, sms), ms=ms["new"], v1_ms=ms["v1"],
             alone_ms=alone(new, "knn_pruned_walk_kernel"), v1_alone_ms=v1_alone,
             equal=same)
        if not same:
            failed.append((cloud, nq, k, team))
if failed:
    sys.exit(f"{variant}: differs from the first form at {failed}")
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
    teams = "2,4,8"
    if "--teams" in args:
        at = args.index("--teams")
        end = next((i for i in range(at + 1, len(args)) if args[i].startswith("--")),
                   len(args))
        teams = ",".join(args[at + 1:end])
        args = args[:at] + args[end:]
    variants = args or [""]
    out = ROOT / "chiprun_out" / "pruned_walk_sweep.jsonl"
    out.parent.mkdir(exist_ok=True)
    frames = frames_file()
    failed = []
    for v in variants:
        root = make_variant(v, WORK)
        env = dict(os.environ, PYTHONPATH=str(root))
        rc = subprocess.run([sys.executable, "-c", RUN, v, teams, str(frames), str(out)],
                            cwd=root, env=env).returncode
        if rc != 0:
            failed.append(v)
    if failed:
        raise SystemExit(f"variants that failed: {failed}")


if __name__ == "__main__":
    main()
