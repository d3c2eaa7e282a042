#!/usr/bin/env python3
"""Time K4 and K6 on one card over their tuning constants, beside their
first forms, at the shapes of ``chip_smoke.py`` phase 8.

    python3 tools/box_walk_sweep.py [NAME=VALUE,... ...] [--per-sm 8 16 32]

Each variant (default: one with the compiled constants) is a copy of the
package under ``build/box_walk_sweep/`` with the named ``constexpr int``
constants of ``csrc/`` set so — ``kCullPass`` (boxes per cull pass,
``csrc/common.cuh``; it also sets ``morton_boxes.CULL_PASS``), and K4's
``kOutward`` (1: passes from the block's own box outwards, 0: in ascending
order) and ``kWalkMinBlocks`` (the blocks an SM should hold of the k ≤ 16
instance, its register cap; 1: the compiler's choice) in
``csrc/cov_fused.cu`` — for example ``kCullPass=512,kWalkMinBlocks=1``;
each copy runs in its own process and builds its own cov_fused and
gicp_swept libraries. Within it K4 (k = 10 and 20, on the first submap of 8
raw frames, ≈862k rows) and, for each ``SWEPT_BLOCKS_PER_SM`` of
``--per-sm`` (K6's chunk plan), K6 (GICP, on the ≈1.72 M-row map of both
submaps against frame 16, and at the scan shape, frame 15 against frame
16) take turns with their first forms (CUDA events around one call,
median of 20: ``ms``, ``v1_ms``), and each kernel is timed alone by
torch.profiler over 20 calls (``alone_ms``, ``v1_alone_ms``; K6's wrapper
spends tenths of a millisecond of torch ops around its launch). Every
result is checked equal to the first form's. The 17 frames are generated
once into ``build/box_walk_sweep/frames.npz``. One JSON line per timing
goes to standard output and to ``chiprun_out/box_walk_sweep.jsonl``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "build" / "box_walk_sweep"

RUN = r"""
import json, subprocess, sys
import numpy as np, torch
from small_gicp_tpu_torch import _build
_build.SIGNATURES = {n: _build.SIGNATURES[n] for n in ("cov_fused", "gicp_swept")}
from small_gicp_tpu_torch.models.helper import preprocess_points
from small_gicp_tpu_torch.ops import gicp_fused_cuda as gf
from small_gicp_tpu_torch.ops.cov_fused_cuda import _knn_topk_idx_v1, knn_topk_idx
from small_gicp_tpu_torch.ops.morton_boxes import pruned_prepare_target
from small_gicp_tpu_torch.ops.normals import estimate_covariances
from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.utils.lie import se3_exp

variant, frames, out = sys.argv[1], sys.argv[3], sys.argv[4]
per_sm_list = [int(x) for x in sys.argv[2].split(",")]
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True,
                      check=True).stdout.strip().splitlines()[0]
dev = torch.device("cuda")
data = np.load(frames)
scans = [data[f"scan{i}"] for i in range(17)]
poses = data["poses"]


def world(ids):
    return np.concatenate([(scans[i].astype(np.float64) @ poses[i][:3, :3].T
                            + poses[i][:3, 3]).astype(np.float32) for i in ids])


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
    import re
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


subs = [PointCloud.from_points(world(range(8 * i, 8 * i + 8)), device=dev)
        for i in range(2)]
sub = subs[0]
target = pruned_prepare_target(sub.points, sub.num_points)
for k in (10, 20):
    new = lambda: knn_topk_idx(sub.points, sub.num_points, k, target=target)
    old = lambda: _knn_topk_idx_v1(target, sub.num_points, k)
    same = all(torch.equal(a, b) for a, b in zip(new(), old()))
    ms = turns({"new": new, "v1": old})
    emit(kernel="K4", what="submap", rows=int(sub.num_points), k=k, ms=ms["new"],
         v1_ms=ms["v1"], alone_ms=alone(new, r"knn_topk_idx_kernel(?!_v1)"),
         v1_alone_ms=alone(old, "knn_topk_idx_kernel_v1"), equal=same)
    if not same:
        sys.exit(f"{variant} K4 k={k}: differs from its first form")

covs = [estimate_covariances(s, num_neighbors=10) for s in subs]
the_map = PointCloud(
    points=torch.cat([c.points[:int(c.num_points)] for c in covs]),
    num_points=sum(c.num_points for c in covs).to(torch.int32),
    covs=torch.cat([c.covs[:int(c.num_points)] for c in covs]))
source, _ = preprocess_points(scans[16], 0.25, num_neighbors=10, device=dev)
scan_t, _ = preprocess_points(scans[15], 0.25, num_neighbors=10, device=dev)
noise = se3_exp(torch.tensor([0.002, -0.001, 0.003, 0.05, -0.04, 0.03],
                             dtype=torch.float64)).numpy()
cases = {
    "map": (the_map, torch.as_tensor(poses[16] @ noise, dtype=torch.float32, device=dev)),
    "scan shape": (scan_t, torch.as_tensor(np.linalg.inv(poses[15]) @ poses[16] @ noise,
                                           dtype=torch.float32, device=dev)),
}
for what, (tgt, T) in cases.items():
    tables = gf.gicp_prepare(tgt.points, tgt.num_points, source.points, source.num_points,
                             "gicp", tgt.covs, source.covs, route="swept")
    old_out = gf._gicp_linearize_swept_v1(tables, T, 1.0)
    for per_sm in per_sm_list:
        gf.SWEPT_BLOCKS_PER_SM = per_sm
        chunks = gf.swept_plan(tables)
        new = lambda: gf.gicp_linearize_tables(tables, T, 1.0)
        old = lambda: gf._gicp_linearize_swept_v1(tables, T, 1.0)
        same = all(torch.equal(a, b) for a, b in zip(new(), old_out))
        ms = turns({"new": new, "v1": old})
        emit(kernel="K6", what=what, rows=int(tgt.num_points), q=int(source.num_points),
             per_sm=per_sm, chunks=chunks, ms=ms["new"], v1_ms=ms["v1"],
             alone_ms=alone(new, r"gicp_linearize_swept_kernel(?!_v1)"),
             v1_alone_ms=alone(old, "gicp_linearize_swept_kernel_v1"), equal=same)
        if not same:
            sys.exit(f"{variant} K6 {what} per_sm={per_sm}: differs from its first form")
"""

# csrc constants whose value a Python module repeats: name → (file, name there).
MIRRORED = {"kCullPass": ("ops/morton_boxes.py", "CULL_PASS"),
            "kTeam": ("ops/cov_fused_cuda.py", "MOMENTS_TEAM"),
            "kWarpTeam": ("ops/cov_fused_cuda.py", "MOMENTS_Q_TEAM"),
            "kWarpQueries": ("ops/knn_cuda.py", "WARP_QUERIES"),
            "kWarpMaxWarps": ("ops/knn_cuda.py", "WARP_MAX_WARPS"),
            "kWarpListBytes": ("ops/knn_cuda.py", "WARP_LIST_BYTES"),
            "kWarpSampleStep": ("ops/knn_cuda.py", "WARP_SAMPLE_STEP"),
            "kStepBlockRows": ("ops/lm_step.py", "STEP_BLOCK_ROWS")}


def make_variant(spec: str, work: Path = WORK) -> Path:
    """A copy of the package under ``work`` with the constants of ``spec``
    set; its root."""
    consts = dict(item.split("=") for item in spec.split(",") if item)
    root = work / (spec.replace("=", "").replace(",", "_") or "compiled")
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / "small_gicp_tpu_torch", root / "small_gicp_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pkg = root / "small_gicp_tpu_torch"
    for name, value in consts.items():
        found = 0
        for src in sorted((pkg / "csrc").iterdir()):
            text, count = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {int(value)};", src.read_text())
            if count:
                src.write_text(text)
                found += count
        assert found == 1, name
        if name in MIRRORED:
            path, py_name = MIRRORED[name]
            py = pkg / path
            text, count = re.subn(rf"^{py_name} = \d+$", f"{py_name} = {int(value)}",
                                  py.read_text(), flags=re.M)
            assert count == 1, py_name
            py.write_text(text)
    return root


def frames_file() -> Path:
    """The 17 frames of chip_smoke.py phase 8, generated once."""
    path = WORK / "frames.npz"
    if not path.exists():
        sys.path.insert(0, str(ROOT))
        import numpy as np

        from small_gicp_tpu_torch.utils.synthetic import generate_sequence

        scans, poses = generate_sequence(n_frames=17, rings=64, azimuth_steps=1800)
        WORK.mkdir(parents=True, exist_ok=True)
        np.savez(path, poses=np.stack(poses), **{f"scan{i}": s for i, s in enumerate(scans)})
    return path


def main() -> None:
    args = sys.argv[1:]
    per_sm = "16"
    if "--per-sm" in args:
        at = args.index("--per-sm")
        end = next((i for i in range(at + 1, len(args)) if args[i].startswith("--")),
                   len(args))
        per_sm = ",".join(args[at + 1:end])
        args = args[:at] + args[end:]
    variants = args or [""]
    out = ROOT / "chiprun_out" / "box_walk_sweep.jsonl"
    out.parent.mkdir(exist_ok=True)
    frames = frames_file()
    failed = []
    for v in variants:
        root = make_variant(v)
        env = dict(os.environ, PYTHONPATH=str(root))
        rc = subprocess.run([sys.executable, "-c", RUN, v, per_sm, str(frames), str(out)],
                            cwd=root, env=env).returncode
        if rc != 0:
            failed.append(v)
    if failed:
        raise SystemExit(f"variants that failed: {failed}")


if __name__ == "__main__":
    main()
