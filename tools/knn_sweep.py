#!/usr/bin/env python3
"""Time K9 and K10 on one card over their tuning constants, beside their
first forms, at the shapes of ``chip_smoke.py`` phase 7.

    python3 tools/knn_sweep.py [NAME=VALUE,... ...] [--per-sm 8 16 32]
        [--rows-per-k 0 512]

Each variant (default: one with the compiled constants) is a copy of the
package under ``build/knn_sweep/`` with the named ``constexpr int``
constants of ``csrc/knn.cu`` set so (kNn1Rows, kKnnRows and kSampleStep
also set the wrapper's NN1_BLOCK_QUERIES, KNN_BLOCK_QUERIES and
SAMPLE_STEP to match), for example ``kKnnRows=1,kSampleStep=4``; each
copy runs in its own process and builds its own knn library. Within it,
for each ``SPLIT_BLOCKS_PER_SM`` of ``--per-sm`` and each
``KNN_ROWS_PER_K`` of ``--rows-per-k``, the new kernels and the first
forms take turns (CUDA events around one call, median of 20; 3 at 108k²)
on the downsampled first frame of the synthetic
HDL-64-like sequence (≈21k rows; queries: its first Q rows, and the
registration's 1-NN queries), on the raw frame (≈108k rows, k = 20) and
on the ``kdtree_benchmark`` CLI's clouds (n = 4,096 and 32,768 uniform
points in a 160 m cube, queried with themselves, k = 10 and 20).
Results are checked equal to the first forms. One JSON line per timing
goes to standard output and to ``chiprun_out/knn_sweep.jsonl``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RUN = r"""
import json, subprocess, sys
import numpy as np, torch
from small_gicp_tpu_torch import _build
_build.SIGNATURES = {"knn": _build.SIGNATURES["knn"]}
from small_gicp_tpu_torch.ops import knn_cuda as kc
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

variant, out = sys.argv[1], sys.argv[4]
per_sm_list, rpk_list = ([int(x) for x in a.split(",")] for a in sys.argv[2:4])
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True,
                      check=True).stdout.strip().splitlines()[0]
dev = torch.device("cuda")
scans, poses = generate_sequence(n_frames=2, rings=64, azimuth_steps=1800)
target, source = (voxelgrid_sampling(PointCloud.from_points(s, device=dev), 0.25)
                  for s in scans)
tpts, tnum = target.points, target.num_points
m, n = int(tnum), int(source.num_points)
T = torch.as_tensor(np.linalg.inv(poses[0]) @ poses[1], dtype=torch.float32, device=dev)
q1 = (source.points @ T.T)[:n, :3]
qs = tpts[:m, :3]
centre = kc.target_centre(tpts)
raw = PointCloud.from_points(scans[0], device=dev)
cube = np.random.default_rng(0).uniform(-80, 80, size=(65536, 3)).astype(np.float32)
uniform = {}
for n_u in (4096, 32768):
    sub = cube[np.random.default_rng(1).choice(len(cube), n_u, replace=False)]
    uniform[n_u] = PointCloud.from_points(sub, device=dev)


def turns(fns, reps):
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


def emit(**rec):
    rec.update(variant=variant, card=card)
    line = json.dumps(rec)
    print(line, flush=True)
    with open(out, "a") as f:
        f.write(line + "\n")


cases = [("nn1", "vpu", q1, tpts, tnum, 1, 20), ("nn1", "mxu", q1, tpts, tnum, 1, 20)]
for nq in (1, 64, 4096, m):
    cases.append(("knn", "k10", qs[:nq], tpts, tnum, 10, 20))
cases.append(("knn", "k20", qs, tpts, tnum, 20, 20))
cases.append(("knn", "raw k20", raw.points[:, :3], raw.points, raw.num_points, 20, 3))
for n_u, cloud in uniform.items():
    for k_u in (10, 20):
        cases.append(("knn", f"uniform k{k_u}", cloud.points[:, :3], cloud.points,
                      cloud.num_points, k_u, 20))
for per_sm, rpk in ((a, b) for a in per_sm_list for b in rpk_list):
    kc.SPLIT_BLOCKS_PER_SM, kc.KNN_ROWS_PER_K = per_sm, rpk
    for kind, what, q, t, num, k, reps in cases:
        if kind == "nn1":
            new = lambda: kc.nearest_neighbor(t, num, q, what, centre)
            old = lambda: kc._nearest_neighbor_v1(t, num, q, what, centre)
            block = kc.NN1_BLOCK_QUERIES
        else:
            new = lambda: kc.knn(t, num, q, k)
            old = lambda: kc._knn_v1(t, num, q, k)
            block = kc.KNN_BLOCK_QUERIES
        a, b = new(), old()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        ms = turns({"new": new, "v1": old}, reps)
        sms = kc._sm_count(dev.index or 0)
        nsplit = kc.split_plan(q.shape[0], t.shape[0], block, sms)
        least = kc.knn_least_rows(q.shape[0], k, sms) if kind == "knn" else None
        emit(kind=kind, what=what, q=q.shape[0], m=int(num), k=k, per_sm=per_sm,
             rows_per_k=rpk, nsplit=nsplit,
             chunk=kc.split_chunk(int(num), nsplit, least=least), ms=ms["new"], v1_ms=ms["v1"], equal=same)
        if not same:
            sys.exit(f"{variant} {kind} {what} q={q.shape[0]}: differs from v1")
"""


# knn.cu constants whose value the wrapper repeats: (name there, value).
MIRRORED = {"kNn1Rows": lambda v: ("NN1_BLOCK_QUERIES", 64 * v),
            "kKnnRows": lambda v: ("KNN_BLOCK_QUERIES", 64 * v),
            "kSampleStep": lambda v: ("SAMPLE_STEP", v)}


def make_variant(spec: str) -> Path:
    """A copy of the package with the constants of ``spec`` set; its root."""
    consts = dict(item.split("=") for item in spec.split(",") if item)
    root = ROOT / "build" / "knn_sweep" / (spec.replace("=", "").replace(",", "_")
                                           or "compiled")
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / "small_gicp_tpu_torch", root / "small_gicp_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = root / "small_gicp_tpu_torch" / "csrc" / "knn.cu"
    py = root / "small_gicp_tpu_torch" / "ops" / "knn_cuda.py"
    cu_src, py_src = cu.read_text(), py.read_text()
    for name, value in consts.items():
        cu_src, count = re.subn(rf"constexpr int {name} = \d+;",
                                f"constexpr int {name} = {int(value)};", cu_src)
        assert count == 1, name
        if name in MIRRORED:
            py_name, py_value = MIRRORED[name](int(value))
            py_src, count = re.subn(rf"^{py_name} = \d+$", f"{py_name} = {py_value}",
                                    py_src, flags=re.M)
            assert count == 1, py_name
    cu.write_text(cu_src)
    py.write_text(py_src)
    return root


def main() -> None:
    args = sys.argv[1:]
    lists = {"--per-sm": "8,16,32", "--rows-per-k": "0"}
    for flag in ("--rows-per-k", "--per-sm"):
        if flag in args:
            at = args.index(flag)
            end = next((i for i in range(at + 1, len(args)) if args[i].startswith("--")),
                       len(args))
            lists[flag] = ",".join(args[at + 1:end])
            args = args[:at] + args[end:]
    variants = args or [""]
    out = ROOT / "chiprun_out" / "knn_sweep.jsonl"
    out.parent.mkdir(exist_ok=True)
    failed = []
    for v in variants:
        root = make_variant(v)
        env = dict(os.environ, PYTHONPATH=str(root))
        rc = subprocess.run([sys.executable, "-c", RUN, v, lists["--per-sm"],
                             lists["--rows-per-k"], str(out)],
                            cwd=root, env=env).returncode
        if rc != 0:
            failed.append(v)
    if failed:
        raise SystemExit(f"variants that failed: {failed}")


if __name__ == "__main__":
    main()
