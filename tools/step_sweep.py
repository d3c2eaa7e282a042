#!/usr/bin/env python3
"""Time the LM step kernel (K2 redesigned) on one card by its variant, such
as source rows a block (``kStepBlockRows``, mirrored in
``ops/lm_step.STEP_BLOCK_ROWS``).

    python3 tools/step_sweep.py [NAME=VALUE,... ...]

Each variant (default: ``kStepBlockRows=128 "" kStepBlockRows=512``, the
compiled 256 in the middle) is a copy of the package
under ``build/step_sweep/`` with the named ``constexpr int`` constants of
``csrc/`` set so (``tools/box_walk_sweep.py``'s ``make_variant``); each copy
runs in its own process and builds its own libraries. Within it, on the
synthetic HDL-64-like pair (frames 0 and 1 of ``generate_sequence(rings=64,
azimuth_steps=1800)``, 0.25 m voxels, ≈21k points, preprocessed): the step
at K = 10 on the first iteration's sums and corr, checked against its plain
version (errors within 1e-5 relative, trials within 1e-6), then timed alone
by torch.profiler over 20 calls (``alone_ms``) and by CUDA events around
one call (``ms``, median of 20), beside the GN step (``gn_alone_ms``) and
the errors-only mode at 1 and 11 poses (``errors_1_alone_ms``,
``errors_11_alone_ms``); and 10 GICP/LM aligns from noisy guesses,
host clock per LM iteration (``ms_per_iteration``). The two frames are
generated once into ``build/step_sweep/frames.npz``. One JSON line per
variant goes to standard output and to ``build/step_sweep/step_sweep.jsonl``.
"""

import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from box_walk_sweep import make_variant  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "build" / "step_sweep"

RUN = r"""
import json, re, subprocess, sys, time
import numpy as np, torch
from small_gicp_tpu_torch import _build
_build.SIGNATURES = {n: _build.SIGNATURES[n]
                     for n in ("cov_fused", "gicp_listed", "gicp_step")}
from small_gicp_tpu_torch.models.helper import align, preprocess_points
from small_gicp_tpu_torch.ops import gicp_fused_cuda as gf
from small_gicp_tpu_torch.ops.lm_step import gicp_lm_step, lm_state
from small_gicp_tpu_torch.utils.lie import se3_exp

variant, frames, out = sys.argv[1], sys.argv[2], sys.argv[3]
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True,
                      check=True).stdout.strip().splitlines()[0]
dev = torch.device("cuda")
data = np.load(frames)
scans, poses = [data["scan0"], data["scan1"]], data["poses"]
T_gt = np.linalg.inv(poses[0]) @ poses[1]
rng = np.random.default_rng(0)


def noisy():
    tw = np.r_[rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.2]
    return T_gt @ se3_exp(torch.as_tensor(tw)).numpy()


def alone(fn, pattern, reps=20):
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


def events(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


tgt, tree = preprocess_points(scans[0], 0.25, num_neighbors=10, device=dev)
src, _ = preprocess_points(scans[1], 0.25, num_neighbors=10, device=dev)
n = int(src.num_points)
T = torch.as_tensor(noisy(), dtype=torch.float32, device=dev)
tables = gf.gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                         "gicp", tgt.covs, src.covs, target=tree.pruned_target())
sums, corr = gf.gicp_linearize_sums(tables, T, 1.0)
kern, plain = lm_state(T, device=dev), lm_state(T.cpu(), device="cpu")
gicp_lm_step(kern, sums, corr, src.points, src.num_points)
gicp_lm_step(plain, sums.cpu(), corr.cpu(), src.points.cpu(), src.num_points.cpu())
rel = ((kern.errs.cpu() - plain.errs).abs() / plain.errs.abs()).max().item()
d_trial = (kern.trials.cpu() - plain.trials).abs().max().item()
st = lm_state(T, device=dev)
step = lambda: gicp_lm_step(st, sums, corr, src.points, src.num_points)
alone_ms, ms = alone(step, r"gicp_step_kernel<float, 1"), events(step)
# Where the time goes: the GN step (one solve, the errors at one pose) and
# the errors-only mode at 1 and at 11 poses (no solve, no accept).
st_gn = lm_state(T, "gn", device=dev)
gn_ms = alone(lambda: gicp_lm_step(st_gn, sums, corr, src.points, src.num_points),
              r"gicp_step_kernel<float, 2")
Ts = T.expand(11, 4, 4).contiguous()
errs_1_ms, errs_11_ms = (
    alone(lambda: gf.gicp_error_multi(corr, src.points, P, src.num_points),
          r"gicp_step_kernel<float, 0") for P in (Ts[:1], Ts))
per_it = []
for _ in range(10):
    g = noisy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = align(tgt, src, tree, init_T_target_source=g)
    torch.cuda.synchronize()
    per_it.append((time.perf_counter() - t0) * 1e3 / (int(res.iterations) + 1))
rec = dict(variant=variant, card=card, rows=n, poses=11, alone_ms=alone_ms, ms=ms,
           gn_alone_ms=gn_ms, errors_1_alone_ms=errs_1_ms, errors_11_alone_ms=errs_11_ms,
           ms_per_iteration=float(np.median(per_it)), errs_rel=rel, trials_abs=d_trial)
line = json.dumps(rec)
print(line, flush=True)
with open(out, "a") as f:
    f.write(line + "\n")
if rel > 1e-5 or d_trial > 1e-6:
    sys.exit(f"{variant}: the step differs from its plain version")
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
    variants = sys.argv[1:] or ["kStepBlockRows=128", "", "kStepBlockRows=512"]
    frames = frames_file()
    out = WORK / "step_sweep.jsonl"
    failed = []
    for v in variants:
        root = make_variant(v, WORK)
        env = dict(os.environ, PYTHONPATH=str(root))
        rc = subprocess.run([sys.executable, "-c", RUN, v, str(frames), str(out)],
                            cwd=root, env=env).returncode
        if rc != 0:
            failed.append(v)
    if failed:
        raise SystemExit(f"variants that failed: {failed}")


if __name__ == "__main__":
    main()
