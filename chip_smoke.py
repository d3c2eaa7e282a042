#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA card and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):
  1. device   — CUDA must be present; prints the card's name and power limit;
  2. build    — compiles the CUDA kernels from ``small_gicp_tpu_torch/csrc``;
  3. data     — two consecutive KITTI HDL-64-like synthetic frames
                (64 rings × 1800 azimuth steps, ≈108k points each);
  4. kernels  — K1, K2 and K3 at the main path's shapes against their plain
                versions, with times (CUDA events), bounds and yardsticks;
  5. e2e      — preprocess_points on both frames, then GICP/LM align within
                2.5° / 0.2 m of ground truth, with every kernel launched;
                registrations/s over noisy initial guesses; the card path
                against the plain CPU path on a small pair;
  6. fleet    — three frames preprocessed at one capacity (two pairs); K7
                and K8 at 32 lanes against their plain versions; align_fleet
                over 512 noisy problems through 32 lanes, every problem
                within the bounds or in agreement with align_impl, sampled
                rows against align_impl, lane-count invariance, fleet
                registrations/s and the card's busy share;
  7. search   — K9 (both variants) at the registration shape and K10, K11,
                K12 at the covariance shape (k = 10, 20) and at raw-scan
                scale (≈108k × 108k, k = 20) against their plain versions
                and each other; K9's and K12's launches timed apart from
                their wrappers' prologues, K12 bounded by the pairs this
                data leaves a pruned search; K10 against K11 by query
                count; then the
                neighbour-search path with the counts at 0: KdTree searches,
                knn_T, knn_pruned, the unfused align_impl (within the bounds,
                in agreement with the fused one, K9 once per linearization
                and no K1/K2) and the kdtree_benchmark CLI in process.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

from small_gicp_tpu_torch import _build
from small_gicp_tpu_torch.apps import kdtree_benchmark
from small_gicp_tpu_torch.interop import result_to_numpy
from small_gicp_tpu_torch.models.helper import align, preprocess_points
from small_gicp_tpu_torch.ops.cov_fused_cuda import (
    knn_moments_rows,
    knn_moments_rows_plain,
)
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.eigh3 import solve6x6
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    gicp_error_multi,
    gicp_error_multi_fleet,
    gicp_error_multi_fleet_plain,
    gicp_error_multi_plain,
    gicp_linearize_fleet,
    gicp_linearize_fleet_plain,
    gicp_linearize_plain,
    gicp_linearize_tables,
    gicp_prepare,
)
from small_gicp_tpu_torch.models.registration import align_impl
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.ops.knn_cuda import (
    BLOCK_QUERIES,
    TILE_ROWS,
    knn,
    knn_plain,
    knn_pruned,
    knn_pruned_launch,
    knn_pruned_plain,
    knn_T,
    nearest_neighbor,
    nearest_neighbor_plain,
    pruned_prepare_queries,
    pruned_prepare_target,
)
from small_gicp_tpu_torch.ops.normals import estimate_normals_covariances
from small_gicp_tpu_torch.parallel.fleet import align_fleet, fleet_prepare
from small_gicp_tpu_torch.point_cloud import PointCloud, stack_clouds
from small_gicp_tpu_torch.utils.lie import rotation_error_deg, se3_exp
from small_gicp_tpu_torch.utils.synthetic import generate_sequence

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
LEAF = 0.25
K_NEIGHBORS = 10
MAX_DIST_SQ = 1.0
ROT_EPS = 0.1 * math.pi / 180.0
TRANS_EPS = 1e-3
REPS = 20
FLEET_LANES = 32
FLEET_PROBLEMS = 512

KERNELS = {
    "gicp_linearize": ("K1", "small_gicp_tpu_torch/csrc/gicp_fused.cu",
                       "small_gicp_tpu/ops/gicp_fused_pallas.py:466",
                       gicp_linearize_tables),
    "gicp_error_multi": ("K2", "small_gicp_tpu_torch/csrc/gicp_fused.cu",
                         "small_gicp_tpu/ops/gicp_fused_pallas.py:1033",
                         gicp_error_multi),
    "knn_moments": ("K3", "small_gicp_tpu_torch/csrc/cov_fused.cu",
                    "small_gicp_tpu/ops/cov_fused_pallas.py:171",
                    knn_moments_rows),
    "gicp_linearize_fleet": ("K7", "small_gicp_tpu_torch/csrc/gicp_fused.cu",
                             "small_gicp_tpu/ops/gicp_fused_pallas.py:1312",
                             gicp_linearize_fleet),
    "gicp_error_multi_fleet": ("K8", "small_gicp_tpu_torch/csrc/gicp_fused.cu",
                               "small_gicp_tpu/ops/gicp_fused_pallas.py:1438",
                               gicp_error_multi_fleet),
    "nearest_neighbor": ("K9", "small_gicp_tpu_torch/csrc/knn.cu",
                         "small_gicp_tpu/ops/knn_pallas.py:35", nearest_neighbor),
    "knn": ("K10", "small_gicp_tpu_torch/csrc/knn.cu",
            "small_gicp_tpu/ops/knn_pallas.py:513", knn),
    "knn_T": ("K11", "small_gicp_tpu_torch/csrc/knn.cu",
              "small_gicp_tpu/ops/knn_pallas.py:378", knn_T),
    "knn_pruned": ("K12", "small_gicp_tpu_torch/csrc/knn.cu",
                   "small_gicp_tpu/ops/knn_pallas.py:117", knn_pruned),
}
MAIN_KERNELS = ("gicp_linearize", "gicp_error_multi", "knn_moments")
FLEET_KERNELS = ("gicp_linearize_fleet", "gicp_error_multi_fleet")
SEARCH_KERNELS = ("nearest_neighbor", "knn", "knn_T", "knn_pruned")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of ops over the f32 peak and bytes
    over the memory rate."""
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pose_errors(T: np.ndarray, T_gt: np.ndarray):
    """(rotation errors in degrees, translation errors in metres) of
    [..., 4, 4] poses, float64 arrays."""
    T = torch.as_tensor(np.asarray(T, np.float64))
    T_gt = torch.as_tensor(np.asarray(T_gt, np.float64))
    rot = rotation_error_deg(T_gt[..., :3, :3], T[..., :3, :3])
    return rot.numpy(), torch.linalg.vector_norm(T[..., :3, 3] - T_gt[..., :3, 3],
                                                 dim=-1).numpy()


def pose_error(T: np.ndarray, T_gt: np.ndarray):
    """(rotation error in degrees, translation error in metres), float64."""
    rot, trans = pose_errors(T, T_gt)
    return float(rot), float(trans)


def noisy_guess(T_gt: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """T_gt·exp(noise), noise σ = 0.03 rad and 0.2 m."""
    tw = np.r_[rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.2]
    return T_gt @ se3_exp(torch.as_tensor(tw)).numpy()


def phase_kernels(scans, T_gt, rng, dev):
    """K1-K3 at the main path's shapes against their plain versions."""
    print("== phase 4: kernels against their plain versions", flush=True)
    clouds = [voxelgrid_sampling(PointCloud.from_points(s, device=dev), LEAF)
              for s in scans]
    tgt, src = clouds
    m, n = int(tgt.num_points), int(src.num_points)
    print(f"downsampled: target {m} / source {n} points "
          f"(capacities {tgt.capacity} / {src.capacity})")
    records = {}

    # K3: kNN moments of the target cloud.
    pts, num = tgt.points, tgt.num_points
    got = knn_moments_rows(pts, num, K_NEIGHBORS)
    ref = knn_moments_rows_plain(pts, num, K_NEIGHBORS)
    check(torch.equal(got[:m, 9:11], ref[:m, 9:11]),
          "K3 neighbour counts or kth distances differ")
    diff = (got[:m, :9] - ref[:m, :9]).abs()
    err = diff.max().item()
    excess = (diff - 1e-5 * ref[:m, :9].abs()).max().item()
    print(f"K3 knn_moments: counts and d_k equal, max |Δ moments| = {err:.3e} "
          "(tolerance 1e-4 + 1e-5·|m|: float32 sums of k products)")
    check(excess <= 1e-4, f"K3 moments differ by {err}")
    t1 = tgt.points[:m, :3].contiguous()
    lib_fn = lambda: torch.topk(torch.cdist(t1, t1), K_NEIGHBORS, largest=False)  # noqa: E731
    # reads the m valid rows once, writes a 64-byte row per capacity row
    ops, nbytes = 9.0 * m * m, 16.0 * m + 64.0 * tgt.capacity
    records["knn_moments"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: knn_moments_rows(pts, num, K_NEIGHBORS)),
        plain_ms=time_ms(lambda: knn_moments_rows_plain(pts, num, K_NEIGHBORS)),
        library_ms=time_ms(lib_fn), pairs=m * m, bound=bound(ops, nbytes))

    # K1: fused search + linearize at a noisy guess.
    tgt = estimate_normals_covariances(tgt, num_neighbors=K_NEIGHBORS)
    src = estimate_normals_covariances(src, num_neighbors=K_NEIGHBORS)
    T = torch.as_tensor(noisy_guess(T_gt, rng), dtype=torch.float32, device=dev)
    tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                          "gicp", tgt.covs, src.covs)
    H, b, inl, corr = gicp_linearize_tables(tables, T, MAX_DIST_SQ)
    Hp, bp, inlp, corrp = gicp_linearize_plain(tables, T, MAX_DIST_SQ)
    mask = corr[:n, 12] > 0.5
    check(torch.equal(mask, corrp[:n, 12] > 0.5), "K1 inlier masks differ")
    check(int(inl) == int(inlp), "K1 inlier counts differ")
    check(torch.equal(corr[:n, :3][mask], corrp[:n, :3][mask])
          and torch.equal(corr[:n, 13][mask], corrp[:n, 13][mask]),
          "K1 correspondences (μ, d²) differ")
    w_err = ((corr[:n, 3:12] - corrp[:n, 3:12])[mask].abs()
             / torch.clamp(corrp[:n, 3:12][mask].abs(), min=1.0)).max().item()
    h_scale = max(1.0, Hp.abs().max().item())
    b_scale = max(1.0, bp.abs().max().item())
    h_err = (H - Hp).abs().max().item()
    b_err = (b - bp).abs().max().item()
    print(f"K1 gicp_linearize: {int(inl)} inliers, masks/μ/d² equal, "
          f"W rel {w_err:.2e} (tol 2e-3), |ΔH| {h_err:.3e} "
          f"(scaled {h_err / h_scale:.2e}, tol 5e-4), |Δb| {b_err:.3e} "
          f"(scaled {b_err / b_scale:.2e}, tol 5e-4)")
    check(w_err <= 2e-3, f"K1 W differs by {w_err}")
    check(h_err / h_scale <= 5e-4 and b_err / b_scale <= 5e-4, "K1 H/b differ")
    tq = (src.points[:n, :3] @ T[:3, :3].T + T[:3, 3]).contiguous()
    tt = tgt.points[:m, :3].contiguous()
    lib_fn = lambda: torch.cdist(tq, tt).min(dim=1)  # noqa: E731
    ops = 9.0 * n * m + 400.0 * n
    # valid target rows; every source row is read (qtab) and written (corr)
    nbytes = 64.0 * (m + 2 * src.capacity) + 4.0 * 44 * ((src.capacity + 63) // 64)
    records["gicp_linearize"] = dict(
        max_abs_err=h_err,
        ms=time_ms(lambda: gicp_linearize_tables(tables, T, MAX_DIST_SQ)),
        plain_ms=time_ms(lambda: gicp_linearize_plain(tables, T, MAX_DIST_SQ)),
        library_ms=time_ms(lib_fn), pairs=n * m, bound=bound(ops, nbytes))

    # K2: the current pose plus the 10 LM trial poses of the first iteration.
    lambdas = 1e-3 * 10.0 ** torch.arange(10, dtype=torch.float32, device=dev)
    deltas = solve6x6(H.float(), -b.float(), lambdas)
    Ts = torch.cat([T[None], T @ se3_exp(deltas)])
    e = gicp_error_multi(corr, src.points, Ts, src.num_points)
    ep = gicp_error_multi_plain(corr, src.points, Ts, src.num_points)
    check(bool(torch.isfinite(e).all()), "K2 errors not finite")
    rel = ((e - ep).abs() / ep.abs().clamp(min=1e-30)).max().item()
    err = (e - ep).abs().max().item()
    print(f"K2 gicp_error_multi: {Ts.shape[0]} poses, max |Δe| {err:.3e}, "
          f"rel {rel:.2e} (tol 1e-5)")
    check(rel <= 1e-5, f"K2 errors differ by rel {rel}")
    ops = 40.0 * n * Ts.shape[0]
    nbytes = n * (64 + 16) + Ts.shape[0] * 48
    records["gicp_error_multi"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: gicp_error_multi(corr, src.points, Ts, src.num_points)),
        plain_ms=time_ms(
            lambda: gicp_error_multi_plain(corr, src.points, Ts, src.num_points)),
        library_ms=None, pairs=n * Ts.shape[0], bound=bound(ops, nbytes))
    return records


def phase_e2e(scans, T_gt, rng, dev, card, records):
    print("== phase 5: end to end", flush=True)
    for _, _, _, fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    target, tree = preprocess_points(scans[0], LEAF, num_neighbors=K_NEIGHBORS,
                                     device=dev)
    source, _ = preprocess_points(scans[1], LEAF, num_neighbors=K_NEIGHBORS,
                                  device=dev)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    init = noisy_guess(T_gt, rng)
    t0 = time.perf_counter()
    res = align(target, source, tree, init_T_target_source=init)
    torch.cuda.synchronize()
    t_align = time.perf_counter() - t0
    launches = {name: KERNELS[name][3].launches for name in MAIN_KERNELS}
    r = result_to_numpy(res)
    rot, trans = pose_error(r["T_target_source"], T_gt)
    print(f"num_points target {int(target.num_points)} source "
          f"{int(source.num_points)}; preprocess {t_pre:.3f} s, align "
          f"{t_align:.3f} s; iterations {r['iterations']} converged "
          f"{r['converged']} inliers {r['num_inliers']} error {r['error']:.6g}")
    print(f"pose error vs ground truth: {rot:.4f} deg, {trans:.4f} m "
          "(bounds 2.5 deg, 0.2 m)")
    print(f"launches on the main path: {launches}")
    check(np.isfinite(r["T_target_source"]).all(), "non-finite pose")
    check(rot < 2.5 and trans < 0.2, "registration outside the reference bounds")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")

    n_regs, iters = 10, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_regs):
        out = align(target, source, tree, init_T_target_source=noisy_guess(T_gt, rng))
        iters.append(int(out.iterations))
        rot, trans = pose_error(out.T_target_source.cpu().numpy(), T_gt)
        check(rot < 2.5 and trans < 0.2, "a timed registration left the bounds")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    reg_per_s = n_regs / dt
    print(f"registrations/s: {reg_per_s:.3f} ({n_regs} aligns, iterations "
          f"{iters}, preprocessing excluded) on {card}")
    # Each align runs K1 and K2 once per executed iteration.
    calls = sum(i + 1 for i in iters)
    k_ms = calls * (records["gicp_linearize"]["ms"] + records["gicp_error_multi"]["ms"])
    print(f"K1+K2 time inside those aligns: {k_ms:.3f} ms of {dt * 1e3:.3f} ms "
          f"wall ({100 * k_ms / (dt * 1e3):.1f}%), {dt * 1e3 / calls:.3f} ms "
          "wall per optimizer iteration")

    # Device busy share over three aligns, from a torch.profiler trace
    # (its own overhead lengthens the wall time a little).
    from torch.profiler import ProfilerActivity, profile

    inits = [noisy_guess(T_gt, rng) for _ in range(3)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for init in inits:
            align(target, source, tree, init_T_target_source=init)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events)
    check(busy_us > 0, "the profiler saw no device time")
    print(f"profiled 3 aligns: device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({100 * busy_us / wall_us:.1f}% busy); "
          f"{sum(e.count for e in events if e.key == 'cudaLaunchKernel')} "
          "kernel launches; top device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")

    # The card path against the plain CPU path on a small pair.
    small, poses = generate_sequence(n_frames=2, rings=16, azimuth_steps=256)
    T_small = np.linalg.inv(poses[0]) @ poses[1]
    init = noisy_guess(T_small, rng)
    a = result_to_numpy(align(small[0], small[1], init_T_target_source=init,
                              device=dev))
    c = result_to_numpy(align(small[0], small[1], init_T_target_source=init,
                              device="cpu"))
    d_rot, d_trans = pose_error(a["T_target_source"], c["T_target_source"])
    print(f"small pair, card vs CPU plain path: Δ {d_rot:.2e} deg, "
          f"{d_trans:.2e} m, iterations {a['iterations']} vs {c['iterations']}")
    check(math.radians(d_rot) <= 2 * ROT_EPS and d_trans <= 2 * TRANS_EPS
          and abs(a["iterations"] - c["iterations"]) <= 1,
          "card and CPU paths disagree on the small pair")
    return launches, reg_per_s


def _agrees(fleet_row, ref) -> bool:
    """A fleet row and align_impl's result for the same problem agree within
    2× the convergence thresholds and one iteration (float32 reduction
    order can flip a knife-edge LM accept between the two paths)."""
    d_rot, d_trans = pose_error(fleet_row[0], ref.T_target_source.cpu().numpy())
    return (math.radians(d_rot) <= 2 * ROT_EPS and d_trans <= 2 * TRANS_EPS
            and abs(fleet_row[1] - int(ref.iterations)) <= 1)


def phase_fleet(scans, poses, rng, dev, card, align_reg_per_s,
                lanes=FLEET_LANES, problems=FLEET_PROBLEMS):
    """K7/K8 against their plain versions, then align_fleet end to end."""
    print("== phase 6: fleet", flush=True)
    f32 = torch.float32
    # One capacity for every frame, as bench.py sizes it: the largest
    # voxel count plus headroom, rounded up to 512 rows.
    n_est = max(int(voxelgrid_sampling(PointCloud.from_points(s, device=dev),
                                       LEAF).num_points) for s in scans)
    cap = (n_est + 256 + 511) // 512 * 512
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clouds = [preprocess_points(s, LEAF, num_neighbors=K_NEIGHBORS, max_points=cap,
                                device=dev)[0] for s in scans]
    targets, sources = stack_clouds(clouds[:-1]), stack_clouds(clouds[1:])
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = fleet_prepare(targets, sources)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    gts = [np.linalg.inv(poses[u]) @ poses[u + 1] for u in range(len(scans) - 1)]
    n_valid = [int(c.num_points) for c in clouds]
    print(f"{len(scans)} frames → {len(gts)} pairs at capacity {cap}, valid rows "
          f"{n_valid}; preprocess {t_pre:.3f} s, fleet_prepare {t_prep:.4f} s")
    m_u, n_u = n_valid[:-1], n_valid[1:]  # target / source rows of each pair
    records = {}

    # K7 over `lanes` lanes on both pairs, the last two lanes inactive.
    B = lanes
    uid_list = [b % len(gts) for b in range(B)]
    uids = torch.tensor(uid_list, dtype=torch.int32, device=dev)
    active = torch.arange(B, device=dev) < B - 2
    Ts = torch.as_tensor(np.stack([noisy_guess(gts[u], rng) for u in uid_list]),
                         dtype=f32, device=dev)
    H, b, inl, corr = gicp_linearize_fleet(tables, uids, Ts, MAX_DIST_SQ, active)
    Hp, bp, inlp, corrp = gicp_linearize_fleet_plain(tables, uids, Ts, MAX_DIST_SQ,
                                                     active)
    mask = corr[..., 12] > 0.5
    check(torch.equal(mask, corrp[..., 12] > 0.5), "K7 inlier masks differ")
    check(torch.equal(inl, inlp), "K7 inlier counts differ")
    check(torch.equal(corr[mask][:, [0, 1, 2, 13]], corrp[mask][:, [0, 1, 2, 13]]),
          "K7 correspondences (μ, d²) differ")
    w_err = ((corr[..., 3:12] - corrp[..., 3:12])[mask].abs()
             / corrp[..., 3:12][mask].abs().clamp(min=1.0)).max().item()
    h_err = ((H - Hp).abs().amax(dim=(1, 2))
             / Hp.abs().amax(dim=(1, 2)).clamp(min=1.0)).max().item()
    b_err = ((b - bp).abs().amax(dim=1) / bp.abs().amax(dim=1).clamp(min=1.0)).max().item()
    idle = ~active
    check(bool(torch.all(H[idle] == 0) & torch.all(b[idle] == 0)
               & torch.all(inl[idle] == 0) & torch.all(corr[idle] == 0)),
          "K7 inactive lanes are not zero")
    print(f"K7 gicp_linearize_fleet: {B} lanes ({int(active.sum())} active), "
          f"inliers {[int(x) for x in inl[:2]]}…, masks/μ/d² equal, W rel "
          f"{w_err:.2e} (tol 2e-3), H scaled {h_err:.2e}, b scaled {b_err:.2e} "
          "(tol 5e-4), inactive lanes zero")
    check(w_err <= 2e-3, f"K7 W differs by {w_err}")
    check(h_err <= 5e-4 and b_err <= 5e-4, "K7 H/b differ")
    act = [u for u, a in zip(uid_list, active.tolist()) if a]
    # Valid target rows once per active lane; every source row of every lane
    # read (qtab) and written (corr); the [B, blocks, 44] partials.
    ops = sum(9.0 * n_u[u] * m_u[u] + 400.0 * n_u[u] for u in act)
    nbytes = (sum(64.0 * m_u[u] for u in act) + 64.0 * len(act) * cap
              + 64.0 * B * cap + 4.0 * 44 * B * ((cap + 63) // 64))
    n_max, m_max = max(n_u), max(m_u)
    a_idx = active.nonzero()[:, 0]
    tq = (sources.points[uids[a_idx].long(), :n_max, :3]
          @ Ts[a_idx, :3, :3].transpose(1, 2) + Ts[a_idx, None, :3, 3])
    tt = targets.points[uids[a_idx].long(), :m_max, :3].contiguous()

    def lib_k7():
        # cdist + min over four lanes at a time: the whole batch's distance
        # matrix would not fit the card.
        for s in range(0, tq.shape[0], 4):
            torch.cdist(tq[s:s + 4], tt[s:s + 4]).min(dim=-1)

    records["gicp_linearize_fleet"] = dict(
        max_abs_err=(H - Hp).abs().max().item(),
        ms=time_ms(lambda: gicp_linearize_fleet(tables, uids, Ts, MAX_DIST_SQ, active)),
        plain_ms=time_ms(lambda: gicp_linearize_fleet_plain(
            tables, uids, Ts, MAX_DIST_SQ, active), reps=3),
        library_ms=time_ms(lib_k7, reps=3),
        pairs=sum(n_u[u] * m_u[u] for u in act), bound=bound(ops, nbytes))

    # K8 at each lane's pose plus its 10 LM trial poses.
    lambdas = 1e-3 * 10.0 ** torch.arange(10, dtype=f32, device=dev)
    deltas = solve6x6(H.float()[:, None], -b.float()[:, None], lambdas.expand(B, 10))
    all_Ts = torch.cat([Ts[:, None], Ts[:, None] @ se3_exp(deltas)], dim=1)
    e = gicp_error_multi_fleet(corr, tables, uids, all_Ts)
    ep = gicp_error_multi_fleet_plain(corr, tables, uids, all_Ts)
    check(bool(torch.isfinite(e).all()), "K8 errors not finite")
    check(bool(torch.all(e[idle] == 0)), "K8 errors of inactive lanes are not zero")
    rel = ((e - ep).abs() / ep.abs().clamp(min=1e-30)).max().item()
    err = (e - ep).abs().max().item()
    print(f"K8 gicp_error_multi_fleet: {B} lanes × {all_Ts.shape[1]} poses, "
          f"max |Δe| {err:.3e}, rel {rel:.2e} (tol 1e-5)")
    check(rel <= 1e-5, f"K8 errors differ by rel {rel}")
    k1 = all_Ts.shape[1]
    ops = sum(40.0 * n_u[u] * k1 for u in act)
    nbytes = sum(80.0 * n_u[u] for u in act) + 48.0 * B * k1
    records["gicp_error_multi_fleet"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: gicp_error_multi_fleet(corr, tables, uids, all_Ts)),
        plain_ms=time_ms(lambda: gicp_error_multi_fleet_plain(corr, tables, uids,
                                                              all_Ts)),
        library_ms=None, pairs=sum(n_u[u] for u in act) * k1,
        bound=bound(ops, nbytes))

    # End to end: `problems` noisy starts, pairs alternating, through B lanes.
    P = problems
    pair_ids = np.arange(P) % len(gts)
    inits = np.stack([noisy_guess(gts[u], rng) for u in pair_ids]).astype(np.float32)
    for _, _, _, fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = align_fleet(None, None, inits, pair_ids=pair_ids, num_lanes=B,
                      prepared=tables)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: KERNELS[name][3].launches for name in FLEET_KERNELS}
    r = result_to_numpy(res)
    check(all(v > 0 for v in launches.values()), "a fleet kernel was not launched")
    check(bool(np.isfinite(r["T_target_source"]).all()), "non-finite fleet pose")
    rot, trans = pose_errors(r["T_target_source"], np.stack([gts[u] for u in pair_ids]))
    iters = r["iterations"]
    fleet_reg_per_s = P / dt
    print(f"fleet registrations/s: {fleet_reg_per_s:.3f} ({P} problems through {B} "
          f"lanes in {launches['gicp_linearize_fleet']} rounds, {dt:.3f} s, "
          f"iterations mean {iters.mean() + 1:.2f} max {iters.max() + 1}, "
          f"converged {int(r['converged'].sum())}/{P}; single-pair align "
          f"registrations/s {align_reg_per_s:.3f} in phase 5) on {card}")
    print(f"launches in the fleet run: {launches}")
    print(f"pose error vs ground truth: max {rot.max():.4f} deg, {trans.max():.4f} m "
          "(bounds 2.5 deg, 0.2 m)")

    def impl(p):
        u = int(pair_ids[p])
        return align_impl(clouds[u], clouds[u + 1], None, inits[p])

    outside = [p for p in range(P) if not (rot[p] < 2.5 and trans[p] < 0.2)]
    for p in outside:
        check(_agrees((r["T_target_source"][p], int(iters[p])), impl(p)),
              f"fleet problem {p} left the bounds and disagrees with align_impl")
    sample = rng.choice(P, size=min(16, P), replace=False)
    for p in sample:
        check(_agrees((r["T_target_source"][p], int(iters[p])), impl(p)),
              f"fleet problem {p} disagrees with align_impl")
    print(f"{len(outside)} problems outside the bounds, each in agreement with "
          f"align_impl; {len(sample)} sampled rows agree with align_impl")

    # Lane-count invariance on the card.
    few = min(8, P)
    one, many = (result_to_numpy(align_fleet(
        None, None, inits[:few], pair_ids=pair_ids[:few], num_lanes=nl,
        prepared=tables)) for nl in (1, B))
    d_pose = np.abs(one["T_target_source"] - many["T_target_source"]).max()
    print(f"lane-count invariance over {few} problems: B=1 vs B={B} iterations "
          f"{one['iterations'].tolist()} vs {many['iterations'].tolist()}, max "
          f"|ΔT| {d_pose:.2e}")
    check(np.array_equal(one["iterations"], many["iterations"])
          and np.array_equal(one["converged"], many["converged"]) and d_pose <= 1e-6,
          "fleet results depend on the lane count")

    # Device busy share over a quarter of the queue, from a torch.profiler
    # trace (its own overhead lengthens the wall time a little).
    from torch.profiler import ProfilerActivity, profile

    q = max(1, P // 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        align_fleet(None, None, inits[:q], pair_ids=pair_ids[:q], num_lanes=B,
                    prepared=tables)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events)
    check(busy_us > 0, "the profiler saw no device time")
    print(f"profiled fleet of {q} problems: device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({100 * busy_us / wall_us:.1f}% busy); "
          f"{sum(e.count for e in events if e.key == 'cudaLaunchKernel')} kernel "
          f"launches; top device time on {card}:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    return records, launches


def search_bound(nq: int, m: int, k: int, pairs=None):
    """Bound of an exact k-nearest search: 9 operations a pair over
    ``pairs`` (brute force: all nq·m); every query and valid target row
    read once, (d², index) written."""
    pairs = nq * m if pairs is None else pairs
    return bound(9.0 * pairs, 16.0 * (nq + m) + 8.0 * k * nq)


def pruned_pairs(target, queries, query, d_k, m: int) -> int:
    """Pairs the pruned search cannot avoid on this data: for every block of
    64 Morton-sorted queries, the rows of the tiles whose box lies within
    the block's true kth distance (the largest over its queries, ``d_k``
    [Q] in query order) of the block's query box. The kernel scans at least
    these; with a bound looser than the true one it scans more."""
    dev = query.device
    nq = query.shape[0]
    nb = (nq + BLOCK_QUERIES - 1) // BLOCK_QUERIES
    ntiles = (m + TILE_ROWS - 1) // TILE_ROWS
    order = queries.qperm.long()
    pad = nb * BLOCK_QUERIES - nq
    qs = torch.cat([query[order, :3], query[order[-1:], :3].expand(pad, 3)])
    qs = qs.view(nb, BLOCK_QUERIES, 3)
    lo, hi = qs.amin(dim=1), qs.amax(dim=1)
    reach = torch.cat([d_k[order], d_k.new_zeros(pad)]).view(nb, BLOCK_QUERIES).amax(1)
    box = target.tbox[:ntiles]
    gap = torch.clamp(torch.maximum(box[None, :, 0:3] - hi[:, None],
                                    lo[:, None] - box[None, :, 4:7]), min=0.0)
    needed = (gap * gap).sum(dim=-1) <= reach[:, None]  # [nb, ntiles]
    rows = torch.clamp(m - TILE_ROWS * torch.arange(ntiles, device=dev),
                       max=TILE_ROWS).double()
    in_block = torch.clamp(nq - BLOCK_QUERIES * torch.arange(nb, device=dev),
                           max=BLOCK_QUERIES).double()
    return int((needed.double() @ rows * in_block).sum().item())


def phase_search(scans, T_gt, rng, dev, card):
    """K9-K12 against their plain versions, then the neighbour-search path."""
    print("== phase 7: search", flush=True)
    target, tree = preprocess_points(scans[0], LEAF, num_neighbors=K_NEIGHBORS,
                                     device=dev)
    source, _ = preprocess_points(scans[1], LEAF, num_neighbors=K_NEIGHBORS,
                                  device=dev)
    m, n = int(target.num_points), int(source.num_points)
    tpts, tnum = target.points, target.num_points
    records = {}

    # K9 at the registration shape: T·source against the downsampled target.
    T = torch.as_tensor(noisy_guess(T_gt, rng), dtype=torch.float32, device=dev)
    q = (source.points @ T.T)[:n, :3]  # a [n,3] view of [n,4] rows
    dv, iv = nearest_neighbor(tpts, tnum, q, "vpu")
    dvp, ivp = nearest_neighbor_plain(tpts, tnum, q, "vpu")
    check(torch.equal(iv, ivp) and torch.equal(dv, dvp),
          "K9 (vpu) differs from its plain version")
    dm, im = nearest_neighbor(tpts, tnum, q, "mxu")
    dmp, imp = nearest_neighbor_plain(tpts, tnum, q, "mxu")
    check(torch.equal(im, imp) and torch.equal(dm, dmp),
          "K9 (mxu) differs from its plain version")
    # Score form against difference form. The score |t|² − 2 q·t of a row
    # carries a rounding error of up to 2·2⁻²³·(|q| + |t|)² in the centred
    # frame, so between two rows it may prefer the one whose true d² is larger
    # by twice that. Each query gets that tolerance from its own reach and
    # its winners' (the farther of the two variants' rows): the winners' d²
    # agree within it, and the rows are equal wherever the runner-up (K10,
    # k = 2) is farther than it.
    centre = tree.centre()
    q_reach = (q - centre).norm(dim=1)
    t_reach = torch.maximum((tpts[iv.long(), :3] - centre).norm(dim=1),
                            (tpts[im.long(), :3] - centre).norm(dim=1))
    tol = 4.0 * 2.0 ** -23 * (q_reach + t_reach) ** 2  # [n]
    d2nd, _ = knn(tpts, tnum, q, 2)
    clear = d2nd[:, 1] - d2nd[:, 0] > tol
    delta = (dm - dv).abs()
    worst = int((delta / tol).argmax())
    check(bool((delta <= tol).all()),
          f"K9 mxu d² differs from vpu d² by {delta[worst].item()} at query {worst} "
          f"(tolerance {tol[worst].item()})")
    check(torch.equal(iv[clear], im[clear]), "K9 variants pick different rows")
    clear_share = clear.float().mean().item()
    check(clear_share >= 0.9, f"only {clear_share:.3f} of the queries have a clear "
          "runner-up: the row comparison covers too few")
    print(f"K9 score-form tolerance per query 4·2⁻²³·(|q−c|+|t−c|)²: median "
          f"{tol.median().item():.3e}, max {tol.max().item():.3e}; largest "
          f"|Δd²|/tolerance {(delta / tol).max().item():.3f}")
    print(f"K9 nearest_neighbor: {n} queries × {m} rows; vpu and mxu equal to their "
          f"plain versions (d², idx); mxu vs vpu max |Δd²| {delta.max().item():.3e}, "
          f"rows equal on {int(clear.sum())} queries with a clear runner-up "
          f"({100 * clear_share:.1f} %), {int((iv != im).sum())} differ in all")
    tt = tpts[:m, :3].contiguous()
    qc = q.contiguous()
    # The launch alone (the centre given, as KdTree gives it) is the kernel's
    # time; the wrapper without a centre adds the torch ops that compute it.
    mxu_ms = time_ms(lambda: nearest_neighbor(tpts, tnum, q, "mxu", centre))
    whole_ms = time_ms(lambda: nearest_neighbor(tpts, tnum, q, "vpu"))
    records["nearest_neighbor"] = dict(
        max_abs_err=(dv - dvp).abs().max().item(),
        ms=time_ms(lambda: nearest_neighbor(tpts, tnum, q, "vpu", centre)),
        plain_ms=time_ms(lambda: nearest_neighbor_plain(tpts, tnum, q, "vpu"), reps=3),
        library_ms=time_ms(lambda: torch.cdist(qc, tt).min(dim=1), reps=3),
        pairs=n * m, bound=search_bound(n, m, 1))
    print(f"K9 launch alone: vpu {records['nearest_neighbor']['ms']:.4f} ms, mxu "
          f"{mxu_ms:.4f} ms; whole wrapper (centre computed per call) vpu "
          f"{whole_ms:.4f} ms on {card}")

    # K10, K11, K12 at the covariance shape: self-kNN of the downsampled target.
    qs = tpts[:m, :3]
    searches = (("knn", knn), ("knn_T", knn_T), ("knn_pruned", knn_pruned))
    results, errs = {}, {}
    for k in (K_NEIGHBORS, 20):
        ref = knn_plain(tpts, tnum, qs, k)
        pruned_ref = knn_pruned_plain(tpts, tnum, qs, k)
        check(torch.equal(ref[0], pruned_ref[0]) and torch.equal(ref[1], pruned_ref[1]),
              f"the plain versions of K10 and K12 differ at k={k}")
        for name, fn in searches:
            d, i = fn(tpts, tnum, qs, k)
            check(torch.equal(d, ref[0]) and torch.equal(i, ref[1]),
                  f"{name} differs from its plain version at k={k}")
            errs[name] = (d - ref[0]).abs().max().item()
            results[name, k] = time_ms(lambda: fn(tpts, tnum, qs, k))
        print(f"K10/K11/K12 at {m} × {m}, k={k}: (d², idx) equal to the plain "
              f"versions and to each other; ms "
              f"{ {name: round(results[name, k], 4) for name, _ in searches} }")
    k = K_NEIGHBORS
    lib_ms = time_ms(lambda: torch.topk(torch.cdist(tt, tt), k, largest=False), reps=3)
    plain_ms = time_ms(lambda: knn_plain(tpts, tnum, qs, k), reps=3)
    for name, _ in searches:
        records[name] = dict(
            max_abs_err=errs[name], ms=results[name, k], plain_ms=plain_ms,
            library_ms=lib_ms, pairs=m * m, bound=search_bound(m, m, k))
    # K12's record is the launch alone over a finished prologue, against the
    # pairs this data leaves a pruned search; the wrapper's times (with the
    # target half kept, as KdTree keeps it, and whole) stand beside it.
    ptgt = tree.pruned_target()
    pqry = pruned_prepare_queries(ptgt, qs)
    d12, i12 = knn_pruned_launch(ptgt, tnum, qs, pqry, k)
    ref = knn_plain(tpts, tnum, qs, k)
    check(torch.equal(d12, ref[0]) and torch.equal(i12, ref[1]),
          "K12's launch over kept tables differs from the plain version")
    need = pruned_pairs(ptgt, pqry, qs, d12[:, k - 1], m)
    pruned_ms = {
        "launch": time_ms(lambda: knn_pruned_launch(ptgt, tnum, qs, pqry, k)),
        "kept": time_ms(lambda: knn_pruned(tpts, tnum, qs, k, target=ptgt)),
        "whole": results["knn_pruned", k],
        "target": time_ms(lambda: pruned_prepare_target(tpts, tnum)),
        "queries": time_ms(lambda: pruned_prepare_queries(ptgt, qs)),
    }
    records["knn_pruned"].update(
        ms=pruned_ms["launch"], pairs=need, bound=search_bound(m, m, k, need),
        plain_ms=time_ms(lambda: knn_pruned_plain(tpts, tnum, qs, k), reps=3))
    print(f"K12 at {m} × {m}, k={k}: launch alone {pruned_ms['launch']:.4f} ms over "
          f"{need} needed pairs ({100 * need / (m * m):.2f} % of Q·M); wrapper with "
          f"the target half kept {pruned_ms['kept']:.4f} ms, whole "
          f"{pruned_ms['whole']:.4f} ms; prologue alone: target half "
          f"{pruned_ms['target']:.4f} ms, query half {pruned_ms['queries']:.4f} ms "
          f"on {card}")

    # K10 against K11 by query count (k = 10, the first Q rows as queries).
    for nq in (1, 64, 4096, m):
        sub = qs[:nq]
        t10 = time_ms(lambda: knn(tpts, tnum, sub, k))
        t11 = time_ms(lambda: knn_T(tpts, tnum, sub, k))
        print(f"K10 vs K11 at Q={nq}, M={m}, k={k}: knn {t10:.4f} ms, knn_T "
              f"{t11:.4f} ms ({'knn_T' if t11 < t10 else 'knn'} wins) on {card}")

    # Raw-scan scale: the whole first frame against itself, k = 20.
    raw = PointCloud.from_points(scans[0], device=dev)
    rpts, rnum, nr = raw.points, raw.num_points, len(scans[0])
    rq = rpts[:, :3]
    d10, i10 = knn(rpts, rnum, rq, 20)
    d12, i12 = knn_pruned(rpts, rnum, rq, 20)
    check(torch.equal(d10, d12) and torch.equal(i10, i12),
          "K12 differs from K10 at raw-scan scale")
    pick = torch.as_tensor(np.sort(rng.choice(nr, size=min(8192, nr), replace=False)), device=dev)
    dp, ip = knn_plain(rpts, rnum, rq[pick].contiguous(), 20)
    check(torch.equal(d10[pick], dp) and torch.equal(i10[pick], ip),
          "K10 differs from its plain version at raw-scan scale")
    d11, i11 = knn_T(rpts, rnum, rq, 20)
    check(torch.equal(d10, d11) and torch.equal(i10, i11),
          "K11 differs from K10 at raw-scan scale")
    raw_ms = {name: time_ms(lambda: fn(rpts, rnum, rq, 20), reps=3)
              for name, fn in searches}
    raw_tree = KdTree(points=rpts, num_points=rnum)
    rtgt = raw_tree.pruned_target()
    rqry = pruned_prepare_queries(rtgt, rq)
    need = pruned_pairs(rtgt, rqry, rq, d12[:, 19], nr)
    raw_ms["launch"] = time_ms(lambda: knn_pruned_launch(rtgt, rnum, rq, rqry, 20),
                               reps=3)
    raw_ms["kept"] = time_ms(lambda: knn_pruned(rpts, rnum, rq, 20, target=rtgt), reps=3)
    b_ms, b_by = search_bound(nr, nr, 20)
    p_ms, p_by = search_bound(nr, nr, 20, need)
    print(f"raw-scan scale, {nr} × {nr}, k=20: K11 and K12 equal to K10, K10 equal "
          f"to its plain version on {len(pick)} sampled queries; knn "
          f"{raw_ms['knn']:.3f} ms, knn_T {raw_ms['knn_T']:.3f} ms (bound "
          f"{b_ms:.4f} ms by {b_by}); knn_pruned launch alone "
          f"{raw_ms['launch']:.3f} ms, with the target half kept "
          f"{raw_ms['kept']:.3f} ms, whole {raw_ms['knn_pruned']:.3f} ms over {need} "
          f"needed pairs, {100 * need / (nr * nr):.2f} % of Q·M (bound {p_ms:.4f} ms "
          f"by {p_by}) on {card}")

    # The neighbour-search path, counted from zero.
    for _, _, _, fn in KERNELS.values():
        fn.launches = 0
    d, i = tree.nearest_neighbor_search(q)
    check(torch.equal(i, iv) and torch.equal(d, dv), "KdTree 1-NN differs from K9")
    d, i = tree.knn_search(qs, 20)
    check(bool(torch.isfinite(d).all()) and torch.equal(i[:, 0].long(),
                                                        torch.arange(m, device=dev)),
          "KdTree self-kNN does not find each point first")
    d1, i1 = tree.knn_search(qs[7], 20)
    check(d1.shape == (20,) and torch.equal(i1, i[7]), "single-query kNN differs")
    dT, iT = knn_T(tpts, tnum, qs[:64], 20)
    check(torch.equal(iT, i[:64]) and torch.equal(dT, d[:64]), "knn_T differs from knn")
    dP, iP = knn_pruned(rpts, rnum, rq, 20, target=raw_tree.pruned_target())
    check(torch.equal(iP, i10) and torch.equal(dP, d10), "knn_pruned differs from knn")

    init = noisy_guess(T_gt, rng)
    res = align_impl(target, source, tree, init, use_fused="never")
    torch.cuda.synchronize()
    r = result_to_numpy(res)
    rot, trans = pose_error(r["T_target_source"], T_gt)
    counts = {name: KERNELS[name][3].launches for name in KERNELS}
    print(f"unfused align: iterations {r['iterations']} converged {r['converged']} "
          f"inliers {r['num_inliers']}; pose error {rot:.4f} deg, {trans:.4f} m "
          "(bounds 2.5 deg, 0.2 m)")
    check(np.isfinite(r["T_target_source"]).all(), "non-finite unfused pose")
    check(rot < 2.5 and trans < 0.2, "unfused registration outside the bounds")
    check(counts["nearest_neighbor"] == 1 + r["iterations"] + 1,
          f"K9 launches {counts['nearest_neighbor']} != 1 + iterations + 1")
    check(counts["gicp_linearize"] == 0 and counts["gicp_error_multi"] == 0,
          "the unfused route launched a fused kernel")
    fused = align_impl(target, source, tree, init)
    check(_agrees((r["T_target_source"], r["iterations"]), fused),
          "unfused and fused align disagree")
    for fn in (gicp_linearize_tables, gicp_error_multi):
        fn.launches = 0  # the fused comparison is not part of this path
    n_regs = 5
    per_reg = {}
    for mode in ("never", "auto"):
        inits = [noisy_guess(T_gt, rng) for _ in range(n_regs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in inits:
            out = align_impl(target, source, tree, g, use_fused=mode)
            rot, trans = pose_error(out.T_target_source.cpu().numpy(), T_gt)
            check(rot < 2.5 and trans < 0.2,
                  f"a timed {mode} registration left the bounds")
        torch.cuda.synchronize()
        per_reg[mode] = (time.perf_counter() - t0) * 1e3 / n_regs
        if mode == "never":
            for fn in (gicp_linearize_tables, gicp_error_multi):
                check(fn.launches == 0, "the unfused route launched a fused kernel")
    print(f"time per registration: unfused {per_reg['never']:.2f} ms, fused "
          f"{per_reg['auto']:.2f} ms ({n_regs} aligns each) on {card}")

    check(kdtree_benchmark.main([]) == 0, "kdtree_benchmark failed")
    launches = {name: KERNELS[name][3].launches for name in SEARCH_KERNELS}
    print(f"launches on the search path: {launches}")
    check(all(v > 0 for v in launches.values()), "a search kernel was not launched")
    return records, launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    print("== phase 1: device", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32: "
          f"matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")

    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"built {sorted(took)} in {time.perf_counter() - t0:.1f} s "
          f"(per library: { {k: round(v, 1) for k, v in took.items()} })")
    for name in _build.SIGNATURES:
        _build.library(name)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    print("== phase 3: data", flush=True)
    t0 = time.perf_counter()
    # Frames 0-1 drive phases 4-5; all three drive the fleet's two pairs.
    scans, poses = generate_sequence(n_frames=3, rings=64, azimuth_steps=1800)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    print(f"frames of {[len(s) for s in scans]} points in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(args.seed)

    records = phase_kernels(scans[:2], T_gt, rng, dev)
    launches, reg_per_s = phase_e2e(scans[:2], T_gt, rng, dev, card, records)
    fleet_records, fleet_launches = phase_fleet(scans, poses, rng, dev, card,
                                                reg_per_s)
    records.update(fleet_records)
    launches.update(fleet_launches)
    search_records, search_launches = phase_search(scans[:2], T_gt, rng, dev, card)
    records.update(search_records)
    launches.update(search_launches)

    out = []
    for name, (tag, source, replaces, _) in KERNELS.items():
        rec = records[name]
        b_ms, b_by = rec["bound"]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": rec["library_ms"],
        })
        print(f"{tag} {name}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
              f"library {rec['library_ms']}, bound {b_ms:.4f} by {b_by}, "
              f"{rec['pairs']} pairs) on {card}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
