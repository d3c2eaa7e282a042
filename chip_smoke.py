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
                versions; K2 is the LM step kernel (the λ-trial solves,
                se3_exp, the trial errors and the accept in one launch),
                checked at the first iteration's sums and corr in LM,
                float64-solve, Huber, DoF-mask and GN modes (trials within
                1e-6, errors within 1e-5 relative, the accept equal outside
                the 1e-5 band), its errors-only mode against the plain
                version and K2's first form, each timed alone and in turns
                with the body it replaced; K3 (k = 10, 20, on the scan and on a
                duplicate-heavy grid) equal to its first form (the
                brute-force scan it replaced) on every row, K1 against its
                first form, its split
                plain account, at a radius of inf and with the source in row
                order; each timed alone (the profiler) and in turns with its
                first form, bounded by the pairs its box walk cannot avoid;
  5. e2e      — preprocess_points on both frames, then GICP/LM align within
                2.5° / 0.2 m of ground truth, with K3 launched once a cloud
                and K1 and the step kernel once a linearization (the launch
                counters); K1's wrapper host time with and without its
                per-call checks; the voxelgrid's means with the float64
                prefix sum along the last dim of the [4,N] transpose within
                one float32 ulp of its first form's (dim 0 of [N,4]);
                preprocessing per frame pair (also in turns with that first
                form, and profiled with it) and
                registrations/s over noisy initial guesses, each in turns
                with the same path through K3's, K1's and K2's first forms
                and the LM iteration's torch body (first_forms_scan); device
                launches, copies and memsets per LM iteration (at most 4)
                and the card's busy share over three profiled aligns each
                way; the card path against the plain CPU path
                on a small pair;
  6. fleet    — three frames preprocessed at one capacity (two pairs); K7
                (box-pruned) and K8 at 32 lanes against their plain versions,
                K7 against the brute-force lane kernel it replaced and K8
                against K2's lane kernel, each pair timed in turns (CUDA
                events around one wrapper call, and the kernel alone from
                the profiler's device time over 20 calls), K7 bounded by the
                pairs the box cull cannot avoid; align_fleet over 512 noisy
                problems through 32 lanes, every problem within the bounds
                or in agreement with align_impl, sampled rows against
                align_impl, lane-count invariance, fleet registrations/s and
                the card's busy share;
  7. search   — K9 (both variants) at the registration shape and K10, K11,
                K12 at the covariance shape (k = 10, 20) and at raw-scan
                scale (≈108k × 108k, k = 20) against their plain versions
                and each other; K9, K10 and K11 also against their first
                forms (the original ports) at Q = 1, 64, 4096 and all rows, k =
                10, 20, 64, on the scan and on a duplicate-heavy grid, with
                one launch a call (counters and profiler); K10 and K11 timed
                alone (the profiler) and in turns with both first forms by
                query count and at raw-scan scale, K9 in turns with its first
                form; K9's launch timed apart from its wrapper's prologue;
                K12 over the KdTree's kept sort against its plain version
                and its first form (the original port) at 21k × 21k (k = 10,
                20) and at raw-scan scale (k = 20), one launch a call, timed
                alone and in turns with its first form, bounded by the pairs
                its walk cannot avoid, with both halves of its prologue
                (time, and the query half's launches against its first form's);
                then the neighbour-search path with
                the counts at 0: KdTree searches, knn_T, knn_pruned, the
                unfused align_impl (within the bounds, in agreement with the
                fused one, K9 and the step kernel once per linearization and
                no K1) and the
                kdtree_benchmark CLI in process, which then runs again
                through the first forms and once more through the new ones;
  8. map      — 17 frames: two submaps of 8 raw frames each in the world
                frame (≈864k rows) and their union, the map (≈1.73 M rows).
                K4 on both submaps against its first form (the original port)
                on every row (k = 10, 20) and its plain version on 8,192
                sampled rows of each, and against K3 forced; K5 over the
                cloud's kept sort at the scan shape and at raw-scan scale (k
                = 10, 20) against its plain version, and bit for bit against
                K3, its first form (the original port) and itself with the sort
                made in the call, one launch a call, timed alone and in turns
                with K3 and the first form, bounded by the pairs its walk
                cannot avoid; K6 on the map and at the scan shape against its
                first form (corr and float64 sums), its split plain account
                at the planned chunk count, at one chunk and above the live
                tiles, its plain version and K1 forced on the same tables,
                with the share of (block, tile) pairs it skips; one launch a
                call for K4 and K6 (counters and profiler), each timed alone
                (the profiler) and in turns with its first form; K1's score
                form (the box walk) at the scan shape against its plain
                account, its brute-force plain version and its first form
                (the original port) on the rows where the score's rounding
                cannot change the winner's acceptance, and against the
                difference form, one launch a call, timed alone and in
                turns with its first form; then,
                with the counts at 0, the map-scale path: covariances of both
                submaps (K4), the align of frame 16 against the map (K6 and
                the step kernel per linearization, K1 never) within 2.5° /
                0.2 m, a layout "q" call over the scan's kept sort (K5) and a
                score-form linearization; the covariances and the align with
                the map's sort kept timed in turns with the same path through
                the first forms;
  9. voxels   — the 17 frames preprocessed (0.25 m, k = 10). VGICP on the
                scan pair against create_gaussian_voxelmap(target, 1.0) from
                noisy starts, within 2.5° / 0.2 m, the step kernel once an LM
                iteration (counter and profiler) and the plain step never;
                registrations/s in turns with phase 5's GICP align; launches,
                copies and host syncs per LM iteration and the busy share.
                Then a Gaussian map (131,072 slots) and
                IncrementalVoxelMapCov(1.0, 131072, voxel_capacity=32768)
                (cell cap 10, LRU 100/10) take frames 0-15 at their poses:
                ms per insert (CUDA events), launches per insert and host
                syncs per insert (0: torch's sync debug mode raises on any,
                and the profiler counts none); knn_search of frame 16 at k =
                1 and 10 and the Gaussian nearest_neighbor_search, timed, no
                host sync; VGICP of frame 16 against the Gaussian map and GICP
                against ivm_as_cloud through the fused route (K1 and the
                step), each within 2.5° / 0.2 m, timed and profiled; frame 16
                inserted last. Every insert and search is held against the
                same port functions on CPU tensors: keys, slots, occupancy,
                stamps, counts and rows equal, payload rows and d² within 1e-6
                relative;
 10. odometry — the 17 frames at OdometryParams() (131,072 raw and 32,768
                downsampled rows, a map of 131,072 rows, k = 20, 0.25 m,
                1.0 m voxels and rejector; the voxel-search model engines
                with num_offsets=7): JitOdometry("gicp_model_fused",
                chunk_frames=8) from preload / feed_preloaded (7 padded
                frames in the last chunk) with the counts at 0 — K3 once a
                frame, K1 and the step kernel once an LM iteration, no
                other kernel —, chunk wall times, one chunk and frame 16
                profiled (launches, copies, memsets, host syncs: as many as
                LM iterations, the stop-flag reads; busy share),
                preprocessing's share of a frame; every other chunked engine
                (K1 on the fused route and the step kernel once an LM
                iteration, K3 once a frame but for icp_scan; frame 16's host
                syncs by torch's sync debug mode) and every
                streaming engine (create_odometry(...).estimate, report());
                each GICP, VGICP and point-to-plane trajectory within 2.5° /
                0.2 m a frame and an APE under 0.2 m, point-to-point ICP
                printed unbounded (small_gicp_projective: phase 11);
                gicp_model_fused and small_gicp_model on
                the card against the plain CPU path on a 4-frame 16 × 256
                sequence (poses within 1e-3, equal voxel counts); the
                odometry_benchmark CLI in its own process on the 17 frames
                written as KITTI .bin scans (exit 0, 17 trajectory lines);
 11. the rest of odometry — at OdometryParams() on the 17 frames:
                knn_windowed (k = 20, 0.25 m cell) on frame 0 downsampled,
                set recall ≥ 0.97 against K10's exact lists, timed in turns
                with K3; KdTree.knn_search(method="window") of frame 1's raw
                points moved into frame 0 (k = 10), recall ≥ 0.97 against
                K10, timed in turns with the exact search;
                voxelgrid_sampling_with_covs of frame 0 on the card against
                the CPU (voxel counts equal, means within 1e-5 m,
                covariances within 1e-3 where the raw covariance's two
                smallest eigenvalues are more than 1e-3 m² apart), timed in turns with
                voxelgrid + K3 covariances; ProjectiveSearch over frame 0, NN
                of frame 1 moved: found share and agreement with K9 held to
                the JAX searcher's figures on the CPU
                (tools/projective_figures.py) less 0.03, card and CPU index
                images equal; JitOdometry("gicp_model_fused" / "gicp_model")
                in the "voxel" and "knn_window" modes in turns with "knn"
                (phase 10's bounds, the pose difference against "knn", ms a
                frame, launches — K1 and the step once an LM iteration, K3
                only in "knn" —, and gicp_model_fused's profiled chunk:
                launches a frame and busy share);
                small_gicp_projective streaming (K3 once a frame, the step,
                no K1 or K9; errors printed) and through the CLI in its own
                process (17 lines); the card against the CPU path on the
                small sequence (within 1e-3); BatchOdometry of four worlds
                (32 × 900 rays, 3/3/3/2 frames) for gicp_model and gicp_scan,
                each lane against JitOdometry alone (rtol 1e-5 / atol 1e-6),
                the padded tail, frames/s across lanes;
 12. scale-out — frames 0-8 at one capacity; every mode of parallel/ at
                world size 1 over NCCL in this process, against its
                unsharded call on the same inputs and timed in turns with
                it: align_batch of 4 pairs equal to the per-pair aligns bit
                for bit (K1 and the step once an LM iteration);
                align_point_sharded within 1e-5 of the unsharded unfused
                align with equal inliers (K9 and the step kernel's
                errors-only mode once an iteration, K1 and the step never;
                host syncs counted); both voxel maps over frames 0-7 sharded,
                frame 8's search equal bit for bit (slots too), VGICP against
                the sharded Gaussian map within 2 × translation_eps (the step
                once an iteration); align_fleet_sharded of 64 problems equal
                to align_fleet row for row (K7, K8); BatchOdometry(2,
                "gicp_scan", mesh=) equal to the unsharded batch (K1, K3,
                the step); then the same checks on two gloo ranks sharing
                the card, each a process of this script (--scale-rank), at
                smaller sizes (fleet rows within phase 6's lane-count
                invariance, slots equal but on ties);
 13. the rest of the API — at OdometryParams() on frames 0-7:
                JitOdometry("gicp_model_fused", chunk_frames=4) run
                continuously and as 4 frames, save_pytree of the carry, a
                fresh engine's load_pytree and 4 more, and the same for the
                streaming small_gicp_model through save_odometry_state /
                load_odometry_state: poses, T_world and every map tensor
                equal bit for bit, a wrong-capacity engine refused with
                ValueError, K1, K3 and the step kernel launched;
                dump_synthetic_kitti writes 8 frames, the native library
                builds (native_available()), its read_kitti_bin equals
                numpy's bit for bit, and the odometry_benchmark CLI in
                process over them through DatasetLoader stays within 2.5° /
                0.2 m of gt.txt frame to frame; RegistrationTPU GICP and
                VGICP on phase 5's pair (0.25 m, k = 10) from three noisy
                starts each within 2.5° / 0.2 m, K3 twice (once a cloud, on
                the lazy covariances) and then never, K1 (GICP) and the step
                kernel once an LM iteration, and after swapSourceAndTarget
                a second align within the bounds with no K3 launch and no
                tree build, timed by StageTimer; GICPFactor().linearize at
                the ground-truth pose summed over points within 1e-5
                (relative to the largest entry) of the unfused route's H
                and b, K9 once; generate_sequence_device (4 frames, 64 ×
                1800) on the card against the host generator's statistics
                (returns a frame within 3 %, range histogram and ground
                share within 0.02, poses equal) and
                synthetic_odometry_benchmark in process over 24 frames
                ("gicp_model_fused": K1, K3, the step) with an APE under
                0.2 m; trace() of one align writes a Chrome trace with the
                step kernel's events.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from small_gicp_tpu_torch import _build, interop, native
from small_gicp_tpu_torch.apps import (
    dump_synthetic_kitti,
    kdtree_benchmark,
    odometry_benchmark,
    synthetic_odometry_benchmark,
)
from small_gicp_tpu_torch.interop import RegistrationTPU, result_to_numpy
from small_gicp_tpu_torch.models import factors, odometry_scan, registration, voxelmap
from small_gicp_tpu_torch.models.factors import GICPFactor
from small_gicp_tpu_torch.models.helper import (
    align,
    create_gaussian_voxelmap,
    preprocess_points,
)
from small_gicp_tpu_torch.models.odometry import ENGINES, OdometryParams, create_odometry
from small_gicp_tpu_torch.models.odometry_scan import BatchOdometry, JitOdometry
from small_gicp_tpu_torch.models.voxelmap import (
    GaussianVoxelMap,
    IncrementalVoxelMapCov,
    ivm_as_cloud,
)
from small_gicp_tpu_torch.ops import cov_fused_cuda, gicp_fused_cuda
from small_gicp_tpu_torch.ops.cov_fused_cuda import (
    _knn_moments_rows_q_v1,
    _knn_moments_rows_v1,
    _knn_topk_idx_v1,
    auto_layout as cov_layout,
    knn_moments,
    knn_moments_rows,
    knn_moments_rows_plain,
    knn_moments_rows_q,
    knn_moments_rows_q_plain,
    knn_topk_idx,
    knn_topk_idx_plain,
)
from small_gicp_tpu_torch.ops import downsampling
from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling
from small_gicp_tpu_torch.ops.eigh3 import solve6x6
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    _gicp_error_multi_v1,
    gicp_error_multi,
    gicp_error_multi_fleet,
    gicp_error_multi_fleet_plain,
    gicp_error_multi_plain,
    _gicp_error_multi_fleet_k2,
    _gicp_linearize_fleet_brute,
    _gicp_linearize_listed_cuda,
    _gicp_linearize_swept_cuda,
    _gicp_linearize_score_v1,
    _gicp_linearize_swept_v1,
    _gicp_linearize_v1,
    fleet_live_tiles,
    gicp_linearize_fleet,
    gicp_linearize_fleet_plain,
    gicp_linearize_listed_plain,
    gicp_linearize_score,
    gicp_linearize_score_plain,
    gicp_linearize_score_walk_plain,
    gicp_linearize_swept,
    gicp_linearize_swept_plain,
    gicp_linearize_swept_split_plain,
    gicp_linearize_sums,
    gicp_linearize_tables,
    gicp_prepare,
    linearize_buffers,
    swept_live_tiles,
    swept_plan,
)
from small_gicp_tpu_torch.models.registration import Registration, align_impl
from small_gicp_tpu_torch.ops import lm_step
from small_gicp_tpu_torch.ops.lm_step import gicp_lm_step, gicp_lm_step_plain, lm_state
from small_gicp_tpu_torch.ops import knn_cuda
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.ops.knn_cuda import (
    BLOCK_QUERIES,
    VARIANTS,
    _knn_T_v1,
    _knn_v1,
    _knn_pruned_v1,
    _nearest_neighbor_v1,
    PrunedQueries,
    knn,
    knn_plain,
    knn_pruned,
    knn_pruned_launch,
    knn_pruned_plain,
    knn_T,
    nearest_neighbor,
    nearest_neighbor_plain,
    pruned_prepare_queries,
    pruned_query_positions,
)
from small_gicp_tpu_torch.ops import knn_window
from small_gicp_tpu_torch.ops.morton_boxes import TILE_ROWS, pruned_prepare_target
from small_gicp_tpu_torch.ops.voxel_keys import INVALID_KEY
from small_gicp_tpu_torch.ops import normals
from small_gicp_tpu_torch.ops.normals import (
    estimate_covariances,
    estimate_normals_covariances,
)
from small_gicp_tpu_torch.ops.projective_search import ProjectiveSearch
from small_gicp_tpu_torch.ops.voxel_covs import (
    neighborhood_covariances,
    voxelgrid_sampling_with_covs,
)
from small_gicp_tpu_torch.parallel import multihost
from small_gicp_tpu_torch.parallel.fleet import (
    align_fleet,
    align_fleet_sharded,
    fleet_prepare,
)
from small_gicp_tpu_torch.parallel.map_sharding import (
    shard_gaussian_voxelmap,
    shard_incremental_voxelmap,
    sharded_gvm_nn,
    sharded_ivm_nn,
    sharded_model_align,
)
from small_gicp_tpu_torch.parallel.sharding import align_batch, align_point_sharded
from small_gicp_tpu_torch.point_cloud import PointCloud, stack_clouds
from small_gicp_tpu_torch.utils.checkpoint import (
    load_odometry_state,
    load_pytree,
    save_odometry_state,
    save_pytree,
)
from small_gicp_tpu_torch.utils.io import list_kitti_scans, read_kitti_bin, write_kitti_bin
from small_gicp_tpu_torch.utils.lie import rotation_error_deg, se3_exp
from small_gicp_tpu_torch.utils.metrics import ape_translation, load_kitti_trajectory
from small_gicp_tpu_torch.utils.profiling import StageTimer, trace
from small_gicp_tpu_torch.utils.synthetic import generate_sequence, generate_sequence_device

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
    "gicp_linearize": ("K1", "small_gicp_tpu_torch/csrc/gicp_listed.cu",
                       "small_gicp_tpu/ops/gicp_fused_pallas.py:466",
                       gicp_linearize_tables),
    "gicp_lm_step": ("K2", "small_gicp_tpu_torch/csrc/gicp_step.cu",
                     "small_gicp_tpu/ops/gicp_fused_pallas.py:1033", gicp_lm_step),
    "knn_moments": ("K3", "small_gicp_tpu_torch/csrc/cov_fused.cu",
                    "small_gicp_tpu/ops/cov_fused_pallas.py:171",
                    knn_moments_rows),
    "knn_topk_idx": ("K4", "small_gicp_tpu_torch/csrc/cov_fused.cu",
                     "small_gicp_tpu/ops/cov_fused_pallas.py:282", knn_topk_idx),
    "knn_moments_q": ("K5", "small_gicp_tpu_torch/csrc/cov_fused.cu",
                      "small_gicp_tpu/ops/cov_fused_pallas.py:67",
                      knn_moments_rows_q),
    "gicp_linearize_swept": ("K6", "small_gicp_tpu_torch/csrc/gicp_swept.cu",
                             "small_gicp_tpu/ops/gicp_fused_pallas.py:92",
                             gicp_linearize_swept),
    "gicp_linearize_score": ("K1 score form",
                             "small_gicp_tpu_torch/csrc/gicp_listed.cu",
                             "small_gicp_tpu/ops/gicp_fused_pallas.py:521",
                             gicp_linearize_score),
    "gicp_linearize_fleet": ("K7", "small_gicp_tpu_torch/csrc/gicp_fleet.cu",
                             "small_gicp_tpu/ops/gicp_fused_pallas.py:1312",
                             gicp_linearize_fleet),
    "gicp_error_multi_fleet": ("K8", "small_gicp_tpu_torch/csrc/gicp_fleet.cu",
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
MAIN_KERNELS = ("gicp_linearize", "gicp_lm_step", "knn_moments")
FLEET_KERNELS = ("gicp_linearize_fleet", "gicp_error_multi_fleet")
SEARCH_KERNELS = ("nearest_neighbor", "knn", "knn_T", "knn_pruned")
MAP_KERNELS = ("knn_topk_idx", "knn_moments_q", "gicp_linearize_swept",
               "gicp_linearize_score")
SUBMAP_FRAMES = 8


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, reps: int = REPS, warm: bool = True) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one run that is not timed (unless ``warm`` is False);
    ``reps=None``: 3 runs if the first timed one takes over 100 ms, else
    ``REPS``."""
    if warm:
        fn()
    torch.cuda.synchronize()
    if reps is None:
        reps = 3 if time_ms(fn, reps=1) > 100.0 else REPS
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


def time_turns(fns: dict, reps: int = REPS) -> dict:
    """{name: median ms} of each function by CUDA events around one call,
    the functions taking turns in each of ``reps`` rounds, after one
    untimed call each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: float(np.median(v)) for name, v in times.items()}


def device_events(prof) -> list:
    """The profiler's averages of work on the card (kernels, copies,
    memsets): what its own table totals as device time. A torch op's
    average carries the time of the kernels it launched as well, so a sum
    over every event counts those kernels twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def kernel_ms(fn, name: str, reps: int = REPS):
    """The kernel alone: (ms per call that the card spends in kernels whose
    name matches the regular expression ``name`` (a plain name matches
    itself), their count, {other device work: count}) over
    ``reps`` calls of ``fn`` under torch.profiler, after one untimed call.
    The ``reps`` calls are profiled after a warm-up step of as many calls
    under the profiler (the first kernel of a cold window has gone
    unrecorded). The profiler's view of so short a window came back empty
    once in seven runs: it is taken up to three times, and if it stays
    empty the ``reps`` calls are timed back to back by CUDA events (count
    None)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()  # the warm-up ends; the window holds what follows
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events:
            ours = [e for e in events if re.search(name, e.key)]
            others = {e.key[:60]: e.count for e in events if not re.search(name, e.key)}
            return (sum(e.self_device_time_total for e in ours) / 1e3 / reps,
                    sum(e.count for e in ours), others)
    print(f"the profiler saw no device work in {reps} calls ({name}), three times: "
          "timing them back to back by CUDA events")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, None, {}


def one_kernel_per_call(fn, name: str, alone: bool = True) -> float:
    """ms of the kernel alone (``kernel_ms``), after checking that the
    profiler saw exactly one kernel named ``name`` per call and, where
    ``alone``, no other device work (a wrapper whose torch ops launch kernels
    of their own passes False). A window in which the profiler lost events
    (it has returned 19, 10, and in three windows running 13, 4 and 2
    kernels for 20 calls) is taken again after a pause, up to six times."""
    for attempt in range(6):
        ms, count, others = kernel_ms(fn, name)
        if count in (None, REPS) and not (alone and others):
            return ms
        print(f"{name}: the profiler saw {count} kernels and {others} in {REPS} calls")
        torch.cuda.synchronize()
        time.sleep(1.0 + attempt)
    check(False, f"{name}: {count} kernels and {others} in {REPS} calls, six times")


def launches_per_call(wrapper, fn) -> int:
    """How many launches one call of ``fn`` adds to ``wrapper``'s count."""
    before = wrapper.launches
    fn()
    return wrapper.launches - before


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of ops over the f32 peak and bytes
    over the memory rate."""
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def issue_floor_ms(pairs: float, sms: int = 132) -> float:
    """The issue-rate floor of a search over ``pairs`` pairs: ~11
    instructions a pair (3 subtractions, 3 products, 2 sums, a compare, 2
    selects), 128 lanes a clock on each SM at 1.98 GHz (H100 SXM)."""
    return pairs * 11.0 / (128.0 * sms * 1.98e9) * 1e3


def host_turns(fns: dict, reps: int) -> dict:
    """{name: median ms} of each function by the host clock around one
    call ending in a synchronize, the functions taking turns in each of
    ``reps`` rounds, after one untimed call each."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: float(np.median(v)) for name, v in times.items()}


@contextlib.contextmanager
def first_forms_map():
    """Route K4 and K6 through their first forms (the yardsticks
    ``_knn_topk_idx_v1`` / ``_gicp_linearize_swept_v1``) inside the block."""
    saved = (cov_fused_cuda.knn_topk_idx_launch, gicp_fused_cuda._gicp_linearize_swept_cuda)
    cov_fused_cuda.knn_topk_idx_launch = _knn_topk_idx_v1
    gicp_fused_cuda._gicp_linearize_swept_cuda = (
        lambda tables, T, d2, robust, c: _gicp_linearize_swept_v1(tables, T, d2, robust, c))
    try:
        yield
    finally:
        cov_fused_cuda.knn_topk_idx_launch, gicp_fused_cuda._gicp_linearize_swept_cuda = saved


def _step_first_form(state, sums, corr, src, num, robust, robust_c, solve_dtype):
    """The LM iteration's body before the step kernel: the plain step's torch
    ops with the errors through K2's first form."""
    return gicp_lm_step_plain(
        state, sums, corr, src, num, robust, robust_c, solve_dtype,
        errors=lambda P: _gicp_error_multi_v1(corr, src, P, num, robust, robust_c))


@contextlib.contextmanager
def first_forms_scan():
    """Route K3 and K1 through their first forms (the yardsticks
    ``_knn_moments_rows_v1`` / ``_gicp_linearize_v1``, uncounted; the
    covariance stage's torch epilogue over K3's rows in place of K3's own)
    and the LM iteration's body through the torch ops and K2's first form
    (``_step_first_form``) inside the block."""
    k3, k1 = cov_fused_cuda._knn_moments_rows_cuda, gicp_fused_cuda._gicp_linearize_listed_cuda
    step, epilogue = lm_step._gicp_lm_step_cuda, normals.knn_normals_covs
    cov_fused_cuda._knn_moments_rows_cuda = (
        lambda points, num, k, target: _knn_moments_rows_v1(points, num, k))
    normals.knn_normals_covs = (
        lambda points, num, k, need_normals, need_covs, target=None: normals._torch_epilogue(
            points, num, *knn_moments(points, num, k, target=target), need_normals,
            need_covs))
    gicp_fused_cuda._gicp_linearize_listed_cuda = (
        lambda tables, T, d2, robust, c, out=None: _gicp_linearize_v1(
            tables, T, d2, robust, c, out=out))
    lm_step._gicp_lm_step_cuda = _step_first_form
    try:
        yield
    finally:
        cov_fused_cuda._knn_moments_rows_cuda = k3
        gicp_fused_cuda._gicp_linearize_listed_cuda = k1
        lm_step._gicp_lm_step_cuda = step
        normals.knn_normals_covs = epilogue


def api_counts(prof) -> dict:
    """Kernel launches, copies and memsets issued on the host in a profile
    (the CUDA runtime calls torch.profiler records)."""
    calls = {e.key: e.count for e in prof.key_averages()}
    return {"launches": calls.get("cudaLaunchKernel", 0),
            "copies": sum(v for k, v in calls.items() if k.startswith("cudaMemcpy")),
            "memsets": sum(v for k, v in calls.items() if k.startswith("cudaMemset")),
            "syncs": sum(v for k, v in calls.items()
                         if k in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                  "cudaEventSynchronize"))}


def host_enqueue_turns(fns: dict, reps: int = REPS) -> dict:
    """{name: median ms} of the host's time in one call of each function
    (the enqueue: no synchronize inside the window), in turns, after one
    untimed call each; the card is synchronized between calls."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return {name: float(np.median(v)) for name, v in times.items()}


@contextlib.contextmanager
def prefix_sum_v1():
    """Take the voxelgrid's run sums through their first form (the float64
    prefix sum along dim 0 of the sorted [N,4] rows) inside the block."""
    saved = downsampling._run_sums
    downsampling._run_sums = downsampling._run_sums_v1
    try:
        yield
    finally:
        downsampling._run_sums = saved


def within(fn):
    """``fn`` run inside ``first_forms_scan()``."""
    def run():
        with first_forms_scan():
            return fn()
    return run


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


def grid_cloud(dev, rows: int, cap: int, seed: int = 24) -> PointCloud:
    """``rows`` points in integer cells of a cube of about ``rows`` cells
    (every distance ties many times), in a table of ``cap`` rows."""
    side = max(2, round(rows ** (1 / 3)))
    xyz = np.random.default_rng(seed).integers(0, side, (rows, 3)).astype(np.float32)
    pts = np.full((cap, 4), 1e9, np.float32)
    pts[:, 3] = 0.0
    pts[:rows, :3], pts[:rows, 3] = xyz, 1.0
    return PointCloud(points=torch.as_tensor(pts, device=dev),
                      num_points=torch.tensor(rows, dtype=torch.int32, device=dev))


def phase_kernels(scans, T_gt, rng, dev, card="cpu"):
    """K1-K3 at the main path's shapes against their plain versions, K1 and
    K3 against their first forms, each timed alone and in turns."""
    print("== phase 4: kernels against their plain versions", flush=True)
    clouds = [voxelgrid_sampling(PointCloud.from_points(s, device=dev), LEAF)
              for s in scans]
    tgt, src = clouds
    m, n = int(tgt.num_points), int(src.num_points)
    print(f"downsampled: target {m} / source {n} points "
          f"(capacities {tgt.capacity} / {src.capacity})")
    records = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if \
        dev.type == "cuda" else 132

    # K3: kNN moments of the target cloud, and of a duplicate-heavy grid, at
    # k = 10 and 20: every row equal to the first form's (the same
    # neighbours summed in the same order), the plain version's neighbours
    # (counts, d_k) equal and its sums to their rounding.
    pts, num = tgt.points, tgt.num_points
    stgt = pruned_prepare_target(pts, num)
    grid = grid_cloud(dev, m, tgt.capacity)
    err = 0.0
    for label, cloud, kept in (("scan", tgt, stgt), ("grid", grid, None)):
        for kk in (K_NEIGHBORS, 20):
            cp, cn = cloud.points, cloud.num_points
            got = knn_moments_rows(cp, cn, kk, target=kept)
            check(torch.equal(got, _knn_moments_rows_v1(cp, cn, kk)),
                  f"K3 differs from its first form ({label}, k={kk})")
            ref = knn_moments_rows_plain(cp, cn, kk)
            check(torch.equal(got[:, 9:11], ref[:, 9:11]),
                  f"K3 neighbour counts or kth distances differ ({label}, k={kk})")
            diff = (got[:, :9] - ref[:, :9]).abs()
            excess = (diff - 1e-5 * ref[:, :9].abs()).max().item()
            check(excess <= 1e-4, f"K3 moments differ by {diff.max().item()}")
            if label == "scan" and kk == K_NEIGHBORS:
                err, d_k = diff.max().item(), got[:, 10]
            print(f"K3 knn_moments ({label}, k={kk}): every row equal to the first "
                  f"form's; counts and d_k equal to the plain version's, max |Δ moments| "
                  f"{diff.max().item():.3e} (tolerance 1e-4 + 1e-5·|m|: float32 sums of "
                  "k products, fused multiply-adds in the kernels)")
    new3 = lambda: knn_moments_rows(pts, num, K_NEIGHBORS, target=stgt)  # noqa: E731
    old3 = lambda: _knn_moments_rows_v1(pts, num, K_NEIGHBORS)  # noqa: E731
    check(launches_per_call(knn_moments_rows, new3) == 1, "K3 launched other than once")
    k3 = time_turns({"new": new3, "first form": old3,
                     "new, sorting": lambda: knn_moments_rows(pts, num, K_NEIGHBORS)})
    k3["alone"] = one_kernel_per_call(new3, r"knn_moments_kernel(?!_v1)")
    k3["first form alone"] = one_kernel_per_call(old3, "knn_moments_kernel_v1")
    team = cov_fused_cuda.MOMENTS_TEAM
    self_q = PrunedQueries(qperm=stgt.tperm[:m], qkey=None)
    need = pruned_pairs(stgt, self_q, pts[:m], d_k, m, block=64 // team)
    need64 = pruned_pairs(stgt, self_q, pts[:m], d_k, m)
    t1 = tgt.points[:m, :3].contiguous()
    lib_fn = lambda: torch.topk(torch.cdist(t1, t1), K_NEIGHBORS, largest=False)  # noqa: E731
    # reads the m valid rows once, writes a 64-byte row per capacity row;
    # 9 operations a pair and 9 a neighbour for the moments
    nbytes = 16.0 * m + 64.0 * tgt.capacity
    full_ms, full_by = bound(9.0 * m * m + 9.0 * K_NEIGHBORS * m, nbytes)
    records["knn_moments"] = dict(
        max_abs_err=err, ms=k3["alone"],
        plain_ms=time_ms(lambda: knn_moments_rows_plain(pts, num, K_NEIGHBORS), reps=3),
        library_ms=time_ms(lib_fn), pairs=need,
        bound=bound(9.0 * need + 9.0 * K_NEIGHBORS * m, nbytes))
    print(f"K3 at {m} rows, k={K_NEIGHBORS} ({team} threads a query, {64 // team} "
          f"queries a block): kernel alone (profiler, {REPS} calls, one kernel a call) "
          f"{k3['alone']:.4f} ms, its first form alone {k3['first form alone']:.4f} ms; "
          f"in turns (CUDA events around one call) {k3['new']:.4f} against "
          f"{k3['first form']:.4f} ms, {k3['new, sorting']:.4f} ms with its sort made in "
          f"the call; over the {need} pairs a pruned search of {64 // team}-query "
          f"blocks cannot avoid ({100 * need / (m * m):.2f} % of N²; {need64} at 64 "
          f"queries a block) bound {records['knn_moments']['bound'][0]:.4f} ms, "
          f"issue-rate floor {issue_floor_ms(need, sms):.4f} ms; over all N² pairs "
          f"{full_ms:.4f} ms by {full_by} on {card}")

    # K1: fused search + linearize at a noisy guess, against its plain
    # version, its split plain account and its first form; then with a
    # rejector radius of inf and with the source in its row order.
    tgt = estimate_normals_covariances(tgt, num_neighbors=K_NEIGHBORS)
    src = estimate_normals_covariances(src, num_neighbors=K_NEIGHBORS)
    T = torch.as_tensor(noisy_guess(T_gt, rng), dtype=torch.float32, device=dev)
    tables = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points,
                          "gicp", tgt.covs, src.covs)
    check(tables.route == "listed" and tables.sperm is not None,
          "the scan pair's tables carry no sort")
    out = gicp_linearize_tables(tables, T, MAX_DIST_SQ)
    h_err = check_linearize("K1 against its plain version", out,
                            gicp_linearize_listed_plain(tables, T, MAX_DIST_SQ), n, True)
    chunks = swept_plan(tables)
    check_linearize(f"K1 against its split plain account at {chunks} chunks", out,
                    gicp_linearize_swept_split_plain(tables, T, MAX_DIST_SQ,
                                                     chunks=chunks), n, True)
    check_linearize("K1 against its first form", out,
                    _gicp_linearize_v1(tables, T, MAX_DIST_SQ), n, False)
    check(bool(torch.all(out[3][:n][out[3][:n, 12] < 0.5][:, :13] == 0)),
          "K1's rows without a correspondence are not zero")
    check(launches_per_call(gicp_linearize_tables, lambda: gicp_linearize_tables(
        tables, T, MAX_DIST_SQ)) == 1, "K1 launched other than once a call")
    inf = float("inf")
    out_inf = gicp_linearize_tables(tables, T, inf)
    check_linearize("K1 at a radius of inf against its first form", out_inf,
                    _gicp_linearize_v1(tables, T, inf), n, True)
    check(int(out_inf[2]) == n, "a radius of inf leaves a row unmatched")
    rows = gicp_prepare(tgt.points, tgt.num_points, src.points, src.num_points, "gicp",
                        tgt.covs, src.covs)
    rows.sperm = torch.arange(src.capacity, dtype=torch.int32, device=dev)
    out_rows = gicp_linearize_tables(rows, T, MAX_DIST_SQ)
    check(torch.equal(out_rows[3], out[3]) and int(out_rows[2]) == int(out[2]),
          "K1 in the source's row order picks other winners")
    old = _gicp_linearize_v1(tables, T, MAX_DIST_SQ)
    h_scale = max(1.0, old[0].abs().max().item())
    h_morton = (out[0] - old[0]).abs().max().item() / h_scale
    h_rows = (out_rows[0] - old[0]).abs().max().item() / h_scale
    live = swept_live_tiles(tables, T, MAX_DIST_SQ)
    need = swept_pairs(tables, live)
    live_rows = swept_live_tiles(rows, T, MAX_DIST_SQ)
    need_rows = swept_pairs(rows, live_rows)
    k1_new = lambda: gicp_linearize_tables(tables, T, MAX_DIST_SQ)  # noqa: E731
    k1_old = lambda: _gicp_linearize_v1(tables, T, MAX_DIST_SQ)  # noqa: E731
    k1 = time_turns({
        "new": k1_new, "first form": k1_old,
        "new, row order": lambda: gicp_linearize_tables(rows, T, MAX_DIST_SQ),
        "new, radius inf": lambda: gicp_linearize_tables(tables, T, inf),
        "first form, radius inf": lambda: _gicp_linearize_v1(tables, T, inf)})
    # The new wrapper launches its kernel alone; the first form's wrapper
    # converts the pose and sums the partials with torch ops.
    k1["alone"] = one_kernel_per_call(k1_new, "gicp_linearize_listed_kernel", alone=False)
    k1["first form alone"] = one_kernel_per_call(k1_old, "gicp_linearize_kernel<",
                                                 alone=False)
    k1["row order alone"] = one_kernel_per_call(
        lambda: gicp_linearize_tables(rows, T, MAX_DIST_SQ),
        "gicp_linearize_listed_kernel", alone=False)
    k1["radius inf alone"] = one_kernel_per_call(
        lambda: gicp_linearize_tables(tables, T, inf), "gicp_linearize_listed_kernel",
        alone=False)
    k1["first form, radius inf alone"] = one_kernel_per_call(
        lambda: _gicp_linearize_v1(tables, T, inf), "gicp_linearize_kernel<", alone=False)
    tq = (src.points[:n, :3] @ T[:3, :3].T + T[:3, 3]).contiguous()
    tt = tgt.points[:m, :3].contiguous()
    lib_fn = lambda: torch.cdist(tq, tt).min(dim=1)  # noqa: E731
    # the sorted rows and boxes of the live tiles once; every source row read
    # (qtab, its order) and written (corr); one payload row per accepted
    # source row; the block partials
    live_tile_rows = float((live.any(dim=0).double() * TILE_ROWS).sum().item())
    nbytes = (16.0 + 32.0 / TILE_ROWS) * live_tile_rows + 64.0 * 2 * src.capacity \
        + 64.0 * n + 4.0 * src.capacity + 4.0 * 44 * ((src.capacity + 63) // 64)
    full_ms, full_by = bound(9.0 * n * m + 400.0 * n,
                             64.0 * (m + 2 * src.capacity)
                             + 4.0 * 44 * ((src.capacity + 63) // 64))
    records["gicp_linearize"] = dict(
        max_abs_err=h_err, ms=k1["alone"],
        plain_ms=time_ms(lambda: gicp_linearize_listed_plain(tables, T, MAX_DIST_SQ),
                         reps=3),
        library_ms=time_ms(lib_fn), pairs=need,
        bound=bound(9.0 * need + 400.0 * n, nbytes))
    print(f"K1 at {n} × {m} ({chunks} chunks a source block): kernel alone (profiler, "
          f"{REPS} calls) {k1['alone']:.4f} ms, its first form alone "
          f"{k1['first form alone']:.4f} ms; wrappers in turns (CUDA events around one "
          f"call) {k1['new']:.4f} against {k1['first form']:.4f} ms; over the {need} "
          f"pairs the box cull cannot avoid ({100 * need / (n * m):.2f} % of Q·M, "
          f"{100 * (1 - live.float().mean().item()):.1f} % of (block, tile) pairs "
          f"skipped) bound {records['gicp_linearize']['bound'][0]:.4f} ms, issue-rate "
          f"floor {issue_floor_ms(need, sms):.4f} ms; over all Q·M pairs {full_ms:.4f} ms "
          f"by {full_by}. Source in row order: {need_rows} pairs, alone "
          f"{k1['row order alone']:.4f} ms, wrapper {k1['new, row order']:.4f} ms, H "
          f"scaled against the first form {h_rows:.2e} (Morton order {h_morton:.2e}). "
          f"Radius inf (every tile walked): alone {k1['radius inf alone']:.4f} ms "
          f"against the first form's {k1['first form, radius inf alone']:.4f}, wrappers "
          f"{k1['new, radius inf']:.4f} against {k1['first form, radius inf']:.4f} ms "
          f"on {card}")
    H, b, corr = out[0], out[1], out[3]

    # K2 redesigned: the LM step kernel at the first iteration's sums and corr
    # (K1's own buffers) against its plain version, and its errors-only mode
    # (gicp_error_multi) against the plain version and K2's first form.
    bufs = linearize_buffers(tables)
    sums, corr = gicp_linearize_sums(tables, T, MAX_DIST_SQ, out=bufs)
    check(torch.equal(corr, out[3]) and torch.equal(sums[36:42], out[1]),
          "K1 into kept buffers differs")
    lambdas = 1e-3 * 10.0 ** torch.arange(10, dtype=torch.float32, device=dev)
    deltas = solve6x6(H.float(), -b.float(), lambdas)
    Ts = torch.cat([T[None], T @ se3_exp(deltas)]).contiguous()
    e = gicp_error_multi(corr, src.points, Ts, src.num_points)
    ep = gicp_error_multi_plain(corr, src.points, Ts, src.num_points)
    e1 = _gicp_error_multi_v1(corr, src.points, Ts, src.num_points)
    check(bool(torch.isfinite(e).all()), "K2 errors not finite")
    rel = ((e - ep).abs() / ep.abs().clamp(min=1e-30)).max().item()
    rel1 = ((e - e1).abs() / e1.abs().clamp(min=1e-30)).max().item()
    print(f"K2 errors-only mode (gicp_error_multi): {Ts.shape[0]} poses, max |Δe| against "
          f"the plain version {(e - ep).abs().max().item():.3e}, rel {rel:.2e}; against "
          f"K2's first form rel {rel1:.2e} (tol 1e-5)")
    check(rel <= 1e-5 and rel1 <= 1e-5, f"K2 errors differ by rel {rel} / {rel1}")
    check(launches_per_call(gicp_error_multi, lambda: gicp_error_multi(
        corr, src.points, Ts, src.num_points)) == 1, "K2 launched other than once")
    step_err = step_checks(sums, corr, src, T, dev)

    # Times: the step kernel alone and by its wrapper, in turns with the body
    # it replaced (K2's first form plus the plain step's torch ops); the
    # errors-only mode beside K2's first form.
    num = src.num_points
    st_new = lm_state(T, device=dev)
    st_old = lm_state(T, device=dev)
    st_plain = lm_state(T, device=dev)
    step_new = lambda: gicp_lm_step(st_new, sums, corr, src.points, num)  # noqa: E731
    step_old = lambda: gicp_lm_step_plain(  # noqa: E731
        st_old, sums, corr, src.points, num,
        errors=lambda P: _gicp_error_multi_v1(corr, src.points, P, num))
    k2_new = lambda: gicp_error_multi(corr, src.points, Ts, num)  # noqa: E731
    k2_old = lambda: _gicp_error_multi_v1(corr, src.points, Ts, num)  # noqa: E731
    check(launches_per_call(gicp_lm_step, step_new) == 1, "the step launched other than once")
    k2 = time_turns({"step": step_new, "first form + torch body": step_old,
                     "errors only": k2_new, "K2 first form": k2_old})
    k2["step alone"] = one_kernel_per_call(step_new, r"gicp_step_kernel<float, 1")
    k2["errors only alone"] = one_kernel_per_call(k2_new, r"gicp_step_kernel<float, 0")
    k2["first form alone"] = one_kernel_per_call(k2_old, "gicp_error_multi_kernel",
                                                 alone=False)
    k1_ = Ts.shape[0]
    # every valid row's corr and source rows read once, the sums read, the
    # record (1,264 bytes at K = 10) read and written; 40 operations a row and
    # pose, ~700 a trial's solve and pose
    nbytes = 80.0 * n + 8.0 * 44 + 2 * 1264.0
    records["gicp_lm_step"] = dict(
        max_abs_err=step_err, ms=k2["step alone"],
        plain_ms=time_ms(lambda: gicp_lm_step_plain(st_plain, sums, corr, src.points, num)),
        library_ms=None, pairs=n * k1_, bound=bound(40.0 * n * k1_ + 700.0 * 10, nbytes))
    print(f"K2 step kernel at {n} rows × {k1_} poses: alone (profiler, {REPS} calls, one "
          f"kernel a call, no other device work) {k2['step alone']:.4f} ms, by its wrapper "
          f"{k2['step']:.4f} ms in turns against {k2['first form + torch body']:.4f} ms for "
          f"K2's first form plus the torch body it replaced; errors-only mode alone "
          f"{k2['errors only alone']:.4f} ms, wrapper {k2['errors only']:.4f} ms, against "
          f"the first form's {k2['first form alone']:.4f} / {k2['K2 first form']:.4f} ms; "
          f"bound {records['gicp_lm_step']['bound'][0]:.4f} ms by "
          f"{records['gicp_lm_step']['bound'][1]} on {card}")
    return records


STEP_CASES = {
    "lm": {},
    "float64 solve": {"solve_dtype": "float64"},
    "huber": {"robust": "huber", "c": 0.5},
    "dof mask": {"dof": [0.0, 0.0, 0.0, 1e9, 1e9, 1e9]},
    "gn": {"optimizer": "gn"},
}


def step_checks(sums, corr, src, T, dev) -> float:
    """The step kernel against ``gicp_lm_step_plain`` (on CPU copies) in each
    of STEP_CASES: trial δ and poses within 1e-6, errors within 1e-5
    relative; the accepted trial, the accept, λ, converged and stop equal
    wherever every trial's error is more than 1e-5 relative from e0 (how
    many trials lie inside that band is printed). Returns the largest
    |Δ errors|."""
    cpu = torch.device("cpu")
    worst = 0.0
    for label, case in STEP_CASES.items():
        args = (case.get("robust"), case.get("c", 1.0), case.get("solve_dtype", "same"))
        states = []
        for d in (dev, cpu):
            st = lm_state(T.cpu(), case.get("optimizer", "lm"), 10, dof_diag=case.get("dof"),
                          device=d)
            gicp_lm_step(st, sums.to(d), corr.to(d), src.points.to(d),
                         src.num_points.to(d), *args)
            states.append(st)
        kern, plain = states
        k1 = 1 if plain.optimizer == "gn" else plain.num_trials + 1
        ek, ep = kern.errs[:k1].cpu(), plain.errs[:k1]
        rel = ((ek - ep).abs() / ep.abs()).max().item()
        d_trial = (kern.trials.cpu() - plain.trials).abs()
        d_delta, d_pose = d_trial[:, :6].max().item(), d_trial[:, 6:].max().item()
        inside = int(((ep[1:] - ep[0]).abs() <= 1e-5 * ep[0].abs()).sum())
        same = {name: torch.equal(getattr(kern, name).cpu(), getattr(plain, name))
                for name in ("j", "accepted", "lam", "converged", "stop")}
        d_T = (kern.T.cpu() - plain.T).abs().max().item()
        print(f"step kernel, {label}: errors rel {rel:.2e}, trial δ {d_delta:.2e}, trial "
              f"poses {d_pose:.2e}, new pose {d_T:.2e}; trial {int(kern.j)} accepted "
              f"{bool(kern.accepted)} stop {bool(kern.stop)} (plain: {int(plain.j)} "
              f"{bool(plain.accepted)} {bool(plain.stop)}); {inside} of {k1 - 1} trials "
              "within 1e-5 of e0")
        check(rel <= 1e-5, f"step errors differ by rel {rel} ({label})")
        check(d_delta <= 1e-6 and d_pose <= 1e-6, f"step trials differ ({label})")
        check(bool(torch.isfinite(kern.T).all()), f"non-finite step pose ({label})")
        if inside == 0:
            check(all(same.values()), f"step accept differs: {same} ({label})")
            check(d_T <= 1e-6, f"step pose differs by {d_T} ({label})")
        check(torch.equal(kern.H.cpu(), plain.H) and torch.equal(kern.b.cpu(), plain.b),
              f"step H or b differ ({label})")
        worst = max(worst, (ek - ep).abs().max().item())
    return worst


def phase_e2e(scans, T_gt, rng, dev, card, records):
    print("== phase 5: end to end", flush=True)
    for _, _, _, fn in KERNELS.values():
        fn.launches = 0
    gicp_error_multi.launches = 0
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
    check(launches["knn_moments"] == 2, "preprocessing did not run K3 once a cloud")
    check(launches["gicp_linearize"] == r["iterations"] + 1
          and launches["gicp_lm_step"] == r["iterations"] + 1,
          "the align did not run K1 and the step kernel once a linearization")
    check(gicp_error_multi.launches == 0, "the align launched K2's errors-only mode")

    # Preprocessing per frame pair and registrations/s, each in turns with
    # the same path through K3's and K1's first forms.
    def preprocess_pair():
        return [preprocess_points(s, LEAF, num_neighbors=K_NEIGHBORS, device=dev)
                for s in scans[:2]]

    (t_new, _), (s_new, _) = preprocess_pair()
    (t_old, _), (s_old, _) = within(preprocess_pair)()
    check(torch.equal(t_new.covs, t_old.covs) and torch.equal(s_new.covs, s_old.covs),
          "the covariances through K3's first form differ")
    # The voxelgrid's run sums (B-k): the prefix sum along the last dim of
    # the [4,N] transpose against its first form along dim 0 of [N,4].
    def old_prefix_sum(fn):
        def run():
            with prefix_sum_v1():
                return fn()
        return run

    ulps = []
    for sc in scans[:2]:
        cloud = PointCloud.from_points(sc, device=dev)
        new = voxelgrid_sampling(cloud, LEAF)
        old = old_prefix_sum(lambda: voxelgrid_sampling(cloud, LEAF))()
        nv = int(new.num_points)
        check(nv == int(old.num_points), "the voxel counts of the two prefix sums differ")
        a, b = new.points[:nv, :3], old.points[:nv, :3]
        ulp = torch.nextafter(b.abs(), torch.full_like(b, math.inf)) - b.abs()
        ulps.append(float(((a - b).abs() / ulp).max()))
        check(ulps[-1] <= 1.0, f"voxel means {ulps[-1]:.1f} float32 ulps from the first "
              "form's prefix sum")
    pre = host_turns({"new": preprocess_pair, "first forms": within(preprocess_pair),
                      "prefix sum's first form": old_prefix_sum(preprocess_pair)}, reps=5)
    old_ms = pre["prefix sum's first form"]
    print(f"preprocess_points of a frame pair (host clock around a synchronize, median "
          f"of 5 in turns): {pre['new']:.3f} ms, through K3's first form "
          f"{pre['first forms']:.3f} ms, through the voxelgrid prefix sum's first form "
          f"{old_ms:.3f} ms; voxel means within {max(ulps):.1f} float32 ulp of that "
          f"form's on {card}")

    # K1's wrapper on the host (enqueue time, no synchronize): as before this
    # slice (the tables' checks and chunk plan made and new outputs allocated
    # every call) and as the align now calls it (both once per tables, the
    # outputs kept).
    tables = gicp_prepare(target.points, target.num_points, source.points,
                          source.num_points, "gicp", target.covs, source.covs,
                          target=tree.pruned_target())
    bufs = linearize_buffers(tables)
    T0 = torch.as_tensor(init, dtype=torch.float32, device=dev)

    def k1_before():
        tables.checked = False
        return gicp_linearize_tables(tables, T0, MAX_DIST_SQ)

    host = host_enqueue_turns({
        "before": k1_before,
        "now": lambda: gicp_linearize_sums(tables, T0, MAX_DIST_SQ, out=bufs)})
    print(f"K1's wrapper, host time a call (median of {REPS} in turns, no synchronize): "
          f"{host['before']:.4f} ms with its checks, plan and outputs made every call, "
          f"{host['now']:.4f} ms with them kept; kernel alone "
          f"{records['gicp_linearize']['ms']:.4f} ms on {card}")

    # Registrations/s in turns: the new path and the same path through the
    # first forms (K3's, K1's, and K2's with the torch body of the LM
    # iteration).
    n_regs = 10
    paths = {"new": lambda f: f, "first forms": within}
    per_reg = {label: [] for label in paths}
    iters = {label: [] for label in paths}
    for r in range(n_regs):
        g = noisy_guess(T_gt, rng)
        order = list(paths.items())
        order = order[r % len(order):] + order[:r % len(order)]  # each first in turn
        for label, wrap in order:
            fn = wrap(lambda: align(target, source, tree, init_T_target_source=g))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            per_reg[label].append(time.perf_counter() - t0)
            iters[label].append(int(out.iterations))
            rot, trans = pose_error(out.T_target_source.cpu().numpy(), T_gt)
            check(rot < 2.5 and trans < 0.2, "a timed registration left the bounds")
    reg_per_s = n_regs / sum(per_reg["new"])
    print("registrations/s (preprocessing excluded, the same noisy guesses in turns, "
          "each path first in turn): "
          + ", ".join(f"{label} {n_regs / sum(v):.3f} (iterations {iters[label]})"
                      for label, v in per_reg.items()) + f" on {card}")
    # Each align runs K1 and the step kernel once per executed iteration.
    calls = sum(i + 1 for i in iters["new"])
    dt = sum(per_reg["new"])
    k_ms = calls * (records["gicp_linearize"]["ms"] + records["gicp_lm_step"]["ms"])
    print(f"K1 + step kernel time inside those aligns: {k_ms:.3f} ms of {dt * 1e3:.3f} ms "
          f"wall ({100 * k_ms / (dt * 1e3):.1f}%), {dt * 1e3 / calls:.3f} ms "
          "wall per optimizer iteration")

    # Device busy share over three aligns, each way, from a torch.profiler
    # trace (its own overhead lengthens the wall time a little).
    from torch.profiler import ProfilerActivity, profile

    inits = [noisy_guess(T_gt, rng) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        align(target, source, tree, init_T_target_source=inits[0])  # warms the profiler
    # The set-up of an align (tables, K1's buffers, the state record), profiled
    # alone, so that the launches of the loop can be told apart.
    kept = tree.pruned_target()

    def setup():
        t = gicp_prepare(target.points, target.num_points, source.points,
                         source.num_points, "gicp", target.covs, source.covs, target=kept)
        return linearize_buffers(t), lm_state(inits[0], device=dev)

    setup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in inits:
            setup()
        torch.cuda.synchronize()
    set_up = api_counts(prof)
    for label, wrap in (("new", lambda f: f), ("first forms", within)):
        done = []
        run = wrap(lambda: done.extend(
            int(align(target, source, tree, init_T_target_source=g).iterations) + 1
            for g in inits))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        seen = api_counts(prof)
        its = sum(done)
        events = device_events(prof)
        busy_us = sum(e.self_device_time_total for e in events)
        check(busy_us > 0, "the profiler saw no device time")
        loop = {k: seen[k] - set_up[k] for k in seen}
        print(f"profiled 3 aligns, {label}: {its} LM iterations; device busy "
              f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
              f"({100 * busy_us / wall_us:.1f}% busy); {seen['launches']} kernel launches, "
              f"{seen['copies']} copies, {seen['memsets']} memsets in all; less the "
              f"set-up of 3 aligns ({set_up}): {loop['launches'] / its:.2f} launches, "
              f"{loop['copies'] / its:.2f} copies and {loop['memsets'] / its:.2f} memsets "
              f"per LM iteration; top device time:")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
                  f"{e.key[:90]}")
        if label == "new":
            per_it = (loop["launches"] + loop["copies"] + loop["memsets"]) / its
            check(per_it <= 4.0, f"{per_it:.2f} device operations per LM iteration (> 4)")
    # One frame pair's preprocessing, profiled each way.
    for label, fn in (("new", preprocess_pair), ("first forms", within(preprocess_pair)),
                      ("prefix sum's first form", old_prefix_sum(preprocess_pair))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = device_events(prof)
        busy_us = sum(e.self_device_time_total for e in events)
        k3_us = sum(e.self_device_time_total for e in events
                    if "knn_moments_kernel" in e.key)
        scan_us = sum(e.self_device_time_total for e in events if "scan" in e.key)
        print(f"profiled preprocessing of a frame pair, {label}: device busy "
              f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
              f"({100 * busy_us / wall_us:.1f}% busy), K3 {k3_us / 1e3:.3f} ms of it, "
              f"scan kernels (the prefix sums) {scan_us / 1e3:.3f} ms; top device time:")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
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
    # The tables (with every pair's Morton sort and boxes) are built once per
    # fleet, outside the fleet's registrations/s.
    prep_ms = time_ms(lambda: fleet_prepare(targets, sources))
    print(f"{len(scans)} frames → {len(gts)} pairs at capacity {cap}, valid rows "
          f"{n_valid}; preprocess {t_pre:.3f} s, fleet_prepare {t_prep:.4f} s (first "
          f"call), {prep_ms:.3f} ms (CUDA events, median of {REPS})")
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
    unmatched = ~mask & active[:, None]
    check(bool(torch.all(corr[unmatched][:, :13] == 0)
               & torch.all(corr[unmatched][:, 13] == 3.0e38)),
          "K7 rows without a correspondence are not zero with d² = 3e38")
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
          f"(tol 5e-4), {int(unmatched.sum())} unmatched rows zero with d² 3e38, "
          "inactive lanes zero")
    check(w_err <= 2e-3, f"K7 W differs by {w_err}")
    check(h_err <= 5e-4 and b_err <= 5e-4, "K7 H/b differ")
    # Against the brute-force lane kernel on the same tables: the same
    # winners on accepted rows; block sums over other groups of 64 rows.
    H1, b1, inl1, corr1 = _gicp_linearize_fleet_brute(tables, uids, Ts, MAX_DIST_SQ,
                                                      active)
    check(torch.equal(mask, corr1[..., 12] > 0.5) and torch.equal(inl, inl1),
          "K7 and the brute-force lane kernel accept different rows")
    check(torch.equal(corr[mask][:, [0, 1, 2, 13]], corr1[mask][:, [0, 1, 2, 13]]),
          "K7's μ or d² differ from the brute-force lane kernel's on accepted rows")
    w_same = bool(torch.equal(corr[mask], corr1[mask]))
    h_b = ((H - H1).abs().amax(dim=(1, 2))
           / H1.abs().amax(dim=(1, 2)).clamp(min=1.0)).max().item()
    b_b = ((b - b1).abs().amax(dim=1) / b1.abs().amax(dim=1).clamp(min=1.0)).max().item()
    print(f"K7 against the brute-force lane kernel: masks equal, μ/d² equal on "
          f"{int(mask.sum())} accepted rows (whole rows, W included, "
          f"{'equal' if w_same else 'not equal'}), H scaled {h_b:.2e}, b scaled "
          f"{b_b:.2e} (tol 5e-4)")
    check(h_b <= 5e-4 and b_b <= 5e-4, "K7's H/b differ from the brute-force kernel's")

    # The pairs the box cull cannot avoid: for every block of 64 sorted
    # source rows of an active lane, its valid rows times the valid rows of
    # the tiles within the rejector radius of the block.
    live = fleet_live_tiles(tables, uids, Ts, MAX_DIST_SQ) & active[:, None, None]
    u_of = uids.long()
    nb, ntiles = live.shape[1:]
    t_rows = torch.clamp(tables.tnum[u_of, None] - TILE_ROWS * torch.arange(
        ntiles, device=dev), min=0, max=TILE_ROWS).double()  # [B,T]
    q_rows = torch.clamp(tables.qnum[u_of, None] - 64 * torch.arange(
        nb, device=dev), min=0, max=64).double()  # [B,nb]
    need = int(torch.einsum("bjt,bt,bj->", live.double(), t_rows, q_rows).item())
    live_rows = float((live.any(dim=1).double() * t_rows).sum().item())
    act = [u for u, a in zip(uid_list, active.tolist()) if a]
    all_pairs = sum(n_u[u] * m_u[u] for u in act)
    # All-pairs bound: valid target rows once per active lane; every source
    # row of every lane read (qtab) and written (corr); the [B, blocks, 44]
    # partials (the brute-force kernel's).
    full_ms, full_by = bound(
        sum(9.0 * n_u[u] * m_u[u] + 400.0 * n_u[u] for u in act),
        sum(64.0 * m_u[u] for u in act) + 64.0 * len(act) * cap + 64.0 * B * cap
        + 4.0 * 44 * B * ((cap + 63) // 64))
    # Pruned bound: the sorted rows and boxes of the live tiles once per
    # lane; qtab and the source order read and one payload row gathered per
    # active lane; corr written for every lane; the sums.
    ops = 9.0 * need + sum(400.0 * n_u[u] for u in act)
    nbytes = ((16.0 + 32.0 / TILE_ROWS) * live_rows + len(act) * (64.0 + 4.0) * cap
              + sum(64.0 * n_u[u] for u in act) + 64.0 * B * cap + 8.0 * 44 * B)
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

    k7 = time_turns({
        "pruned": lambda: gicp_linearize_fleet(tables, uids, Ts, MAX_DIST_SQ, active),
        "brute": lambda: _gicp_linearize_fleet_brute(tables, uids, Ts, MAX_DIST_SQ,
                                                     active)})
    k7_alone = one_kernel_per_call(
        lambda: gicp_linearize_fleet(tables, uids, Ts, MAX_DIST_SQ, active),
        "gicp_linearize_fleet_kernel")
    brute_alone, _, _ = kernel_ms(
        lambda: _gicp_linearize_fleet_brute(tables, uids, Ts, MAX_DIST_SQ, active),
        "gicp_linearize_kernel")
    check(launches_per_call(gicp_linearize_fleet, lambda: gicp_linearize_fleet(
        tables, uids, Ts, MAX_DIST_SQ, active)) == 1, "K7's wrapper does not launch once")
    records["gicp_linearize_fleet"] = dict(
        max_abs_err=(H - Hp).abs().max().item(), ms=k7_alone,
        plain_ms=time_ms(lambda: gicp_linearize_fleet_plain(
            tables, uids, Ts, MAX_DIST_SQ, active), reps=3),
        library_ms=time_ms(lib_k7, reps=3), pairs=need, bound=bound(ops, nbytes))
    k7_bound = records["gicp_linearize_fleet"]["bound"]
    print(f"K7 kernel alone (profiler, {REPS} calls, one kernel a call, no other device "
          f"work) {k7_alone:.4f} ms, the brute-force lane kernel alone "
          f"{brute_alone:.4f} ms; "
          f"their wrappers in turns (CUDA events around one call, median of {REPS}): "
          f"pruned {k7['pruned']:.4f} ms, brute force {k7['brute']:.4f} ms; "
          f"{100 * (1 - live[active].float().mean().item()):.2f} % of "
          f"{live[active].numel()} (block, tile) pairs culled; needed pairs {need} = "
          f"{100 * need / all_pairs:.3f} % of {all_pairs}; bound {k7_bound[0]:.4f} ms by "
          f"{k7_bound[1]} over them, {full_ms:.4f} ms by {full_by} over all pairs; "
          f"on {card}")

    # K8 at each lane's pose plus its 10 LM trial poses.
    lambdas = 1e-3 * 10.0 ** torch.arange(10, dtype=f32, device=dev)
    deltas = solve6x6(H.float()[:, None], -b.float()[:, None], lambdas.expand(B, 10))
    all_Ts = torch.cat([Ts[:, None], Ts[:, None] @ se3_exp(deltas)], dim=1)
    e = gicp_error_multi_fleet(corr, tables, uids, all_Ts)
    ep = gicp_error_multi_fleet_plain(corr, tables, uids, all_Ts)
    e2 = _gicp_error_multi_fleet_k2(corr, tables, uids, all_Ts)
    check(bool(torch.isfinite(e).all()), "K8 errors not finite")
    check(bool(torch.all(e[idle] == 0)), "K8 errors of inactive lanes are not zero")
    rel = ((e - ep).abs() / ep.abs().clamp(min=1e-30)).max().item()
    rel2 = ((e - e2).abs() / e2.abs().clamp(min=1e-30)).max().item()
    err = (e - ep).abs().max().item()
    print(f"K8 gicp_error_multi_fleet: {B} lanes × {all_Ts.shape[1]} poses, "
          f"max |Δe| {err:.3e}, rel {rel:.2e} (tol 1e-5); against K2's lane kernel rel "
          f"{rel2:.2e}")
    check(rel <= 1e-5, f"K8 errors differ by rel {rel}")
    check(rel2 <= 1e-5, f"K8 errors differ from K2's lane kernel's by rel {rel2}")
    k1 = all_Ts.shape[1]
    ops = sum(40.0 * n_u[u] * k1 for u in act)
    nbytes = sum(80.0 * n_u[u] for u in act) + 64.0 * B * k1
    k8 = time_turns({
        "new": lambda: gicp_error_multi_fleet(corr, tables, uids, all_Ts),
        "k2": lambda: _gicp_error_multi_fleet_k2(corr, tables, uids, all_Ts)})
    k8_alone = one_kernel_per_call(
        lambda: gicp_error_multi_fleet(corr, tables, uids, all_Ts),
        "gicp_error_multi_fleet_kernel")
    k2_alone, k2_count, k2_other = kernel_ms(
        lambda: _gicp_error_multi_fleet_k2(corr, tables, uids, all_Ts),
        "gicp_error_multi_kernel")
    check(launches_per_call(gicp_error_multi_fleet, lambda: gicp_error_multi_fleet(
        corr, tables, uids, all_Ts)) == 1, "K8's wrapper does not launch once")
    records["gicp_error_multi_fleet"] = dict(
        max_abs_err=err, ms=k8_alone,
        plain_ms=time_ms(lambda: gicp_error_multi_fleet_plain(corr, tables, uids,
                                                              all_Ts)),
        library_ms=None, pairs=sum(n_u[u] for u in act) * k1,
        bound=bound(ops, nbytes))
    print(f"K8 kernel alone (profiler, {REPS} calls, one kernel a call, no other device "
          f"work) {k8_alone:.4f} ms, its wrapper "
          f"(CUDA events around one call, median of {REPS}, in turns) {k8['new']:.4f} "
          f"ms; K2's lane kernel alone {k2_alone:.4f} ms ({k2_count} in {REPS} calls), "
          f"its wrapper {k8['k2']:.4f} ms (other device work in those calls: "
          f"{k2_other}); bound {records['gicp_error_multi_fleet']['bound'][0]:.4f} ms "
          f"by {records['gicp_error_multi_fleet']['bound'][1]} on {card}")

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
          f"converged {int(r['converged'].sum())}/{P}; fleet_prepare {prep_ms:.3f} ms "
          f"once, outside; single-pair align registrations/s {align_reg_per_s:.3f} in "
          f"phase 5) on {card}")
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
    launches_seen = sum(e.count for e in prof.key_averages()
                        if e.key == "cudaLaunchKernel")
    events = device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    check(busy_us > 0, "the profiler saw no device time")
    print(f"profiled fleet of {q} problems: device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({100 * busy_us / wall_us:.1f}% busy); "
          f"{launches_seen} kernel launches; top device time on {card}:")
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


def pruned_pairs(target, queries, query, d_k, m: int, block: int = BLOCK_QUERIES) -> int:
    """Pairs the pruned search cannot avoid on this data: for every block of
    ``block`` Morton-sorted queries, the rows of the tiles whose box lies
    within the block's true kth distance (the largest over its queries,
    ``d_k`` [Q] in query order) of the block's query box. The kernel scans
    at least these; with a bound looser than the true one it scans more."""
    dev = query.device
    nq = query.shape[0]
    nb = (nq + block - 1) // block
    ntiles = (m + TILE_ROWS - 1) // TILE_ROWS
    order = queries.qperm.long()
    pad = nb * block - nq
    qs = torch.cat([query[order, :3], query[order[-1:], :3].expand(pad, 3)])
    qs = qs.view(nb, block, 3)
    lo, hi = qs.amin(dim=1), qs.amax(dim=1)
    reach = torch.cat([d_k[order], d_k.new_zeros(pad)]).view(nb, block).amax(1)
    box = target.tbox[:ntiles]
    gap = torch.clamp(torch.maximum(box[None, :, 0:3] - hi[:, None],
                                    lo[:, None] - box[None, :, 4:7]), min=0.0)
    needed = (gap * gap).sum(dim=-1) <= reach[:, None]  # [nb, ntiles]
    rows = torch.clamp(m - TILE_ROWS * torch.arange(ntiles, device=dev),
                       max=TILE_ROWS).double()
    in_block = torch.clamp(nq - block * torch.arange(nb, device=dev), max=block).double()
    return int((needed.double() @ rows * in_block).sum().item())


def split_checks(tpts, tnum, qs, m: int, rng, card) -> dict:
    """K9 (both variants), K10 and K11 (k = 10, 20, 64) against their plain
    versions and their first forms at Q = 1, 64, 4096 and m, on the scan and
    on a duplicate-heavy grid of m points in 24³ cells queried with itself;
    one launch a call, by the counters and by the profiler. Then K10, K11
    and their first forms in turns by query count (k = 10; at m also k =
    20), and each kernel alone. Returns {(Q, k): {name: ms}}."""
    dev = tpts.device
    grid = PointCloud.from_points(rng.integers(0, 24, (m, 3)).astype(np.float32),
                                  device=dev)
    clouds = {"scan": (tpts, tnum, qs),
              "grid": (grid.points, grid.num_points, grid.points[:, :3])}
    for cloud, (t, num, qq) in clouds.items():
        for nq in (1, 64, 4096, qq.shape[0]):
            sub = qq[:nq]
            for v in VARIANTS:
                got = nearest_neighbor(t, num, sub, v)
                ref = nearest_neighbor_plain(t, num, sub, v)
                old = _nearest_neighbor_v1(t, num, sub, v)
                check(all(torch.equal(a, b) and torch.equal(a, c)
                          for a, b, c in zip(got, ref, old)),
                      f"K9 ({v}) differs from its plain version or first form on the "
                      f"{cloud} at Q={nq}")
            for k in (10, 20, 64):
                got = knn(t, num, sub, k)
                ref = knn_plain(t, num, sub, k)
                old = _knn_v1(t, num, sub, k)
                check(all(torch.equal(a, b) and torch.equal(a, c)
                          for a, b, c in zip(got, ref, old)),
                      f"K10 differs from its plain version or first form on the {cloud} "
                      f"at Q={nq}, k={k}")
                check(launches_per_call(knn, lambda: knn(t, num, sub, k)) == 1,
                      "K10 launched other than once a call")
                new11, old11 = knn_T(t, num, sub, k), _knn_T_v1(t, num, sub, k)
                check(all(torch.equal(a, b) and torch.equal(a, c)
                          for a, b, c in zip(new11, ref, old11)),
                      f"K11 differs from its plain version, K10 or its first form on "
                      f"the {cloud} at Q={nq}, k={k}")
                check(launches_per_call(knn_T, lambda: knn_T(t, num, sub, k)) == 1,
                      "K11 launched other than once a call")
    print(f"K9 (vpu, mxu), K10 and K11 (k = 10, 20, 64) equal to their plain versions "
          f"and first forms (K11 to K10) at Q = 1, 64, 4096, {m} on the scan and on a "
          f"grid of {m} points in 24³ cells; one launch a call")
    alone = one_kernel_per_call(lambda: knn(tpts, tnum, qs, K_NEIGHBORS),
                                "knn_split_kernel")
    sms = knn_cuda._sm_count(dev.index)
    turns = {}
    for nq in (1, 64, 4096, m):
        sub = qs[:nq]
        for k in ((K_NEIGHBORS, 20) if nq == m else (K_NEIGHBORS,)):
            t = turns[nq, k] = time_turns({
                "knn": lambda: knn(tpts, tnum, sub, k),
                "knn v1": lambda: _knn_v1(tpts, tnum, sub, k),
                "knn_T": lambda: knn_T(tpts, tnum, sub, k),
                "knn_T v1": lambda: _knn_T_v1(tpts, tnum, sub, k)})
            fastest = min(t, key=t.get)
            # The kernels alone: a one-call event window holds the wrapper's
            # host time too, which dominates at a few queries.
            t["kernel"] = one_kernel_per_call(lambda: knn(tpts, tnum, sub, k),
                                              "knn_split_kernel")
            t["kernel v1"] = one_kernel_per_call(lambda: _knn_v1(tpts, tnum, sub, k),
                                                 "knn_kernel")
            t["K11 kernel"] = one_kernel_per_call(lambda: knn_T(tpts, tnum, sub, k),
                                                  "knn_warp_split_kernel")
            t["K11 kernel v1"] = one_kernel_per_call(
                lambda: _knn_T_v1(tpts, tnum, sub, k), "knn_warp_kernel_v1")
            fastest_alone = min(("K10", t["kernel"]), ("K11", t["K11 kernel"]),
                                key=lambda x: x[1])[0]
            nsplit = knn_cuda.split_plan(nq, tpts.shape[0], knn_cuda.KNN_BLOCK_QUERIES, sms)
            chunk = knn_cuda.split_chunk(m, nsplit,
                                         least=knn_cuda.knn_least_rows(nq, k, sms))
            wsplit = knn_cuda.warp_plan(nq, tpts.shape[0], k, sms)
            print(f"K10, K11 in turns at Q={nq}, M={m}, k={k}: knn {t['knn']:.4f} ms "
                  f"({nsplit} chunks of {chunk} rows planned), first "
                  f"form {t['knn v1']:.4f} ms, K11 knn_T {t['knn_T']:.4f} ms "
                  f"({wsplit} chunks of {knn_cuda.split_chunk(m, wsplit)} rows, "
                  f"{knn_cuda.warp_block_queries(k)} queries a block), its first form "
                  f"{t['knn_T v1']:.4f} ms ({fastest} fastest); kernels alone by the "
                  f"profiler: knn {t['kernel']:.4f} ms, first form {t['kernel v1']:.4f} "
                  f"ms, K11 {t['K11 kernel']:.4f} ms, its first form "
                  f"{t['K11 kernel v1']:.4f} ms ({fastest_alone} faster alone) on {card}")
    print(f"K10 kernel alone by the profiler at {m}², k={K_NEIGHBORS}: {alone:.4f} ms, "
          f"one kernel a call on {card}")
    return turns


def old_morton(xyz, origin):
    """Morton codes (cell 1.0) as the first form's prologue formed them: by
    shifts and masks."""
    c = torch.floor(xyz - origin)
    finite_c = torch.isfinite(c)
    ci = torch.where(finite_c, c, torch.zeros_like(c)).clamp(0.0, 1023.0).to(torch.int32)
    bits = knn_window._dilate10_32(ci)
    code = (bits[..., 2] << 2) | (bits[..., 1] << 1) | bits[..., 0]
    return torch.where(finite_c.all(dim=-1), code, torch.full_like(code, 2 ** 31 - 1))


def old_query_half(target, query):
    """The query half of K12's first-form prologue (``old_morton``
    widened to int64, a sort, a searchsorted, two conversions), for its time
    and launches."""
    codes = old_morton(query[:, :3], target.origin).to(torch.int64)
    qkey, qperm = torch.sort(codes, stable=True)
    return qperm.to(torch.int32), torch.searchsorted(target.tkey, qkey).to(torch.int32)


def device_launches(fn) -> float:
    """Kernels, copies and memsets on the card per call of ``fn``: every
    device event of ``REPS`` calls profiled after a warm-up step, per call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in device_events(prof)) / REPS


def pruned_checks(tpts, tnum, qs, ptgt, card, ks=(K_NEIGHBORS, 20), ref=None,
                  reps=REPS) -> dict:
    """K12 over the kept target half ``ptgt``: equal to ``knn_plain`` (or
    ``ref``, (d², idx) of the largest k) and to its first form at each k of
    ``ks``, one launch a call (counter and profiler); the kernel alone and its
    first form alone (the profiler), both launches in turns (CUDA events),
    the pairs a walk of its blocks cannot avoid, and the prologue's halves
    (time, and the query half's launches, also in its first form). Returns
    {"alone", "pairs", ...} at the first k."""
    m, nq = int(tnum), qs.shape[0]
    pqry = pruned_prepare_queries(ptgt, qs)
    qpos = pruned_query_positions(ptgt, pqry).to(torch.int32)
    team = knn_cuda.pruned_plan(nq, knn_cuda._sm_count(qs.device.index))
    out = {}
    for kk in ks:
        got = knn_pruned_launch(ptgt, tnum, qs, pqry, kk)
        old = _knn_pruned_v1(ptgt, tnum, qs, pqry, kk, qpos)
        want = ref if ref is not None else knn_plain(tpts, tnum, qs, kk)
        check(all(torch.equal(a, b) and torch.equal(a, c)
                  for a, b, c in zip(got, want, old)),
              f"K12 differs from its plain version or its first form at {nq} × {m}, "
              f"k={kk}")
        check(launches_per_call(knn_pruned, lambda: knn_pruned_launch(
            ptgt, tnum, qs, pqry, kk)) == 1, "K12 launched other than once a call")
        need = pruned_pairs(ptgt, pqry, qs, got[0][:, kk - 1], m, block=64 // team)
        t = time_turns({"K12": lambda: knn_pruned_launch(ptgt, tnum, qs, pqry, kk),
                        "K12 v1": lambda: _knn_pruned_v1(ptgt, tnum, qs, pqry, kk, qpos)},
                       reps=reps)
        t["alone"] = one_kernel_per_call(
            lambda: knn_pruned_launch(ptgt, tnum, qs, pqry, kk), "knn_pruned_walk_kernel")
        t["v1 alone"] = one_kernel_per_call(
            lambda: _knn_pruned_v1(ptgt, tnum, qs, pqry, kk, qpos), "knn_pruned_kernel_v1",
            alone=False)
        t["pairs"] = need
        print(f"K12 at {nq} × {m}, k={kk} ({team} threads a query, {64 // team} queries "
              f"a block): kernel alone (profiler) {t['alone']:.4f} ms against its first "
              f"form's {t['v1 alone']:.4f}; launches in turns (CUDA events) "
              f"{t['K12']:.4f} against {t['K12 v1']:.4f} ms; over the {need} pairs a "
              f"walk of {64 // team}-query blocks cannot avoid "
              f"({100 * need / (nq * m):.2f} % of Q·M) bound "
              f"{search_bound(nq, m, kk, need)[0]:.4f} ms, issue-rate floor "
              f"{issue_floor_ms(need):.4f} ms on {card}")
        out = out or t
    kk = ks[0]
    half = {
        "target half": time_ms(lambda: pruned_prepare_target(tpts, tnum), reps=reps),
        "query half": time_ms(lambda: pruned_prepare_queries(ptgt, qs), reps=reps),
        "query half (first form)": time_ms(lambda: old_query_half(ptgt, qs), reps=reps),
        "kept": time_ms(lambda: knn_pruned(tpts, tnum, qs, kk, target=ptgt), reps=reps),
        "whole": time_ms(lambda: knn_pruned(tpts, tnum, qs, kk), reps=reps),
    }
    codes = lambda: knn_window.morton_codes32(qs, 1.0, ptgt.origin)  # noqa: E731
    old_codes = lambda: old_morton(qs, ptgt.origin)  # noqa: E731
    check(torch.equal(codes(), old_codes()), "the Morton codes differ from the first form's")
    half["codes"] = time_ms(codes, reps=reps)
    half["codes (first form)"] = time_ms(old_codes, reps=reps)
    launches = {"query half": device_launches(lambda: pruned_prepare_queries(ptgt, qs)),
                "query half (first form)": device_launches(lambda: old_query_half(ptgt, qs)),
                "codes": device_launches(codes), "codes (first form)": device_launches(old_codes)}
    print(f"K12's prologue at {nq} × {m}: " + ", ".join(
        f"{key} {v:.4f} ms" for key, v in half.items())
        + f" (CUDA events); device launches a call: {launches} on {card}")
    out.update(half)
    return out


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
    centre = tree.centre()
    dv, iv = nearest_neighbor(tpts, tnum, q, "vpu")
    dvp, ivp = nearest_neighbor_plain(tpts, tnum, q, "vpu")
    check(torch.equal(iv, ivp) and torch.equal(dv, dvp),
          "K9 (vpu) differs from its plain version")
    dm, im = nearest_neighbor(tpts, tnum, q, "mxu")
    dmp, imp = nearest_neighbor_plain(tpts, tnum, q, "mxu")
    check(torch.equal(im, imp) and torch.equal(dm, dmp),
          "K9 (mxu) differs from its plain version")
    for variant, (d, i) in (("vpu", (dv, iv)), ("mxu", (dm, im))):
        d1, i1 = _nearest_neighbor_v1(tpts, tnum, q, variant, centre)
        check(torch.equal(d, d1) and torch.equal(i, i1),
              f"K9 ({variant}) differs from its first form")
    # Score form against difference form. The score |t|² − 2 q·t of a row
    # carries a rounding error of up to 2·2⁻²³·(|q| + |t|)² in the centred
    # frame, so between two rows it may prefer the one whose true d² is larger
    # by twice that. Each query gets that tolerance from its own reach and
    # its winners' (the farther of the two variants' rows): the winners' d²
    # agree within it, and the rows are equal wherever the runner-up (K10,
    # k = 2) is farther than it.
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
          f"plain versions and first forms (d², idx); mxu vs vpu max |Δd²| "
          f"{delta.max().item():.3e}, rows equal on {int(clear.sum())} queries with a "
          f"clear runner-up ({100 * clear_share:.1f} %), {int((iv != im).sum())} differ "
          "in all")
    tt = tpts[:m, :3].contiguous()
    qc = q.contiguous()
    # The launch alone (the centre given, as KdTree gives it) is the kernel's
    # time, in turns with its first form; the wrapper without a centre adds
    # the torch ops that compute it. The profiler shows one K9 per call and
    # no other device work.
    k9 = time_turns({f"{v}{tag}": (lambda v=v, fn=fn: fn(tpts, tnum, q, v, centre))
                     for v in VARIANTS
                     for tag, fn in (("", nearest_neighbor), (" v1", _nearest_neighbor_v1))})
    whole_ms = time_ms(lambda: nearest_neighbor(tpts, tnum, q, "vpu"))
    k9_alone = {}
    for v in VARIANTS:
        k9_alone[v] = one_kernel_per_call(
            lambda v=v: nearest_neighbor(tpts, tnum, q, v, centre), "nn1_split_kernel")
        check(launches_per_call(nearest_neighbor, lambda v=v: nearest_neighbor(
            tpts, tnum, q, v, centre)) == 1, "K9 launched other than once a call")
    records["nearest_neighbor"] = dict(
        max_abs_err=(dv - dvp).abs().max().item(), ms=k9["vpu"],
        plain_ms=time_ms(lambda: nearest_neighbor_plain(tpts, tnum, q, "vpu"), reps=3),
        library_ms=time_ms(lambda: torch.cdist(qc, tt).min(dim=1), reps=3),
        pairs=n * m, bound=search_bound(n, m, 1))
    nsplit = knn_cuda.split_plan(n, tpts.shape[0], knn_cuda.NN1_BLOCK_QUERIES,
                                 knn_cuda._sm_count(q.device.index))
    print(f"K9 launch alone, in turns with its first form: vpu {k9['vpu']:.4f} ms "
          f"(v1 {k9['vpu v1']:.4f}), mxu {k9['mxu']:.4f} ms (v1 {k9['mxu v1']:.4f}); "
          f"kernel alone by the profiler vpu {k9_alone['vpu']:.4f}, mxu "
          f"{k9_alone['mxu']:.4f} ms; whole wrapper (centre computed per call) vpu "
          f"{whole_ms:.4f} ms; {nsplit} chunks of "
          f"{knn_cuda.split_chunk(m, nsplit)} rows on {card}")

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
    # K12's record is the kernel alone over a finished prologue (the
    # target half kept, as KdTree keeps it), against the pairs this data
    # leaves a walk of its blocks; its first form beside it, and both halves
    # of the prologue, the query half also in its first form.
    ptgt = tree.pruned_target()
    k12 = pruned_checks(tpts, tnum, qs, ptgt, card)
    records["knn_pruned"].update(
        ms=k12["alone"], pairs=k12["pairs"],
        bound=search_bound(m, m, k, k12["pairs"]),
        plain_ms=time_ms(lambda: knn_pruned_plain(tpts, tnum, qs, k), reps=3))

    # K9 and K10 at every query count; K10 in turns with its first form and
    # K11 by query count (the first Q rows as queries).
    turns = split_checks(tpts, tnum, qs, m, rng, card)
    records["knn"]["ms"] = turns[m, K_NEIGHBORS]["knn"]
    # K11's record is its kernel alone (the profiler), as K3's and K4's are.
    t11 = turns[m, K_NEIGHBORS]
    records["knn_T"]["ms"] = t11["K11 kernel"]
    print(f"K11 at {m}², k={K_NEIGHBORS}: kernel alone {t11['K11 kernel']:.4f} ms against "
          f"its first form's {t11['K11 kernel v1']:.4f} and K10's {t11['kernel']:.4f}; "
          f"one-call events {t11['knn_T']:.4f} / {t11['knn_T v1']:.4f} / {t11['knn']:.4f} "
          f"ms; bound {records['knn_T']['bound'][0]:.4f} ms by operations, issue-rate "
          f"floor {issue_floor_ms(m * m):.4f} ms on {card}")

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
    d11, i11 = _knn_T_v1(rpts, rnum, rq, 20)
    check(torch.equal(d10, d11) and torch.equal(i10, i11),
          "K11's first form differs from K10 at raw-scan scale")
    d1, i1 = _knn_v1(rpts, rnum, rq, 20)
    check(torch.equal(d10, d1) and torch.equal(i10, i1),
          "K10 differs from its first form at raw-scan scale")
    for v in VARIANTS:
        got = nearest_neighbor(rpts, rnum, rq[pick], v)
        ref = nearest_neighbor_plain(rpts, rnum, rq[pick], v)
        old = _nearest_neighbor_v1(rpts, rnum, rq[pick], v)
        check(all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(got, ref, old)),
              f"K9 ({v}) differs from its plain version or first form at raw-scan scale")
    raw_ms = time_turns({"knn": lambda: knn(rpts, rnum, rq, 20),
                         "knn v1": lambda: _knn_v1(rpts, rnum, rq, 20),
                         "knn_T": lambda: knn_T(rpts, rnum, rq, 20),
                         "knn_T v1": lambda: _knn_T_v1(rpts, rnum, rq, 20)}, reps=3)
    raw_ms["knn_pruned"] = time_ms(lambda: knn_pruned(rpts, rnum, rq, 20), reps=3)
    raw_ms["K11 alone"] = one_kernel_per_call(lambda: knn_T(rpts, rnum, rq, 20),
                                              "knn_warp_split_kernel")
    raw_tree = KdTree(points=rpts, num_points=rnum)
    b_ms, b_by = search_bound(nr, nr, 20)
    print(f"raw-scan scale, {nr} × {nr}, k=20: K11, K12 and the first forms of K10 and "
          f"K11 equal to K10, K10 and K9 equal to their plain versions on {len(pick)} "
          f"sampled queries; in turns: knn {raw_ms['knn']:.3f} ms (first form "
          f"{raw_ms['knn v1']:.3f}), knn_T {raw_ms['knn_T']:.3f} ms (first form "
          f"{raw_ms['knn_T v1']:.3f}; kernel alone {raw_ms['K11 alone']:.3f}; bound "
          f"{b_ms:.4f} ms by {b_by}, issue-rate floor {issue_floor_ms(nr * nr):.3f} ms); "
          f"knn_pruned whole {raw_ms['knn_pruned']:.3f} ms on {card}")
    pruned_checks(rpts, rnum, rq, raw_tree.pruned_target(), card, ks=(20,),
                  ref=(d10, i10), reps=3)

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
    check(counts["gicp_linearize"] == 0
          and counts["gicp_lm_step"] == r["iterations"] + 1,
          "the unfused route launched K1, or not the step kernel once an iteration")
    fused = align_impl(target, source, tree, init)
    check(_agrees((r["T_target_source"], r["iterations"]), fused),
          "unfused and fused align disagree")
    for fn in (gicp_linearize_tables, gicp_lm_step):
        fn.launches = 0  # the fused comparison is not part of this path
    n_regs = 5
    per_reg = {}
    for mode in ("never", "auto"):
        inits = [noisy_guess(T_gt, rng) for _ in range(n_regs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        its = 0
        for g in inits:
            out = align_impl(target, source, tree, g, use_fused=mode)
            rot, trans = pose_error(out.T_target_source.cpu().numpy(), T_gt)
            its += int(out.iterations) + 1
            check(rot < 2.5 and trans < 0.2,
                  f"a timed {mode} registration left the bounds")
        torch.cuda.synchronize()
        per_reg[mode] = (time.perf_counter() - t0) * 1e3 / n_regs
        if mode == "never":
            check(gicp_linearize_tables.launches == 0 and gicp_lm_step.launches == its,
                  "the unfused route launched K1, or not the step kernel once an "
                  "iteration")
    print(f"time per registration: unfused {per_reg['never']:.2f} ms, fused "
          f"{per_reg['auto']:.2f} ms ({n_regs} aligns each) on {card}")

    cli = {"new": cli_rates()}
    launches = {name: KERNELS[name][3].launches for name in SEARCH_KERNELS}
    print(f"launches on the search path: {launches}")
    check(all(v > 0 for v in launches.values()), "a search kernel was not launched")
    # The CLI again through the first forms of K9 and K10, then through the
    # new ones: in turns, in this call.
    with first_forms():
        cli["v1"] = cli_rates()
    cli["again"] = cli_rates()
    for n_k, rate in cli["new"].items():
        print(f"kdtree_benchmark n={n_k[0]} k={n_k[1]}: {rate} and {cli['again'][n_k]} "
              f"queries/s, first forms {cli['v1'][n_k]} "
              f"({min(rate, cli['again'][n_k]) / cli['v1'][n_k]:.2f}× or more) on {card}")
    return records, launches


def cli_rates() -> dict:
    """{(n, k): queries/s} of one run of the kdtree_benchmark CLI, whose
    lines are printed as well."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = kdtree_benchmark.main([])
    print(out.getvalue(), end="")
    check(rc == 0, "kdtree_benchmark failed")
    rows = [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]
    return {(r["n"], r["k"]): r["queries_per_sec"] for r in rows}


@contextlib.contextmanager
def first_forms():
    """``KdTree`` searches through the first forms of K9 and K10, which it
    looks up in ``knn_cuda`` at each call, uncounted."""
    saved = knn_cuda.knn, knn_cuda.nearest_neighbor
    knn_cuda.knn, knn_cuda.nearest_neighbor = _knn_v1, _nearest_neighbor_v1
    try:
        yield
    finally:
        knn_cuda.knn, knn_cuda.nearest_neighbor = saved


def world_cloud(scans, poses) -> np.ndarray:
    """Raw frames moved into the world frame by their poses, concatenated."""
    return np.concatenate([
        (s.astype(np.float64) @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        for s, T in zip(scans, poses)])


def swept_pairs(tables, live) -> int:
    """Pairs the swept search cannot avoid on this data: for every block of
    64 sorted source rows, its valid rows times the valid rows of the tiles
    within the rejector radius of the block (``live``)."""
    dev = live.device
    nb, ntiles = live.shape
    m, nv = int(tables.tnum), int(tables.qnum)
    rows = torch.clamp(m - TILE_ROWS * torch.arange(ntiles, device=dev), min=0,
                       max=TILE_ROWS).double()
    in_block = torch.clamp(nv - 64 * torch.arange(nb, device=dev), min=0,
                           max=64).double()
    return int((live.double() @ rows * in_block).sum().item())


def check_linearize(name, got, ref, n, exact_rows: bool) -> float:
    """A linearize kernel's (H, b, inliers, corr) against a reference on the
    same tables: masks and inliers equal; μ and d² equal bit for bit on
    inlier rows (on every row if ``exact_rows``); W within 2e-3 relative; H
    and b within 5e-4 of their largest entry. Returns max |ΔH|."""
    (H, b, inl, corr), (Hp, bp, inlp, corrp) = got, ref
    mask = corr[:n, 12] > 0.5
    check(torch.equal(mask, corrp[:n, 12] > 0.5), f"{name} inlier masks differ")
    check(int(inl) == int(inlp), f"{name} inlier counts differ")
    sel = torch.ones_like(mask) if exact_rows else mask
    check(torch.equal(corr[:n][sel][:, [0, 1, 2, 13]], corrp[:n][sel][:, [0, 1, 2, 13]]),
          f"{name} correspondences (μ, d²) differ")
    w_err = ((corr[:n, 3:12] - corrp[:n, 3:12])[sel].abs()
             / torch.clamp(corrp[:n, 3:12][sel].abs(), min=1.0)).max().item()
    h_err = (H - Hp).abs().max().item()
    h_rel = h_err / max(1.0, Hp.abs().max().item())
    b_rel = (b - bp).abs().max().item() / max(1.0, bp.abs().max().item())
    print(f"{name}: {int(inl)} inliers, masks/μ/d² equal, W rel {w_err:.2e} "
          f"(tol 2e-3), H scaled {h_rel:.2e}, b scaled {b_rel:.2e} (tol 5e-4)")
    check(w_err <= 2e-3, f"{name} W differs by {w_err}")
    check(h_rel <= 5e-4 and b_rel <= 5e-4, f"{name} H/b differ")
    return h_err


def swept_checks(name, tables, T, n) -> dict:
    """K6 on ``tables`` at T: equal to its first form in corr and the
    float64 sums, at the planned chunk count, at one chunk and at more
    chunks than a source block has live tiles, and at each equal to its
    split plain account (``check_linearize``, every row); one launch a
    call. Returns {"plan": chunks planned, "above": the count above}."""
    out = gicp_linearize_tables(tables, T, MAX_DIST_SQ)
    old = _gicp_linearize_swept_v1(tables, T, MAX_DIST_SQ)
    check(all(torch.equal(a, b) for a, b in zip(out, old)),
          f"K6 differs from its first form ({name})")
    live = swept_live_tiles(tables, T, MAX_DIST_SQ)
    plan = swept_plan(tables)
    above = min(65535, int(live.sum(dim=1).max().item()) + 3)
    for chunks in (plan, 1, above):
        got = _gicp_linearize_swept_cuda(tables, T, MAX_DIST_SQ, None, 1.0, chunks)
        check(all(torch.equal(a, b) for a, b in zip(got, old)),
              f"K6 at {chunks} chunks differs from its first form ({name})")
        check_linearize(f"K6 at {chunks} chunks against its split plain account ({name})",
                        got, gicp_linearize_swept_split_plain(tables, T, MAX_DIST_SQ,
                                                              chunks=chunks), n, True)
    check(launches_per_call(gicp_linearize_swept, lambda: gicp_linearize_tables(
        tables, T, MAX_DIST_SQ)) == 1, "K6 launched other than once a call")
    print(f"K6 ({name}): equal to its first form (corr, H, b, inliers) at {plan} chunks "
          f"(planned), 1 and {above} (above the {above - 3} live tiles of the fullest "
          "source block); one launch a call")
    return {"plan": plan, "above": above}


def score_checks(tables, T, outs, n, sms, card) -> dict:
    """K1's score form ``outs`` on ``tables`` at T against its plain account
    (every row: masks, μ and d² equal), its brute-force plain version and
    its first form: those two take the score's winner over every valid row,
    and the walk takes the same winner on every row where that winner is
    accepted, unless its exact d² lies within the score's rounding of the
    radius, 4·2⁻²³·(|q| + |t|)². One launch a call; the kernel alone and
    its first form alone (the profiler), the wrappers in turns. Returns
    {"max_abs_err", "ms", "pairs"}."""
    walk = gicp_linearize_score_walk_plain(tables, T, MAX_DIST_SQ)
    h_err = check_linearize("K1 score form against its plain account", outs, walk, n,
                            True)
    brute = gicp_linearize_score_plain(tables, T, MAX_DIST_SQ)
    old = _gicp_linearize_score_v1(tables, T, MAX_DIST_SQ)
    q = tables.qtab[:n, :3] @ T[:3, :3].T + T[:3, 3]
    tol = 4.0 * 2.0 ** -23 * (q.norm(dim=1) + old[3][:n, :3].norm(dim=1)) ** 2
    clear = (old[3][:n, 13] - MAX_DIST_SQ).abs() > tol
    mask = outs[3][:n, 12] > 0.5
    for name, ref in (("its brute-force plain version", brute), ("its first form", old)):
        sel = clear & (ref[3][:n, 12] > 0.5)
        check(torch.equal(mask[clear], ref[3][:n, 12][clear] > 0.5)
              and torch.equal(outs[3][:n][sel][:, [0, 1, 2, 13]],
                              ref[3][:n][sel][:, [0, 1, 2, 13]]),
              f"K1's score form picks other winners than {name}")
    near = int((~clear).sum())
    check(abs(int(outs[2]) - int(brute[2])) <= near and abs(int(old[2]) - int(brute[2])) == 0,
          "K1's score form and its brute-force forms disagree on the inliers")
    h_rel = (outs[0] - brute[0]).abs().max().item() / max(1.0, brute[0].abs().max().item())
    check(h_rel <= 5e-4, f"K1's score form's H differs from the brute force's by {h_rel}")
    check(launches_per_call(gicp_linearize_score, lambda: gicp_linearize_score(
        tables, T, MAX_DIST_SQ)) == 1, "K1's score form launched other than once a call")
    live = swept_live_tiles(tables, T, MAX_DIST_SQ)
    need = swept_pairs(tables, live)
    new = lambda: gicp_linearize_score(tables, T, MAX_DIST_SQ)  # noqa: E731
    v1 = lambda: _gicp_linearize_score_v1(tables, T, MAX_DIST_SQ)  # noqa: E731
    t = time_turns({"new": new, "v1": v1})
    alone = one_kernel_per_call(new, r"gicp_linearize_listed_kernel<[^>]*true>",
                                alone=False)
    v1_alone = one_kernel_per_call(v1, r"gicp_linearize_kernel<[^>]*true>", alone=False)
    m = int(tables.tnum)
    print(f"K1's score form at {n} × {m} ({swept_plan(tables)} chunks a source block): "
          f"equal to its plain account on every row and to its brute-force plain "
          f"version and first form on the {int(clear.sum())} rows whose winner's d² is "
          f"clear of the radius by the score's rounding ({near} are not; inliers "
          f"{int(outs[2])} against {int(brute[2])}, H scaled {h_rel:.2e}); kernel alone "
          f"(profiler) {alone:.4f} ms against its first form's {v1_alone:.4f}; wrappers "
          f"in turns {t['new']:.4f} against {t['v1']:.4f} ms; over the {need} pairs of "
          f"the live tiles ({100 * need / (n * m):.2f} % of Q·M) issue-rate floor "
          f"{issue_floor_ms(need, sms):.4f} ms on {card}")
    return {"max_abs_err": h_err, "ms": alone, "pairs": need}


def phase_map(scans, poses, rng, dev, card, sample=8192, lib_chunk=2048):
    """K4, K5, K6 and K1's score form against their plain versions and their
    scan-scale siblings, then the map-scale path."""
    print("== phase 8: map", flush=True)
    k = K_NEIGHBORS
    nf = SUBMAP_FRAMES
    records = {}
    subs = [PointCloud.from_points(world_cloud(scans[i * nf:(i + 1) * nf],
                                               poses[i * nf:(i + 1) * nf]), device=dev)
            for i in range(2)]
    sub = subs[0]
    pts, num, ns = sub.points, sub.num_points, int(sub.num_points)
    print(f"submaps of {[int(s.num_points) for s in subs]} rows ({nf} raw frames each "
          "in the world frame)")
    check(cov_layout(ns) == "ti" and ns <= 1_048_576, "a submap is not at K4's scale")

    # K4 on both submaps (with the sort given the wrapper is the launch
    # alone) against its first form on every row and against the plain
    # version on sampled rows, 256 at a time: a [rows, 864k] distance block.
    k4_err = 0.0  # max |Δd²| over the sampled rows
    for si, s_cloud in enumerate(subs):
        s_pts, s_num, s_ns = s_cloud.points, s_cloud.num_points, int(s_cloud.num_points)
        s_tgt = pruned_prepare_target(s_pts, s_num)
        for kk in (20, k):
            dn, i_n = knn_topk_idx(s_pts, s_num, kk, target=s_tgt)
            do, io = _knn_topk_idx_v1(s_tgt, s_num, kk)
            check(torch.equal(dn, do) and torch.equal(i_n, io),
                  f"K4 differs from its first form on submap {si}, k={kk}")
        pick = torch.as_tensor(
            np.sort(rng.choice(s_ns, size=min(sample, s_ns), replace=False)), device=dev)
        for s0 in range(0, len(pick), 256):
            rows = pick[s0:s0 + 256]
            dp, ip = knn_topk_idx_plain(s_pts, s_num, k, rows=rows)
            k4_err = max(k4_err, (dn[rows] - dp).abs().max().item())
            check(torch.equal(dn[rows], dp) and torch.equal(i_n[rows], ip),
                  f"K4 differs from its plain version on submap {si}")
        check(launches_per_call(knn_topk_idx, lambda: knn_topk_idx(
            s_pts, s_num, k, target=s_tgt)) == 1, "K4 launched other than once a call")
        del s_tgt, dn, i_n, do, io
    print(f"K4 knn_topk_idx on both submaps: (d², idx) equal to the first form on every "
          f"row (k = {k}, 20) and to the plain version on {min(sample, ns)} sampled rows "
          f"of each (max |Δd²| {k4_err:.1e} there, the record's max_abs_err); one launch "
          "a call")
    ptgt = pruned_prepare_target(pts, num)
    d4, i4 = knn_topk_idx(pts, num, k, target=ptgt)
    pick = torch.as_tensor(np.sort(rng.choice(ns, size=min(256, ns), replace=False)),
                           device=dev)
    check(bool((i4[:, 0].long() == torch.arange(ns, device=dev)).all()),
          "K4 does not find each row first")
    # Against K3 forced on the same submap: the same neighbours (counts and,
    # through the kth distance, the lists' ends), the sums in another order.
    t0 = time.perf_counter()
    kept = []
    k3_big_ms = time_ms(lambda: kept.append(knn_moments_rows(pts, num, k)), reps=1,
                        warm=False)
    rows3 = kept.pop()
    m1, m2, cnt = knn_moments(pts, num, k, layout="ti")
    check(torch.equal(cnt, rows3[:, 9]) and torch.equal(d4[:, k - 1], rows3[:, 10]),
          "K4 and K3 choose different neighbours on a submap")
    got9 = torch.cat([m1, m2.reshape(-1, 9)[:, [0, 1, 2, 4, 5, 8]]], dim=1)
    diff = (got9 - rows3[:, :9]).abs()
    excess = (diff - 1e-5 * rows3[:, :9].abs()).max().item()
    print(f"K4 against K3 forced at {ns} rows, k={k} (one run, {k3_big_ms:.1f} ms, "
          f"{time.perf_counter() - t0:.1f} s wall): counts and d_k equal, max |Δ moments| "
          f"{diff.max().item():.3e} (tolerance 1e-4 + 1e-5·|m|: float32 sums of k products)")
    check(excess <= 1e-4, "K4's moments differ from K3's")
    del rows3, m1, m2, got9, diff
    self_q = PrunedQueries(qperm=ptgt.tperm[:ns], qkey=None)
    need = pruned_pairs(ptgt, self_q, pts[:ns], d4[:, k - 1], ns)
    chunk = pts[:lib_chunk, :3].contiguous()
    all_rows = pts[:ns, :3].contiguous()
    lib_ms = time_ms(lambda: torch.topk(torch.cdist(chunk, all_rows), k, largest=False),
                     reps=3) * ns / lib_chunk
    plain_ms = time_ms(lambda: knn_topk_idx_plain(pts, num, k, rows=pick),
                       reps=3) * ns / len(pick)
    launch = lambda: knn_topk_idx(pts, num, k, target=ptgt)
    first = lambda: _knn_topk_idx_v1(ptgt, num, k)
    k4 = time_turns({"launch": launch, "first form": first})
    k4["alone"] = one_kernel_per_call(launch, r"knn_topk_idx_kernel(?!_v1)")
    k4["first form alone"] = one_kernel_per_call(first, "knn_topk_idx_kernel_v1")
    k4["search"] = time_ms(lambda: knn_topk_idx(pts, num, k), reps=None)
    k4["moments"] = time_ms(lambda: knn_moments(pts, num, k, layout="ti"), reps=None)
    full_ms, full_by = search_bound(ns, ns, k)
    records["knn_topk_idx"] = dict(
        max_abs_err=k4_err, ms=k4["alone"], plain_ms=plain_ms, library_ms=lib_ms,
        pairs=need, bound=search_bound(ns, ns, k, need))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if \
        dev.type == "cuda" else 132
    print(f"K4 at {ns} rows: kernel alone (profiler, {REPS} calls, one kernel a call) "
          f"{k4['alone']:.4f} ms, its first form alone {k4['first form alone']:.4f} ms; "
          f"in turns (CUDA events around one launch) {k4['launch']:.4f} against "
          f"{k4['first form']:.4f} ms; over {need} needed pairs "
          f"({100 * need / (ns * ns):.3f} % of N², bound "
          f"{records['knn_topk_idx']['bound'][0]:.4f} ms by operations, issue-rate floor "
          f"{issue_floor_ms(need, sms):.4f} ms; over all N² pairs "
          f"{full_ms:.3f} ms by {full_by}); with its sort {k4['search']:.3f} ms, "
          f"with the torch moment sums {k4['moments']:.3f} ms; K3 forced "
          f"{k3_big_ms:.1f} ms; plain and library (cdist + topk) timed on {len(pick)} / "
          f"{lib_chunk} queries and scaled: {plain_ms:.0f} / {lib_ms:.0f} ms on {card}")
    before = (knn_topk_idx.launches, knn_moments_rows.launches)
    sub_covs = [estimate_covariances(s, num_neighbors=k) for s in subs]
    check(knn_topk_idx.launches == before[0] + 2
          and knn_moments_rows.launches == before[1],
          "estimate_covariances of a submap does not go through K4 alone")

    # K5 at the scan shape and at raw-scan scale, k = 10 and 20, over the
    # cloud's kept sort: against its plain version (every row at the scan
    # shape, `sample` rows at raw-scan scale), and bit for bit against itself
    # with the sort made in the call, K3 over the same sort and its first form
    # (the original port); one launch a call; timed alone (the profiler) and in
    # turns with K3 and the first form, bounded by the pairs its box walk
    # cannot avoid. Then K3 against K4 at the scan shape.
    scan_t, tree = preprocess_points(scans[2 * nf - 1], LEAF, num_neighbors=k, device=dev)
    raw = PointCloud.from_points(scans[0], device=dev)
    raw_kept = KdTree(points=raw.points, num_points=raw.num_points).pruned_target()
    team = cov_fused_cuda.MOMENTS_Q_TEAM
    for cloud, label, kept in ((scan_t, "scan shape", tree.pruned_target()),
                               (raw, "raw-scan scale", raw_kept)):
        cp, cn, m = cloud.points, cloud.num_points, int(cloud.num_points)
        rows = None if m <= 32768 else torch.as_tensor(
            np.sort(rng.choice(m, size=sample, replace=False)), device=dev)
        for kk in (k, 20):
            new5 = lambda: knn_moments_rows_q(cp, cn, kk, target=kept)  # noqa: E731
            old5 = lambda: _knn_moments_rows_q_v1(cp, cn, kk)  # noqa: E731
            k3n = lambda: knn_moments_rows(cp, cn, kk, target=kept)  # noqa: E731
            got = new5()
            ref = knn_moments_rows_q_plain(cp, cn, kk, rows=rows)
            sel = got if rows is None else got[rows]
            check(torch.equal(sel[:, 9:11], ref[:, 9:11]),
                  f"K5 neighbour counts or kth distances differ at {label}, k={kk}")
            err = (sel[:, :9] - ref[:, :9]).abs()
            check((err - 1e-5 * ref[:, :9].abs()).max().item() <= 1e-4,
                  f"K5 moments differ from the plain version at {label}, k={kk}")
            check(torch.equal(got, knn_moments_rows_q(cp, cn, kk)),
                  f"K5 with its sort made in the call differs at {label}, k={kk}")
            check(torch.equal(got, k3n()), f"K5's rows differ from K3's at {label}, k={kk}")
            check(torch.equal(got, old5()),
                  f"K5 differs from its first form at {label}, k={kk}")
            check(bool(torch.all(got[m:] == 0)), "K5 padding rows are not zero")
            check(launches_per_call(knn_moments_rows_q, new5) == 1,
                  "K5 launched other than once a call")
            t5 = time_turns({"K5": new5, "first form": old5, "K3": k3n,
                             "K5, sorting": lambda: knn_moments_rows_q(cp, cn, kk)},
                            reps=REPS if rows is None else 5)
            t5["alone"] = one_kernel_per_call(new5, "knn_moments_warp_walk_kernel")
            t5["first form alone"] = one_kernel_per_call(old5, "knn_moments_warp_kernel_v1")
            t5["K3 alone"] = one_kernel_per_call(k3n, r"knn_moments_kernel(?!_v1)")
            self_q = PrunedQueries(qperm=kept.tperm[:m], qkey=None)
            need = pruned_pairs(kept, self_q, cp[:m], got[:, 10], m, block=64 // team)
            nbytes = 16.0 * m + 64.0 * cloud.capacity
            b5 = bound(9.0 * need + 9.0 * kk * m, nbytes)
            full_ms, full_by = bound(9.0 * m * m + 9.0 * kk * m, nbytes)
            print(f"K5 knn_moments_q at {label} ({m} rows), k={kk}, {team} lanes a query: "
                  f"counts and d_k equal to the plain version"
                  f"{'' if rows is None else f' on {len(rows)} sampled rows'}, max "
                  f"|Δ moments| {err.max().item():.3e}; every row equal to K3's, to its "
                  f"first form's and to its own with the sort made in the call; one "
                  f"launch a call; kernel alone {t5['alone']:.4f} ms, its first form "
                  f"{t5['first form alone']:.4f} ms, K3 {t5['K3 alone']:.4f} ms; in turns "
                  f"(events) {t5['K5']:.4f} / {t5['first form']:.4f} / {t5['K3']:.4f} ms, "
                  f"{t5['K5, sorting']:.4f} ms with its sort made in the call; over the "
                  f"{need} pairs a pruned search of {64 // team}-query blocks cannot avoid "
                  f"({100 * need / (m * m):.2f} % of N²) bound {b5[0]:.4f} ms by {b5[1]}, "
                  f"issue-rate floor {issue_floor_ms(need):.4f} ms; over all N² pairs "
                  f"{full_ms:.4f} ms by {full_by} on {card}")
            if label == "scan shape" and kk == k:
                t1 = cp[:m, :3].contiguous()
                records["knn_moments_q"] = dict(
                    max_abs_err=err.max().item(), ms=t5["alone"],
                    plain_ms=time_ms(lambda: knn_moments_rows_q_plain(cp, cn, kk), reps=3),
                    library_ms=time_ms(
                        lambda: torch.topk(torch.cdist(t1, t1), kk, largest=False), reps=3),
                    pairs=need, bound=b5)
    m = int(scan_t.num_points)
    stgt = pruned_prepare_target(scan_t.points, scan_t.num_points)
    print(f"K3 against K4 at the scan shape ({m} rows, k={k}): K3 "
          f"{time_ms(lambda: knn_moments_rows(scan_t.points, scan_t.num_points, k)):.3f} "
          f"ms; K4 launch alone "
          f"{time_ms(lambda: knn_topk_idx(scan_t.points, scan_t.num_points, k, target=stgt)):.3f} ms, "
          f"with its sort and the moment sums "
          f"{time_ms(lambda: knn_moments(scan_t.points, scan_t.num_points, k, layout='ti')):.3f}"
          f" ms on {card}")

    # The map and the scan to register against it.
    map_cloud = PointCloud(
        points=torch.cat([c.points[:int(c.num_points)] for c in sub_covs]),
        num_points=sum(c.num_points for c in sub_covs).to(torch.int32),
        covs=torch.cat([c.covs[:int(c.num_points)] for c in sub_covs]))
    mm = int(map_cloud.num_points)
    source, _ = preprocess_points(scans[2 * nf], LEAF, num_neighbors=k, device=dev)
    n = int(source.num_points)
    T_map = poses[2 * nf]  # the map is in the world frame
    T = torch.as_tensor(noisy_guess(T_map, rng), dtype=torch.float32, device=dev)
    print(f"map of {mm} rows ({mm * 64 / 1e6:.0f} MB of table); source frame "
          f"{2 * nf}: {n} points")

    # K6 on the map against its plain version and against K1 forced.
    tables = gicp_prepare(map_cloud.points, map_cloud.num_points, source.points,
                          source.num_points, "gicp", map_cloud.covs, source.covs)
    check(tables.route == "swept", "a 1.7 M-row target does not take the swept route")
    out6 = gicp_linearize_tables(tables, T, MAX_DIST_SQ)
    t0 = time.perf_counter()
    ref6 = gicp_linearize_swept_plain(tables, T, MAX_DIST_SQ)
    torch.cuda.synchronize()
    plain6_ms = (time.perf_counter() - t0) * 1e3
    h_err = check_linearize("K6 gicp_linearize_swept (map)", out6, ref6, n, True)
    map_chunks = swept_checks("the map", tables, T, n)
    out1 = gicp_linearize_tables(tables, T, MAX_DIST_SQ, route="listed")
    mask = out6[3][:, 12] > 0.5
    check(torch.equal(mask, out1[3][:, 12] > 0.5) and int(out6[2]) == int(out1[2]),
          "K6 and K1 accept different rows on the map")
    check(torch.equal(out6[3][mask], out1[3][mask]),
          "K6's μ, W, d² differ from K1's on accepted rows")
    check(bool(torch.all(out6[3][~mask][:, :13] == 0)),
          "K6's rows without a correspondence are not zero")
    # Block sums: 64 float32 additions per block, over other groups of rows.
    h61 = ((out6[0] - out1[0]).abs().max() / out1[0].abs().max().clamp(min=1.0)).item()
    b61 = ((out6[1] - out1[1]).abs().max() / out1[1].abs().max().clamp(min=1.0)).item()
    check(h61 <= 1e-5 and b61 <= 1e-5, f"K6's H or b differ from K1's ({h61}, {b61})")
    live = swept_live_tiles(tables, T, MAX_DIST_SQ)
    need = swept_pairs(tables, live)
    print(f"K6 against K1 forced on the same tables: masks equal, μ/W/d² equal on "
          f"{int(mask.sum())} accepted rows, H scaled {h61:.2e}, b scaled {b61:.2e} "
          f"(tol 1e-5: float32 block sums); {100 * (1 - live.float().mean().item()):.2f} "
          f"% of {live.numel()} (block, tile) pairs skipped; needed pairs {need} = "
          f"{100 * need / (n * mm):.3f} % of Q·M")
    tq = (source.points[:lib_chunk, :3] @ T[:3, :3].T + T[:3, 3]).contiguous()
    tt = map_cloud.points[:mm, :3].contiguous()
    ops = 9.0 * need + 400.0 * n
    # the sorted rows and boxes of the live tiles once; every source row read
    # (qtab) and written (corr); one payload row per accepted source row
    live_rows = float((live.any(dim=0).double() * TILE_ROWS).sum().item())
    nbytes = (16.0 + 32.0 / TILE_ROWS) * live_rows + 64.0 * 2 * source.capacity \
        + 64.0 * n + 4.0 * source.capacity + 4.0 * 44 * ((source.capacity + 63) // 64)
    k6_new = lambda: gicp_linearize_tables(tables, T, MAX_DIST_SQ)
    k6_old = lambda: _gicp_linearize_swept_v1(tables, T, MAX_DIST_SQ)
    k6 = time_turns({"wrapper": k6_new, "first form": k6_old})
    # The wrapper's torch ops (the pose, the float64 sum) launch kernels of
    # their own: one K6 a call, other device work allowed.
    k6_alone = one_kernel_per_call(k6_new, r"gicp_linearize_swept_kernel(?!_v1)",
                                   alone=False)
    k6_old_alone = one_kernel_per_call(k6_old, "gicp_linearize_swept_kernel_v1",
                                       alone=False)
    k1_map_ms = time_ms(lambda: gicp_linearize_tables(tables, T, MAX_DIST_SQ,
                                                      route="listed"), reps=None)
    full_ms, full_by = bound(9.0 * n * mm + 400.0 * n, 64.0 * (mm + 2 * source.capacity))
    records["gicp_linearize_swept"] = dict(
        max_abs_err=h_err, ms=k6_alone, plain_ms=plain6_ms,
        library_ms=time_ms(lambda: torch.cdist(tq, tt).min(dim=1), reps=3) * n / lib_chunk,
        pairs=need, bound=bound(ops, nbytes))
    print(f"K6 on the map ({n} × {mm}, {map_chunks['plan']} chunks a source block): "
          f"kernel alone (profiler, {REPS} calls, one kernel a call) {k6_alone:.4f} ms, "
          f"its first form alone {k6_old_alone:.4f} ms; wrappers in turns (CUDA events "
          f"around one call) {k6['wrapper']:.4f} against {k6['first form']:.4f} ms; bound "
          f"{records['gicp_linearize_swept']['bound'][0]:.4f} ms by "
          f"{records['gicp_linearize_swept']['bound'][1]} over the needed pairs, "
          f"issue-rate floor {issue_floor_ms(need, sms):.4f} ms; over "
          f"all Q·M pairs {full_ms:.3f} ms by {full_by}; K1 forced {k1_map_ms:.3f} ms; "
          f"plain {plain6_ms:.0f} ms (one run, host clock); library cdist + min timed "
          f"on {lib_chunk} queries and scaled on {card}")
    del tt, out1, ref6
    # What gicp_prepare costs an align against the map, and how much of it
    # the target's kept sort and boxes save.
    prep_args = (map_cloud.points, map_cloud.num_points, source.points,
                 source.num_points, "gicp", map_cloud.covs, source.covs)
    map_sorted = pruned_prepare_target(map_cloud.points, map_cloud.num_points)
    with_kept = gicp_prepare(*prep_args, target=map_sorted)
    check(with_kept.route == "swept" and all(
        torch.equal(getattr(with_kept, f), getattr(tables, f))
        for f in ("ttab", "qtab", "tsorted", "tbox", "sperm")),
        "gicp_prepare with the target's kept sort builds other tables")
    prep = {
        "whole": time_ms(lambda: gicp_prepare(*prep_args)),
        "target's sort and boxes": time_ms(
            lambda: pruned_prepare_target(map_cloud.points, map_cloud.num_points)),
        "with them kept": time_ms(lambda: gicp_prepare(*prep_args, target=map_sorted)),
        "listed route": time_ms(lambda: gicp_prepare(*prep_args, route="listed")),
    }
    print(f"gicp_prepare against the map ({mm} rows): "
          + ", ".join(f"{key} {v:.3f} ms" for key, v in prep.items())
          + f" (CUDA events, median of {REPS}) on {card}")
    del with_kept, map_sorted

    # K1 and K6 at the scan shape, and K1's score form there.
    scan_tables = gicp_prepare(scan_t.points, scan_t.num_points, source.points,
                               source.num_points, "gicp", scan_t.covs, source.covs,
                               route="swept")
    T_rel = np.linalg.inv(poses[2 * nf - 1]) @ poses[2 * nf]
    Ts = torch.as_tensor(noisy_guess(T_rel, rng), dtype=torch.float32, device=dev)
    o6 = gicp_linearize_tables(scan_tables, Ts, MAX_DIST_SQ)
    o1 = gicp_linearize_tables(scan_tables, Ts, MAX_DIST_SQ, route="listed")
    msk = o1[3][:, 12] > 0.5
    check(torch.equal(msk, o6[3][:, 12] > 0.5) and torch.equal(o6[3][msk], o1[3][msk]),
          "K6 and K1 differ at the scan shape")
    scan_chunks = swept_checks("the scan shape", scan_tables, Ts, n)
    s_live = swept_live_tiles(scan_tables, Ts, MAX_DIST_SQ)
    s_need = swept_pairs(scan_tables, s_live)
    s6 = time_turns({
        "K1": lambda: gicp_linearize_tables(scan_tables, Ts, MAX_DIST_SQ, route="listed"),
        "K6": lambda: gicp_linearize_tables(scan_tables, Ts, MAX_DIST_SQ),
        "K6 first form": lambda: _gicp_linearize_swept_v1(scan_tables, Ts, MAX_DIST_SQ)})
    s6_alone = one_kernel_per_call(
        lambda: gicp_linearize_tables(scan_tables, Ts, MAX_DIST_SQ),
        r"gicp_linearize_swept_kernel(?!_v1)", alone=False)
    s6_old_alone = one_kernel_per_call(
        lambda: _gicp_linearize_swept_v1(scan_tables, Ts, MAX_DIST_SQ),
        "gicp_linearize_swept_kernel_v1", alone=False)
    print(f"K1 against K6 at the scan shape ({n} × {m}, {scan_chunks['plan']} chunks a "
          f"source block), wrappers in turns: K1 {s6['K1']:.4f} ms, K6 {s6['K6']:.4f} ms, "
          f"K6's first form {s6['K6 first form']:.4f} ms; kernels alone (profiler) K6 "
          f"{s6_alone:.4f} ms, its first form {s6_old_alone:.4f} ms; "
          f"{100 * (1 - s_live.float().mean().item()):.1f} % of (block, tile) pairs "
          f"skipped, {s_need} needed pairs (issue-rate floor "
          f"{issue_floor_ms(s_need, sms):.4f} ms) on {card}")

    outs = gicp_linearize_tables(scan_tables, Ts, MAX_DIST_SQ, route="listed",
                                 mxu_dist=True)
    score_rec = score_checks(scan_tables, Ts, outs, n, sms, card)
    # Score form against difference form, both the brute-force first forms
    # (which keep every row's nearest row). The uncentred score ‖t‖² − 2 t·q
    # of a row carries a rounding error of up to 2·2⁻²³·(|q| + |t|)², so
    # between two rows it may prefer the one whose true d² is larger by twice
    # that. Each query gets that tolerance from its own norm and its
    # winners': the winners' d² agree within it, and the rows are equal
    # wherever the runner-up (K10, k = 2) is farther than it. The new score
    # form zeroes rejected rows, so the rows compared are those it accepts.
    o1 = _gicp_linearize_v1(scan_tables, Ts, MAX_DIST_SQ)
    q = (source.points @ Ts.T)[:n, :3].contiguous()
    mu_s, mu_d = outs[3][:n, :3], o1[3][:n, :3]
    found = (outs[3][:n, 13] < 1e16) & (o1[3][:n, 13] < 1e16)
    tol = 4.0 * 2.0 ** -23 * (q.norm(dim=1) + torch.maximum(mu_s.norm(dim=1),
                                                           mu_d.norm(dim=1))) ** 2
    delta = (outs[3][:n, 13] - o1[3][:n, 13]).abs()
    check(bool((delta[found] <= tol[found]).all()),
          "the score form's d² differs from the difference form's beyond its rounding")
    d2nd, _ = knn(scan_t.points, scan_t.num_points, q, 2)
    clear = found & (d2nd[:, 1] - d2nd[:, 0] > tol)
    same = (mu_s == mu_d).all(dim=1)
    check(bool(same[clear].all()), "score and difference form pick different rows")
    clear_share = clear.sum().item() / max(1, found.sum().item())
    check(clear_share >= 0.9, "too few rows have a clear runner-up")
    check(abs(int(outs[2]) - int(o1[2])) <= 0.001 * int(o1[2]),
          "score and difference form disagree on the inliers")
    print(f"score form against difference form, tolerance per query "
          f"4·2⁻²³·(|q|+|t|)² (median {tol.median().item():.3e}, max "
          f"{tol.max().item():.3e}): largest |Δd²|/tolerance "
          f"{(delta[found] / tol[found]).max().item():.3f}; rows equal on "
          f"{int(clear.sum())} accepted rows with a clear runner-up "
          f"({100 * clear_share:.1f} %); {int((~same & found).sum())} of "
          f"{n} rows differ ({100 * (~same & found).float().mean().item():.3f} %); "
          f"inliers {int(outs[2])} against {int(o1[2])}")
    ttq = scan_t.points[:m, :3].contiguous()
    records["gicp_linearize_score"] = dict(
        score_rec,
        plain_ms=time_ms(lambda: gicp_linearize_score_plain(scan_tables, Ts, MAX_DIST_SQ),
                         reps=3),
        library_ms=time_ms(lambda: torch.cdist(q, ttq).min(dim=1), reps=3),
        bound=bound(9.0 * score_rec["pairs"] + 400.0 * n,
                    64.0 * (m + 2 * source.capacity)
                    + 4.0 * 44 * ((source.capacity + 63) // 64)))

    # The map-scale path, counted from zero.
    for _, _, _, fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    covs = [estimate_covariances(s, num_neighbors=k) for s in subs]
    torch.cuda.synchronize()
    t_cov = time.perf_counter() - t0
    check(knn_topk_idx.launches == 2 and knn_moments_rows.launches == 0,
          "the submaps' covariances did not go through K4")
    the_map = PointCloud(
        points=torch.cat([c.points[:int(c.num_points)] for c in covs]),
        num_points=sum(c.num_points for c in covs).to(torch.int32),
        covs=torch.cat([c.covs[:int(c.num_points)] for c in covs]))
    init = noisy_guess(T_map, rng)
    t0 = time.perf_counter()
    res = align(the_map, source, init_T_target_source=init)
    torch.cuda.synchronize()
    t_align = time.perf_counter() - t0
    r = result_to_numpy(res)
    rot, trans = pose_error(r["T_target_source"], T_map)
    counts = {name: KERNELS[name][3].launches for name in KERNELS}
    print(f"covariances of two submaps {t_cov:.3f} s; align against the map "
          f"{t_align:.3f} s: iterations {r['iterations']} converged {r['converged']} "
          f"inliers {r['num_inliers']}; pose error {rot:.4f} deg, {trans:.4f} m "
          "(bounds 2.5 deg, 0.2 m)")
    check(np.isfinite(r["T_target_source"]).all(), "non-finite pose against the map")
    check(rot < 2.5 and trans < 0.2, "registration against the map outside the bounds")
    check(counts["gicp_linearize_swept"] == r["iterations"] + 1,
          f"K6 launches {counts['gicp_linearize_swept']} != iterations + 1")
    check(counts["gicp_lm_step"] == r["iterations"] + 1,
          f"step kernel launches {counts['gicp_lm_step']} != iterations + 1")
    check(counts["gicp_linearize"] == 0, "the map align launched K1")
    m1q, _, _ = knn_moments(scan_t.points, scan_t.num_points, k, layout="q",
                            target=tree.pruned_target())
    check(bool(torch.isfinite(m1q).all()), "layout q moments not finite")
    Hs, _, inl_s, _ = gicp_linearize_tables(scan_tables, Ts, MAX_DIST_SQ,
                                            route="listed", mxu_dist=True)
    check(bool(torch.isfinite(Hs).all()) and int(inl_s) > n // 2,
          "the score-form linearization is off")
    launches = {name: KERNELS[name][3].launches for name in MAP_KERNELS}
    print(f"launches on the map-scale path: {launches}, gicp_lm_step "
          f"{counts['gicp_lm_step']}, gicp_linearize {counts['gicp_linearize']}")
    check(all(v > 0 for v in launches.values()), "a map-scale kernel was not launched")

    # ms per registration against the map: swept (the default: the map
    # sorted and boxed anew by every align), swept with a KdTree over the map
    # that keeps its sort and boxes, and K1 forced.
    n_regs = 3
    map_tree = KdTree.build(the_map)
    map_tree.pruned_target()
    routes = {"swept": {}, "swept, sort kept": {"target_tree": map_tree},
              "listed": {"fused_route": "listed"}}
    per_reg = {route: [] for route in routes}
    for _ in range(n_regs):
        g = noisy_guess(T_map, rng)
        poses_out = {}
        for route, kwargs in routes.items():
            before = gicp_linearize_swept.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = align(the_map, source, init_T_target_source=g, **kwargs)
            torch.cuda.synchronize()
            per_reg[route].append((time.perf_counter() - t0) * 1e3)
            poses_out[route] = out.T_target_source
            rot, trans = pose_error(out.T_target_source.cpu().numpy(), T_map)
            check(rot < 2.5 and trans < 0.2,
                  f"a timed {route} registration against the map left the bounds")
            check((gicp_linearize_swept.launches > before) == (route != "listed"),
                  f"a timed {route} registration took the other route")
        check(torch.equal(poses_out["swept"], poses_out["swept, sort kept"]),
              "the kept sort changes the registration")
    print("time per registration against the map (host clock, table preparation "
          "included): "
          + ", ".join(f"{route} {np.median(v):.2f} ms" for route, v in per_reg.items())
          + f" ({n_regs} aligns each, alternating) on {card}")

    # The path through K4 and K6 against the same path through their first
    # forms, in turns: the covariances of both submaps, and the align against
    # the map with its sort kept.
    g = noisy_guess(T_map, rng)
    covs_new = lambda: [estimate_covariances(s, num_neighbors=k) for s in subs]
    align_new = lambda: align(the_map, source, init_T_target_source=g,
                              target_tree=map_tree)

    def with_first_forms(fn):
        def run():
            with first_forms_map():
                return fn()
        return run

    a_new, a_old = align_new(), with_first_forms(align_new)()
    check(torch.equal(a_new.T_target_source, a_old.T_target_source),
          "the align through the first forms gives another pose")
    c_new, c_old = covs_new(), with_first_forms(covs_new)()
    check(all(torch.equal(x.covs, y.covs) for x, y in zip(c_new, c_old)),
          "the covariances through the first forms differ")
    path = host_turns({"covariances": covs_new,
                       "covariances, first forms": with_first_forms(covs_new),
                       "align, sort kept": align_new,
                       "align, sort kept, first forms": with_first_forms(align_new)},
                      reps=5)
    print("the map-scale path against the same path through K4's and K6's first forms "
          "(host clock around a synchronize, median of 5 in turns; the same poses and "
          "covariances): " + ", ".join(f"{key} {v:.2f} ms" for key, v in path.items())
          + f"; align {int(a_new.iterations)} iterations on {card}")
    # Where the align's time goes: device time (device events once) against
    # wall time, and K6's share, through either form, by torch.profiler.
    from torch.profiler import ProfilerActivity, profile

    for label, fn in (("new", align_new), ("first forms", with_first_forms(align_new))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        k6_dev = sum(e.self_device_time_total for e in events
                     if "gicp_linearize_swept_kernel" in e.key) / 1e3
        print(f"profiled align against the map, sort kept, {label}: device busy "
              f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
              f"({100 * busy_ms / wall_ms:.1f} % busy), K6 {k6_dev:.3f} ms of it, "
              f"{sum(e.count for e in events)} device events on {card}")
    return records, launches


# ------------------------------------------------------------- phase 9 ----

VOXEL_LEAF = 1.0
GVM_SLOTS = 131072
IVM_SLOTS = 131072
IVM_VOXELS = 32768


@contextlib.contextmanager
def counting_plain_step():
    """Count the calls of the plain LM step (its CPU form, and the float64
    unfused route's) inside the block: a list that grows by one a call."""
    calls = []
    real = lm_step.gicp_lm_step_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    lm_step.gicp_lm_step_plain = registration.gicp_lm_step_plain = counted
    try:
        yield calls
    finally:
        lm_step.gicp_lm_step_plain = registration.gicp_lm_step_plain = real


def no_host_sync(fn):
    """``fn()`` under torch's sync debug mode "error": a call that makes the
    host wait for the card raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _profile_once(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return out, prof, wall


def profiled(fn):
    """(result, api_counts, device busy ms, wall ms, device events) of one
    call of ``fn`` under torch.profiler, after a warm-up window; the API
    counts less those of an empty call in the same harness (its closing
    synchronize)."""
    _profile_once(fn)
    empty = api_counts(_profile_once(lambda: None)[1])
    out, prof, wall = _profile_once(fn)
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    api = {k: v - empty[k] for k, v in api_counts(prof).items()}
    return out, api, busy, wall, events


def _row_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a − b| of a row over the row's largest |b|, over all rows."""
    if a.numel() == 0:
        return 0.0
    a, b = a.reshape(a.shape[0], -1).double(), b.reshape(b.shape[0], -1).double()
    return float(((a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1e-30)).max())


def same_map(card_map, cpu_map, what: str) -> float:
    """The card's map against the plain account of the same inserts on CPU
    tensors: keys, slots, occupancy, stamps, counts and the directory's live
    entries equal; payload rows of live slots within 1e-6 of their row's
    largest entry. Returns that relative error."""
    c = {f: getattr(card_map, f).cpu() for f in ("vox_keys", "dir_keys", "dir_vals",
                                                  "num_voxels", "lru_counter")}
    for f, v in c.items():
        nv = int(c["num_voxels"])
        if f in ("dir_keys", "dir_vals"):
            check(torch.equal(v[:nv], getattr(cpu_map, f)[:nv]), f"{what}: {f} differ")
        else:
            check(torch.equal(v, getattr(cpu_map, f)), f"{what}: {f} differ")
    live = c["vox_keys"] != INVALID_KEY
    if isinstance(card_map, GaussianVoxelMap):
        check(torch.equal(card_map.lru.cpu()[live], cpu_map.lru[live]), f"{what}: stamps")
        pay_c, pay_p = card_map.payload.cpu()[live], cpu_map.payload[live]
        check(torch.equal(pay_c[:, 13], pay_p[:, 13]), f"{what}: counts differ")
    else:
        for f in ("occ", "num_points_stored"):
            check(torch.equal(getattr(card_map, f).cpu(), getattr(cpu_map, f)),
                  f"{what}: {f} differ")
        check(torch.equal(card_map.stamps.cpu()[live], cpu_map.stamps[live]),
              f"{what}: stamps")
        rows = card_map.valid_points_mask().cpu()
        pay_c, pay_p = card_map.payload.cpu()[rows], cpu_map.payload[rows]
    rel = _row_rel(pay_c, pay_p)
    check(rel <= 1e-6, f"{what}: payload rows {rel:.2e} apart (> 1e-6)")
    return rel


def same_search(card, plain, what: str) -> float:
    """Indices and found flags equal, d² within 1e-6 relative."""
    d, i, f = (x.cpu() for x in card)
    dp, ip, fp = plain
    check(torch.equal(i, ip) and torch.equal(f, fp), f"{what}: rows differ")
    rel = float(((d.double() - dp.double()).abs() / dp.double().abs().clamp(min=1e-30))
                [fp].max()) if bool(fp.any()) else 0.0
    check(rel <= 1e-6, f"{what}: d² {rel:.2e} apart (> 1e-6)")
    return rel


def phase_voxel(scans, poses, rng, dev, card):
    """Phase 9: VGICP on the scan pair, both voxel maps over the 17 frames at
    their poses, searches and the aligns of frame 16 against them, each map
    operation held against the plain account on CPU tensors."""
    print("== phase 9: voxel maps", flush=True)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    for _, _, _, fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    frames = [preprocess_points(sc, LEAF, num_neighbors=K_NEIGHBORS, device=dev)[0]
              for sc in scans]
    (target, tree), source = preprocess_points(scans[0], LEAF, num_neighbors=K_NEIGHBORS,
                                               device=dev), frames[1]
    torch.cuda.synchronize()
    print(f"preprocessed {len(frames)} frames in {time.perf_counter() - t0:.2f} s "
          f"({[int(f.num_points) for f in frames]} points), K3 "
          f"{knn_moments_rows.launches} launches")
    check(knn_moments_rows.launches == len(scans) + 1,
          "preprocessing did not run K3 once a cloud")

    # VGICP on the scan pair, LM, from noisy starts.
    with counting_plain_step() as plain_calls:
        gvm = create_gaussian_voxelmap(target, VOXEL_LEAF)
        res = align(gvm, source, init_T_target_source=noisy_guess(T_gt, rng))
        rot, trans = pose_error(res.T_target_source.cpu().numpy(), T_gt)
        its = int(res.iterations) + 1
        print(f"VGICP on the scan pair ({int(gvm.num_voxels)} voxels of "
              f"{gvm.capacity} slots): {its - 1} iterations, converged "
              f"{bool(res.converged)}, pose error {rot:.4f} deg, {trans:.4f} m "
              "(bounds 2.5 deg, 0.2 m)")
        check(rot < 2.5 and trans < 0.2, "VGICP outside the reference bounds")
        check(gicp_lm_step.launches == its and gicp_linearize_tables.launches == 0,
              f"VGICP launched the step {gicp_lm_step.launches} times in {its} "
              "iterations (or K1)")
        # Registrations/s in turns with phase 5's GICP align, the same guesses.
        n_regs = 5
        paths = {"GICP (phase 5's path)":
                 lambda g: align(target, source, tree, init_T_target_source=g),
                 "VGICP": lambda g: align(gvm, source, init_T_target_source=g)}
        per = {k: [] for k in paths}
        iters = {k: [] for k in paths}
        for fn in paths.values():  # one untimed call each
            fn(noisy_guess(T_gt, rng))
        for r in range(n_regs):
            g = noisy_guess(T_gt, rng)
            order = list(paths.items())
            for label, fn in order[r % 2:] + order[:r % 2]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(g)
                torch.cuda.synchronize()
                per[label].append(time.perf_counter() - t0)
                iters[label].append(int(out.iterations))
                rot, trans = pose_error(out.T_target_source.cpu().numpy(), T_gt)
                check(rot < 2.5 and trans < 0.2, f"a timed {label} align left the bounds")
        print("registrations/s in turns (the same noisy guesses, each path first in "
              "turn): " + ", ".join(f"{k} {n_regs / sum(v):.3f} (iterations {iters[k]})"
                                    for k, v in per.items()) + f" on {card}")
        # Launches, copies and host syncs a LM iteration, the step kernel by
        # the profiler's count, the busy share: three VGICP aligns.
        inits = [noisy_guess(T_gt, rng) for _ in range(3)]
        for attempt in range(3):
            done, api, busy, wall, events = profiled(
                lambda: [int(align(gvm, source, init_T_target_source=g).iterations) + 1
                         for g in inits])
            its = sum(done)
            steps = sum(e.count for e in events
                        if re.search(r"gicp_step_kernel<float, 1", e.key))
            if steps == its:
                break
            print(f"the profiler saw {steps} step kernels in {its} iterations; again")
        check(steps == its, f"{steps} step kernels in {its} VGICP iterations")
        print(f"profiled 3 VGICP aligns: {its} LM iterations, {steps} step kernels; "
              f"device busy {busy:.3f} ms of {wall:.3f} ms wall "
              f"({100 * busy / wall:.1f}% busy); per LM iteration "
              f"{api['launches'] / its:.2f} kernel launches, {api['copies'] / its:.2f} "
              f"copies, {api['memsets'] / its:.2f} memsets, {api['syncs'] / its:.2f} "
              f"host syncs (set-up and the result's read included) on {card}; "
              "top device time:")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
                  f"{e.key[:90]}")
    check(not plain_calls, f"the plain LM step ran {len(plain_calls)} times on the card")

    # Both maps over the sequence, each insert held against the plain account.
    Ts = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in poses]
    cpu_frames = [PointCloud(points=f.points.cpu(), num_points=f.num_points.cpu(),
                             covs=f.covs.cpu()) for f in frames]
    maps = {"gaussian": (GaussianVoxelMap.empty(VOXEL_LEAF, GVM_SLOTS, device=dev),
                         GaussianVoxelMap.empty(VOXEL_LEAF, GVM_SLOTS, device="cpu")),
            "incremental": (IncrementalVoxelMapCov(VOXEL_LEAF, IVM_SLOTS,
                                                   voxel_capacity=IVM_VOXELS, device=dev),
                            IncrementalVoxelMapCov(VOXEL_LEAF, IVM_SLOTS,
                                                   voxel_capacity=IVM_VOXELS, device="cpu"))}
    ins_ms = {k: [] for k in maps}
    rel = {k: 0.0 for k in maps}

    def insert_all(frames_idx):
        for i in frames_idx:
            for name, (m, mc) in maps.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                m = no_host_sync(lambda: m.insert(frames[i], Ts[i]))
                end.record()
                end.synchronize()
                ins_ms[name].append(start.elapsed_time(end))
                mc = mc.insert(cpu_frames[i], poses[i].astype(np.float32))
                rel[name] = max(rel[name], same_map(m, mc, f"{name} map, insert {i}"))
                maps[name] = (m, mc)

    last = len(frames) - 1
    insert_all(range(last))
    # Launches and host syncs of one insert: frame 15 again onto the map
    # before it (the maps are values), profiled.
    for name, (m, _) in maps.items():
        _, api, busy, wall, _ = profiled(lambda: m.insert(frames[last - 1], Ts[last - 1]))
        print(f"{name} map insert, profiled: {api['launches']} kernel launches, "
              f"{api['copies']} copies, {api['memsets']} memsets, {api['syncs']} host "
              f"syncs; device busy {busy:.3f} ms of {wall:.3f} ms wall on {card}")
        check(api["syncs"] == 0, f"a {name} map insert made {api['syncs']} host syncs")

    # Searches with frame 16's points in the map frame.
    f16, n16 = frames[last], int(frames[last].num_points)
    q = voxelmap._transform(Ts[last], f16.points[:n16])[:, :3].contiguous()
    gmap, gmap_c = maps["gaussian"]
    imap, imap_c = maps["incremental"]
    searches = {
        "incremental knn_search k=1": (lambda: imap.knn_search(q, 1),
                                       lambda: imap_c.knn_search(q.cpu(), 1)),
        "incremental knn_search k=10": (lambda: imap.knn_search(q, 10),
                                        lambda: imap_c.knn_search(q.cpu(), 10)),
        "gaussian nearest_neighbor_search": (lambda: gmap.nearest_neighbor_search(q),
                                             lambda: gmap_c.nearest_neighbor_search(
                                                 q.cpu())),
    }
    for label, (fn, plain) in searches.items():
        r = same_search(no_host_sync(fn), plain(), label)
        _, api, _, _, _ = profiled(fn)
        check(api["syncs"] == 0, f"{label} made {api['syncs']} host syncs")
        print(f"{label}: {time_ms(fn):.4f} ms for {n16} queries, {api['launches']} "
              f"kernel launches, 0 host syncs, d² within {r:.1e} of the plain account "
              f"on {card}")

    # VGICP of frame 16 against the Gaussian map, and GICP against the
    # incremental map's cloud view through the fused route (K1 and the step).
    init16 = noisy_guess(poses[last], rng)
    icloud = ivm_as_cloud(imap)
    for label, fn in (
            ("VGICP of frame 16 against the Gaussian map",
             lambda: align(gmap, f16, init_T_target_source=init16)),
            ("GICP of frame 16 against ivm_as_cloud, fused route",
             lambda: align(icloud, f16, None, init_T_target_source=init16))):
        for fn_ in (gicp_linearize_tables, gicp_lm_step):
            fn_.launches = 0
        out = fn()
        its = int(out.iterations) + 1
        rot, trans = pose_error(out.T_target_source.cpu().numpy(), poses[last])
        fused = "fused" in label
        k1, step = gicp_linearize_tables.launches, gicp_lm_step.launches
        check(step == its and k1 == (its if fused else 0),
              f"{label}: K1 {k1}, step {step} launches in {its} iterations")
        check(rot < 2.5 and trans < 0.2, f"{label} outside the reference bounds")
        ms = host_turns({label: fn}, reps=5)[label]
        _, api, busy, wall, _ = profiled(fn)
        print(f"{label}: {its - 1} iterations (K1 {k1}, step {step} launches), "
              f"pose error {rot:.4f} deg, {trans:.4f} m "
              f"(bounds 2.5 deg, 0.2 m); {ms:.3f} ms (host clock around a synchronize, "
              f"median of 5); profiled: device busy {busy:.3f} ms of {wall:.3f} ms wall "
              f"({100 * busy / wall:.1f}% busy), {api['launches'] / its:.1f} kernel "
              f"launches and {api['syncs'] / its:.2f} host syncs per iteration "
              f"({int(icloud.num_points)} live rows of {icloud.capacity}) on {card}")

    insert_all([last])
    for name, (m, _) in maps.items():
        v = ins_ms[name]
        extra = (f", {int(m.num_points_stored)} points stored"
                 if name == "incremental" else "")
        print(f"{name} map: {len(v)} inserts, {np.median(v):.3f} ms median, "
              f"{np.mean(v):.3f} ms mean a insert (CUDA events around one insert, the "
              f"plain account's insert between); {int(m.num_voxels)} voxels{extra}; "
              f"payload rows within {rel[name]:.1e} of the plain account on {card}")


# ------------------------------------------------------------ phase 10 ----

ODOM_ENGINES = ("gicp_model_fused", "gicp_model", "vgicp_model", "vgicp_model_fused",
                "plane_icp_model", "plane_icp_model_fused", "gicp_scan", "plane_icp_scan",
                "icp_scan")
# The voxel-search model engines take the 7-voxel pattern: at 1.2 m a frame
# the one-voxel basin is narrower than the motion.
OFFSETS7_ENGINES = ("gicp_model", "vgicp_model", "plane_icp_model", "small_gicp_model",
                    "small_vgicp_model", "small_plane_icp_model")
# Point-to-point ICP misses 0.2 m at this motion in both packages: printed,
# not bounded.
POINT_ICP_ENGINES = ("icp_scan", "small_icp")
ODOM_CHUNK = 8


def odometry_params(engine: str, **kw) -> OdometryParams:
    return OdometryParams(num_offsets=7 if engine in OFFSETS7_ENGINES else 1, **kw)


@contextlib.contextmanager
def recorded_aligns():
    """The result of every ``align_impl`` the chunked odometry makes inside
    the block, in order (read them after it: a read waits for the card)."""
    results = []
    real = odometry_scan.align_impl

    def rec(*args, **kwargs):
        results.append(real(*args, **kwargs))
        return results[-1]

    odometry_scan.align_impl = rec
    try:
        yield results
    finally:
        odometry_scan.align_impl = real


def counted_syncs(fn):
    """(``fn()``, the host syncs it made): torch's sync debug mode warns once
    for each operation that waits for the card."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def trajectory_errors(est: np.ndarray, poses: np.ndarray):
    """(largest rotation error of a consecutive relative pose in degrees, the
    same in metres, APE mean in metres) of [F,4,4] poses against world
    poses taken relative to the first frame."""
    gt = np.linalg.inv(poses[0])[None] @ poses
    est = est.astype(np.float64)
    rel_est = np.linalg.inv(est[:-1]) @ est[1:]
    rel_gt = np.linalg.inv(gt[:-1]) @ gt[1:]
    rot, trans = pose_errors(rel_est, rel_gt)
    return float(rot.max()), float(trans.max()), ape_translation(est, gt)[0]


def judged(engine: str, est: np.ndarray, poses: np.ndarray) -> str:
    """The errors of a trajectory, checked against the bounds (2.5° / 0.2 m a
    frame, APE 0.2 m) unless the engine is point-to-point ICP."""
    rot, trans, ape = trajectory_errors(est, poses)
    free = engine in POINT_ICP_ENGINES
    check(np.isfinite(est).all(), f"{engine}: non-finite poses")
    if not free:
        check(rot < 2.5 and trans < 0.2 and ape < 0.2,
              f"{engine}: relative pose error {rot:.4f} deg / {trans:.4f} m or APE "
              f"{ape:.4f} m beyond 2.5 deg / 0.2 m / 0.2 m")
    return (f"worst relative pose {rot:.4f} deg / {trans:.4f} m, APE {ape:.4f} m"
            + (" (point-to-point ICP: no bound)" if free else " (bounds 2.5 deg / 0.2 m / "
               "0.2 m)"))


def run_chunked(engine, fd, cd, n, dev, covariance_mode="knn"):
    """The preloaded frames (``fd``, ``cd``; ``n`` real) through
    ``JitOdometry(engine)`` in feeds of a chunk each: (poses, the engine, its
    carries before each chunk, LM iterations a frame)."""
    odo = JitOdometry(odometry_params(engine), engine, chunk_frames=ODOM_CHUNK,
                      covariance_mode=covariance_mode, device=dev)
    carries = []
    with recorded_aligns() as results:
        for start in range(0, fd.shape[0], ODOM_CHUNK):
            carries.append(odo.carry)
            odo.feed_preloaded(fd[start:start + ODOM_CHUNK], cd[start:start + ODOM_CHUNK],
                               n_real=min(ODOM_CHUNK, n - start))
    return np.stack(odo.poses), odo, carries, [int(r.iterations) + 1 for r in results]


def phase_odometry(scans, poses, rng, dev, card):
    """Phase 10: the chunked engines over the 17 frames (gicp_model_fused
    first, from preload / feed_preloaded), every streaming engine, the card
    against the plain CPU path on a small sequence, and the CLI."""
    print("== phase 10: odometry", flush=True)
    t_phase = time.perf_counter()
    n = len(scans)
    probe = JitOdometry(OdometryParams(), "gicp_model_fused", chunk_frames=ODOM_CHUNK,
                        device=dev)
    fd, cd = probe.preload(scans)
    f_pad = fd.shape[0]

    # gicp_model_fused with the counts at 0: K3 once a frame (padded frames
    # too: their launch finds no row), K1 and the step once an iteration.
    for _, _, _, fn in KERNELS.values():
        fn.launches = 0
    est, odo, carries, its = run_chunked("gicp_model_fused", fd, cd, n, dev)
    launches = {name: fn.launches for name, (_, _, _, fn) in KERNELS.items()}
    print(f"gicp_model_fused over {n} frames ({f_pad - n} padded) in chunks of {ODOM_CHUNK}: "
          f"{judged('gicp_model_fused', est, poses)}; LM iterations a frame {its}; "
          f"launches {launches}")
    check(len(its) == f_pad, f"{len(its)} aligns for {f_pad} frames")
    check(launches["knn_moments"] == f_pad, f"K3 launched {launches['knn_moments']} times "
          f"for {f_pad} frames")
    check(launches["gicp_linearize"] == sum(its) and launches["gicp_lm_step"] == sum(its),
          f"K1 {launches['gicp_linearize']} and step {launches['gicp_lm_step']} launches "
          f"in {sum(its)} LM iterations")
    check(all(v == 0 for k, v in launches.items() if k not in MAIN_KERNELS),
          "a kernel off the odometry path was launched")
    ct = odo.chunk_times_ms
    print(f"chunk wall times {[round(t, 3) for t in ct]} ms (device synchronize at each "
          f"chunk's end): steady state {np.mean(ct[1:]) / ODOM_CHUNK:.3f} ms a frame over "
          f"the chunks after the first (the JAX CLI's figure, padded frames included), "
          f"{ct[1] / ODOM_CHUNK:.3f} ms a frame in chunk 1 (frames 8-15) on {card}")

    # One chunk profiled (frames 8-15 from the carry after chunk 0), and one
    # frame (16, from the carry after chunk 1).
    def chunk1():
        odo.carry = carries[1]
        return odo._run_chunk(fd[ODOM_CHUNK:2 * ODOM_CHUNK], cd[ODOM_CHUNK:2 * ODOM_CHUNK])

    _, api, busy, wall, events = profiled(chunk1)
    print(f"profiled chunk 1 of gicp_model_fused: device busy {busy:.3f} ms of {wall:.3f} "
          f"ms wall ({100 * busy / wall:.1f}% busy); per frame {api['launches'] / 8:.1f} "
          f"kernel launches, {api['copies'] / 8:.2f} copies, {api['memsets'] / 8:.2f} "
          f"memsets, {api['syncs'] / 8:.2f} host syncs on {card}; top device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")

    def frame16(o, carry):
        def run():
            o.carry = carry
            return o._run_chunk(fd[2 * ODOM_CHUNK:2 * ODOM_CHUNK + 1],
                                cd[2 * ODOM_CHUNK:2 * ODOM_CHUNK + 1])
        return run

    p = odo.params
    with recorded_aligns() as results:
        _, api, busy, wall, _ = profiled(frame16(odo, carries[2]))
    its16 = int(results[-1].iterations) + 1
    print(f"profiled frame 16 of gicp_model_fused: {api['launches']} kernel launches, "
          f"{api['copies']} copies, {api['memsets']} memsets, {api['syncs']} host syncs "
          f"in {its16} LM iterations; device busy {busy:.3f} ms of {wall:.3f} ms wall on "
          f"{card}")
    check(api["syncs"] == its16, f"frame 16 made {api['syncs']} host syncs in {its16} LM "
          "iterations (only the stop-flag reads may wait)")

    def prep():
        return odometry_scan._frame_cloud(fd[16], cd[16], p.downsampling_resolution,
                                          p.max_downsampled, p.num_neighbors, "gicp")

    ms = host_turns({"frame": frame16(odo, carries[2]), "preprocessing": prep}, reps=5)
    print(f"frame 16: {ms['frame']:.3f} ms a step, of which preprocessing (voxelgrid + "
          f"K3 covariances) {ms['preprocessing']:.3f} ms = "
          f"{100 * ms['preprocessing'] / ms['frame']:.1f}% (host clock around a "
          f"synchronize, median of 5 in turns) on {card}")

    # Every other chunked engine: bounds, launches, and frame 16's host syncs.
    # K1 runs on the fused route (the "_fused" and scan-to-scan engines), the
    # step kernel on every route, K3 wherever covariances or normals are made.
    for engine in ODOM_ENGINES[1:]:
        for _, _, _, fn in KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        est, o, carries_e, its = run_chunked(engine, fd, cd, n, dev)
        took = time.perf_counter() - t0
        k1, step = gicp_linearize_tables.launches, gicp_lm_step.launches
        k3 = knn_moments_rows.launches
        fused = engine.endswith("_fused") or engine.endswith("_scan")
        check(step == sum(its) and k1 == (sum(its) if fused else 0)
              and k3 == (0 if engine == "icp_scan" else f_pad),
              f"{engine}: K1 {k1}, step {step}, K3 {k3} launches for {f_pad} frames of "
              f"{sum(its)} LM iterations")
        with recorded_aligns() as results:
            _, syncs = counted_syncs(frame16(o, carries_e[2]))
        i16 = int(results[-1].iterations) + 1
        print(f"{engine}: {judged(engine, est, poses)}; {took * 1e3 / n:.3f} ms a frame "
              f"with the first chunk's (chunks {[round(t, 1) for t in o.chunk_times_ms]} "
              f"ms); launches K3 {k3}, K1 {k1}, step {step} in {sum(its)} LM iterations; "
              f"frame 16 {syncs} host syncs in {i16} LM iterations on {card}")
        check(syncs == i16, f"{engine}: frame 16 made {syncs} host syncs in {i16} LM "
              "iterations")

    # The streaming engines, as create_odometry builds them.
    for engine in sorted(ENGINES):
        if engine == "small_gicp_projective":
            continue  # phase 11
        o = create_odometry(engine, odometry_params(engine), device=dev)
        est = o.estimate(scans)
        print(f"{engine}: {judged(engine, est, poses)}; {o.report()} on {card}")

    # The card against the plain CPU path on a small sequence.
    small, small_poses = generate_sequence(n_frames=4, rings=16, azimuth_steps=256)
    sp = OdometryParams(max_scan_points=4096, max_downsampled=4096, map_capacity=16384)
    out = {}
    for where in (dev, torch.device("cpu")):
        j = JitOdometry(sp, "gicp_model_fused", chunk_frames=4, device=where)
        s = create_odometry("small_gicp_model", sp, device=where)
        out[where.type] = (j.feed(small), int(j.carry[2].num_voxels), s.estimate(small),
                           int(s.voxelmap.num_voxels))
    a, c = out[dev.type], out["cpu"]
    d_jit, d_s = np.abs(a[0] - c[0]).max(), np.abs(a[2] - c[2]).max()
    print(f"small sequence, card against the CPU path: gicp_model_fused poses within "
          f"{d_jit:.2e} ({a[1]} / {c[1]} voxels), small_gicp_model within {d_s:.2e} "
          f"({a[3]} / {c[3]} voxels)")
    check(d_jit <= 1e-3 and d_s <= 1e-3 and a[1] == c[1] and a[3] == c[3],
          "the card and the CPU path disagree on the small sequence")

    # The CLI in its own process, on the 17 frames written as KITTI scans.
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for i, sc in enumerate(scans):
            write_kitti_bin(f"{tmp}/{i:06d}.bin", sc)
        traj = f"{tmp}/traj.txt"
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "small_gicp_tpu_torch.apps."
                              "odometry_benchmark", tmp, traj, "--engine",
                              "gicp_model_fused"], capture_output=True, text=True)
        took = time.perf_counter() - t0
        lines = open(traj).read().splitlines() if run.returncode == 0 else []
    print("CLI: " + " | ".join(run.stdout.strip().splitlines()[-3:])
          + f" ({took:.1f} s in its own process, exit {run.returncode})")
    check(run.returncode == 0 and len(lines) == n,
          f"the CLI exited {run.returncode} with {len(lines)} trajectory lines: "
          f"{run.stderr[-2000:]}")
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")



# ------------------------------------------------------------ phase 11 ----

# The window searches' Morton cell: the downsampling resolution, as
# odometry's "knn_window" mode takes it. At raw-scan density a 1 m cell
# (the API default) holds more points than the ±64-row band.
WINDOW_CELL = 0.25
# tools/projective_figures.py (the JAX package's ProjectiveSearch on the
# CPU, 8,192 sampled rows of frame 1 moved into frame 0, default image):
# found 1.0000, agreement with the exact NN 0.1360. The card is held to
# these less PROJECTIVE_MARGIN over every row (the sample's spread is
# ≈0.004; the default image's 64 rows over 120° are coarse for a 28° sensor,
# hence the low agreement).
PROJECTIVE_JAX = (1.0, 0.1360)
PROJECTIVE_MARGIN = 0.03
NEW_MODES = ("voxel", "knn_window")
BATCH_ENGINES = ("gicp_model", "gicp_scan")


def zero_counts():
    for _, _, _, fn in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, (_, _, _, fn) in KERNELS.items()}


def set_recall(d: torch.Tensor, i: torch.Tensor, i_ref: torch.Tensor) -> float:
    """Share of the exact lists' entries (i_ref [Q,k]) that the lists (d, i)
    hold in a found slot."""
    q = i_ref.shape[0]
    m = int(max(int(i.max()), int(i_ref.max()))) + 1
    rows = torch.arange(q, device=i.device)[:, None] * m
    tags = (i.long() + rows)[torch.isfinite(d) & (d < 1e16)]
    return float(torch.isin((i_ref.long() + rows).flatten(), tags).float().mean())


def phase_rest(scans, poses, rng, dev, card):
    """Phase 11: the windowed searches, the voxel covariances and the
    projective search at full width, the "voxel" and "knn_window" modes,
    the projective engine and BatchOdometry."""
    print("== phase 11: windowed kNN, voxel covariances, projective search, batches",
          flush=True)
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    p = OdometryParams()
    k = p.num_neighbors
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    raw0 = PointCloud.from_points(scans[0], device=dev)
    raw0_cpu = PointCloud.from_points(scans[0], device=cpu)
    moved = torch.from_numpy((scans[1] @ T_gt[:3, :3].T + T_gt[:3, 3]).astype(np.float32)
                             ).to(dev)
    down = voxelgrid_sampling(raw0, p.downsampling_resolution, p.max_downsampled)
    nd = int(down.num_points)

    # The windowed searches against the exact ones (K10).
    d_w, i_w = knn_window.knn_windowed(down.points, down.num_points, k, cell=WINDOW_CELL)
    _, i_e = KdTree.build(down).knn_search(down.points[:nd, :3], k)
    rec_self = set_recall(d_w[:nd], i_w[:nd], i_e)
    ms = time_turns({
        "window": lambda: knn_window.knn_windowed(down.points, down.num_points, k,
                                                  cell=WINDOW_CELL),
        "K3": lambda: knn_moments(down.points, down.num_points, k)}, reps=10)
    print(f"knn_windowed, {nd} downsampled rows, k = {k}, cell {WINDOW_CELL} m: set recall "
          f"{rec_self:.4f} against K10's exact lists; {ms['window']:.3f} ms against K3's "
          f"moments {ms['K3']:.3f} ms (events, in turns) on {card}")
    check(rec_self >= 0.97, f"knn_windowed recall {rec_self:.4f} < 0.97")
    tree0 = KdTree.build(raw0)
    d_e, i_e = tree0.knn_search(moved, K_NEIGHBORS)
    recall = {}
    for cell in (WINDOW_CELL, 1.0):
        d_q, i_q = tree0.knn_search(moved, K_NEIGHBORS, method="window", window_cell=cell)
        recall[cell] = set_recall(d_q, i_q, i_e)
    ms = time_turns({
        "window": lambda: tree0.knn_search(moved, K_NEIGHBORS, method="window",
                                           window_cell=WINDOW_CELL),
        "exact": lambda: tree0.knn_search(moved, K_NEIGHBORS)}, reps=5)
    print(f"KdTree.knn_search(method='window'), frame 1's {len(scans[1])} raw points moved "
          f"into frame 0 ({len(scans[0])} rows), k = {K_NEIGHBORS}: set recall "
          f"{recall[WINDOW_CELL]:.4f} at cell {WINDOW_CELL} m ({recall[1.0]:.4f} at the "
          f"default 1 m) against K10's; {ms['window']:.3f} ms against the exact search "
          f"{ms['exact']:.3f} ms (events, in turns) on {card}")
    check(recall[WINDOW_CELL] >= 0.97, f"window method recall {recall[WINDOW_CELL]:.4f}")

    # Voxel-moment covariances, the card against the CPU.
    leaf, cap = p.downsampling_resolution, p.max_downsampled
    vc = voxelgrid_sampling_with_covs(raw0, leaf, cap)
    vc_cpu = voxelgrid_sampling_with_covs(raw0_cpu, leaf, cap)
    nv = int(vc.num_points)
    d_mean = float((vc.points[:nv].cpu() - vc_cpu.points[:nv]).abs().max())
    _, _, cov, enough = neighborhood_covariances(raw0_cpu.points, raw0_cpu.num_points, leaf,
                                                 cap)
    ev = torch.linalg.eigvalsh(cov[:nv])
    ok = enough[:nv] & (ev[:, 1] - ev[:, 0] > 1e-3)
    diff = (vc.covs[:nv].cpu() - vc_cpu.covs[:nv]).abs()
    d_cov, d_all = float(diff[ok].max()), float(diff.max())
    ms = time_turns({
        "voxel": lambda: voxelgrid_sampling_with_covs(raw0, leaf, cap),
        "knn": lambda: estimate_covariances(voxelgrid_sampling(raw0, leaf, cap),
                                            num_neighbors=k)}, reps=10)
    print(f"voxelgrid_sampling_with_covs of frame 0 ({len(scans[0])} points, {leaf} m): "
          f"{nv} voxels ({int(vc_cpu.num_points)} on the CPU), means within {d_mean:.2e} m, "
          f"covariances within {d_cov:.2e} on the {100 * float(ok.float().mean()):.1f}% of "
          f"rows whose two smallest eigenvalues are more than 1e-3 m^2 apart ({d_all:.2e} "
          f"over all rows); "
          f"{ms['voxel']:.3f} ms against voxelgrid + K3 covariances {ms['knn']:.3f} ms "
          f"(events, in turns) on {card}")
    check(nv == int(vc_cpu.num_points) and d_mean <= 1e-5 and d_cov <= 1e-3,
          "voxel covariances: the card and the CPU disagree")

    # The projective search against K9.
    ps = ProjectiveSearch.build(raw0)
    d_p, i_p, f_p = ps.nearest_neighbor_search(moved)
    d_k, i_k = tree0.nearest_neighbor_search(moved)
    found = float(f_p.float().mean())
    agree = float((f_p & ((i_p == i_k) | (d_p <= d_k * (1 + 1e-5) + 1e-9))).float().mean())
    same_image = torch.equal(ps.index_image.cpu(),
                             ProjectiveSearch.build(raw0_cpu).index_image)
    ms = time_turns({"build": lambda: ProjectiveSearch.build(raw0),
                     "nn": lambda: ps.nearest_neighbor_search(moved),
                     "K9": lambda: tree0.nearest_neighbor_search(moved)}, reps=10)
    print(f"ProjectiveSearch over frame 0 (1024 x 64, 120 deg), NN of frame 1's "
          f"{len(scans[1])} moved points: found {found:.4f}, agreement with K9's exact NN "
          f"{agree:.4f} (the JAX searcher on the CPU: {PROJECTIVE_JAX[0]:.4f} / "
          f"{PROJECTIVE_JAX[1]:.4f}, margin {PROJECTIVE_MARGIN}); card and CPU images "
          f"{'equal' if same_image else 'DIFFER'}; build {ms['build']:.3f} ms, NN "
          f"{ms['nn']:.3f} ms, K9 {ms['K9']:.3f} ms (events, in turns) on {card}")
    check(same_image and found >= PROJECTIVE_JAX[0] - PROJECTIVE_MARGIN
          and agree >= PROJECTIVE_JAX[1] - PROJECTIVE_MARGIN, "projective search")

    print(f"searches and covariances took {time.perf_counter() - t_phase:.1f} s")
    # The new covariance modes, in turns with "knn", over the 17 frames.
    t_sec = time.perf_counter()
    n = len(scans)
    fd, cd = JitOdometry(p, "gicp_model_fused", chunk_frames=ODOM_CHUNK,
                         device=dev).preload(scans)
    f_pad = fd.shape[0]
    for engine in ("gicp_model_fused", "gicp_model"):
        est_by, steady = {}, {m: [] for m in ("knn",) + NEW_MODES}
        for _ in range(2):
            for mode in ("knn",) + NEW_MODES:
                zero_counts()
                est, odo, carries, its = run_chunked(engine, fd, cd, n, dev, mode)
                c = read_counts()
                steady[mode].append(float(np.mean(odo.chunk_times_ms[1:])) / ODOM_CHUNK)
                fused = engine.endswith("_fused")
                check(c["gicp_lm_step"] == sum(its)
                      and c["gicp_linearize"] == (sum(its) if fused else 0)
                      and c["knn_moments"] == (f_pad if mode == "knn" else 0)
                      and sum(c.values()) == c["gicp_lm_step"] + c["gicp_linearize"]
                      + c["knn_moments"],
                      f"{engine} / {mode}: launches {c} in {sum(its)} LM iterations")
                if mode in est_by:
                    continue
                est_by[mode] = est
                if not fused:
                    print(f"{engine} / {mode}: {judged(engine, est, poses)}; max |pose - knn "
                          f"pose| {np.abs(est - est_by['knn']).max():.2e}; launches K3 "
                          f"{c['knn_moments']}, K1 {c['gicp_linearize']}, step "
                          f"{c['gicp_lm_step']} in {sum(its)} LM iterations on {card}")
                    continue

                def chunk1(odo=odo, carries=carries):
                    odo.carry = carries[1]
                    return odo._run_chunk(fd[ODOM_CHUNK:2 * ODOM_CHUNK],
                                          cd[ODOM_CHUNK:2 * ODOM_CHUNK])

                _, api, busy, wall, _ = profiled(chunk1)
                print(f"{engine} / {mode}: {judged(engine, est, poses)}; max |pose - knn "
                      f"pose| {np.abs(est - est_by['knn']).max():.2e}; launches K3 "
                      f"{c['knn_moments']}, K1 {c['gicp_linearize']}, step "
                      f"{c['gicp_lm_step']} in {sum(its)} LM iterations; profiled chunk 1: "
                      f"{api['launches'] / ODOM_CHUNK:.1f} launches a frame, busy "
                      f"{100 * busy / wall:.1f}% ({busy:.3f} of {wall:.3f} ms) on {card}")
        print(f"{engine}: ms a frame over the chunks after the first, two rounds in turns: "
              + ", ".join(f"{m} {v[0]:.3f} / {v[1]:.3f}" for m, v in steady.items())
              + f" on {card}")

    print(f"the modes took {time.perf_counter() - t_sec:.1f} s")
    # The projective engine, streaming, and through the CLI in its own process.
    zero_counts()
    o = create_odometry("small_gicp_projective", p, device=dev)
    t0 = time.perf_counter()
    est = o.estimate(scans)
    took = time.perf_counter() - t0
    c = read_counts()
    rot, trans, ape = trajectory_errors(est, poses)
    print(f"small_gicp_projective over {n} frames: worst relative pose {rot:.4f} deg / "
          f"{trans:.4f} m, APE {ape:.4f} m (approximate correspondences: printed, not "
          f"bounded); {took * 1e3 / n:.3f} ms a frame, {o.report()}; launches K3 "
          f"{c['knn_moments']}, K1 {c['gicp_linearize']}, step {c['gicp_lm_step']}, "
          f"K9 {c['nearest_neighbor']} on {card}")
    check(np.isfinite(est).all() and c["knn_moments"] == n and c["gicp_lm_step"] >= n - 1
          and c["gicp_linearize"] == 0 and c["nearest_neighbor"] == 0,
          f"small_gicp_projective: launches {c}")
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for i, sc in enumerate(scans):
            write_kitti_bin(f"{tmp}/{i:06d}.bin", sc)
        traj = f"{tmp}/traj.txt"
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "small_gicp_tpu_torch.apps."
                              "odometry_benchmark", tmp, traj, "--engine",
                              "small_gicp_projective"], capture_output=True, text=True)
        took = time.perf_counter() - t0
        lines = open(traj).read().splitlines() if run.returncode == 0 else []
    print("CLI --engine small_gicp_projective: "
          + " | ".join(run.stdout.strip().splitlines()[-2:])
          + f" ({took:.1f} s in its own process, exit {run.returncode})")
    check(run.returncode == 0 and len(lines) == n,
          f"the CLI exited {run.returncode} with {len(lines)} trajectory lines: "
          f"{run.stderr[-2000:]}")

    # The card against the plain CPU path on phase 10's small sequence.
    t_sec = time.perf_counter()
    small, _ = generate_sequence(n_frames=4, rings=16, azimuth_steps=256)
    sp = OdometryParams(max_scan_points=4096, max_downsampled=4096, map_capacity=16384)
    out = {}
    for where in (dev, cpu):
        out[where.type] = [JitOdometry(sp, "gicp_model_fused", chunk_frames=4,
                                       covariance_mode=m, device=where).feed(small)
                           for m in NEW_MODES]
        out[where.type].append(create_odometry("small_gicp_projective", sp,
                                               device=where).estimate(small))
    diffs = [float(np.abs(a - b).max()) for a, b in zip(out[dev.type], out["cpu"])]
    print(f"small sequence, card against the CPU path: gicp_model_fused voxel "
          f"{diffs[0]:.2e}, knn_window {diffs[1]:.2e}; small_gicp_projective {diffs[2]:.2e} "
          f"({time.perf_counter() - t_sec:.1f} s)")
    check(max(diffs) <= 1e-3, "the card and the CPU path disagree on the small sequence")

    # BatchOdometry: four lanes of four worlds (seeds 1-4), the last shorter.
    t_sec = time.perf_counter()
    lanes = [generate_sequence(n_frames=3 if s < 4 else 2, seed=s, rings=32,
                               azimuth_steps=900)[0] for s in range(1, 5)]
    n_real = sum(len(seq) for seq in lanes)
    print(f"lanes generated in {time.perf_counter() - t_sec:.1f} s")
    for engine in BATCH_ENGINES:
        zero_counts()
        t0 = time.perf_counter()
        got = BatchOdometry(len(lanes), p, engine, device=dev).feed(lanes)
        first = time.perf_counter() - t0
        c = read_counts()
        t0 = time.perf_counter()
        BatchOdometry(len(lanes), p, engine, device=dev).feed(lanes)
        again = time.perf_counter() - t0
        exact, close = True, True
        for lane, seq in enumerate(lanes):
            solo = JitOdometry(p, engine, chunk_frames=got.shape[1], device=dev).feed(seq)
            exact &= bool(np.array_equal(got[lane, :len(seq)], solo))
            close &= bool(np.allclose(got[lane, :len(seq)], solo, rtol=1e-5, atol=1e-6))
        tail = bool(np.array_equal(got[-1, 2:], got[-1, 1:2]))
        print(f"BatchOdometry({len(lanes)}, {engine}) over {[len(q) for q in lanes]} frames "
              f"of 32 x 900 rays: lanes equal JitOdometry alone "
              f"{'bit for bit' if exact else 'within rtol 1e-5 / atol 1e-6' if close else 'NOT'}"
              f"; padded tail repeats the last pose: {tail}; {n_real / again:.2f} frames/s "
              f"across lanes ({n_real / first:.2f} in the first call); launches K3 "
              f"{c['knn_moments']}, K1 {c['gicp_linearize']}, step {c['gicp_lm_step']} "
              f"on {card}")
        check(close and tail and c["knn_moments"] == got.shape[0] * got.shape[1]
              and c["gicp_lm_step"] > 0 and (c["gicp_linearize"] > 0) == engine.endswith("_scan"),
              f"BatchOdometry {engine}: lanes {close}, tail {tail}, launches {c}")
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ phase 12 ----

SCALE_PAIRS = 4
SCALE_PROBLEMS = 64
SCALE_MAP_FRAMES = 8
SCALE_ODOM_FRAMES = 3
SCALE_ENGINE = "gicp_scan"
SCALE_RANKS = 2  # gloo ranks sharing the card
# Launch counters read in phase 12: K1, the step kernel (and its errors-only
# mode, counted on gicp_error_multi), K7, K8 and K9.
SCALE_COUNTS = ("gicp_linearize", "gicp_lm_step", "gicp_linearize_fleet",
                "gicp_error_multi_fleet", "nearest_neighbor")


def scale_counts() -> dict:
    c = read_counts()
    out = {KERNELS[k][0]: c[k] for k in SCALE_COUNTS}
    out["K2 errors-only"] = gicp_error_multi.launches
    return out


def scale_zero():
    zero_counts()
    gicp_error_multi.launches = 0


def scale_modes(scans, poses, rng, dev, mesh, card, world, reps, pairs=SCALE_PAIRS,
                problems=SCALE_PROBLEMS, map_frames=SCALE_MAP_FRAMES,
                odom_frames=SCALE_ODOM_FRAMES) -> dict:
    """Every scale-out mode over ``mesh`` (``world`` ranks) against its
    unsharded call on the same inputs, on the card: checks, launch counts in
    the sharded run, and ms of each in turns (``reps`` rounds of CUDA events
    around one call). Returns {mode: {"ms", "unsharded_ms", "launches"}}."""
    rank = multihost.mesh_group(mesh)[1]
    say = print if rank == 0 else (lambda *a, **k: None)
    out = {}
    n_est = max(int(voxelgrid_sampling(PointCloud.from_points(sc, device=dev),
                                       LEAF).num_points) for sc in scans)
    cap = (n_est + 256 + 511) // 512 * 512
    clouds = [preprocess_points(sc, LEAF, num_neighbors=K_NEIGHBORS, max_points=cap,
                                device=dev)[0] for sc in scans]
    gts = [np.linalg.inv(poses[i]) @ poses[i + 1] for i in range(len(scans) - 1)]

    def record(mode, fns, launches):
        ms = time_turns(fns, reps=reps)
        out[mode] = {"ms": ms["sharded"], "unsharded_ms": ms["unsharded"],
                     "launches": launches}
        say(f"  {mode}: {ms['sharded']:.3f} ms sharded over {world} rank(s), "
            f"{ms['unsharded']:.3f} ms unsharded (events, in turns, median of {reps}); "
            f"launches in the sharded run (this rank) {launches} on {card}", flush=True)

    # Batch: B pairs, each rank its block, one gather.
    inits = torch.as_tensor(np.stack([noisy_guess(gts[i], rng) for i in range(pairs)]),
                            dtype=torch.float32)
    targets, sources = stack_clouds(clouds[:pairs]), stack_clouds(clouds[1:pairs + 1])
    scale_zero()
    got = align_batch(targets, sources, inits, mesh=mesh)
    launches = scale_counts()
    refs = [align_impl(clouds[i], clouds[i + 1], None, inits[i]) for i in range(pairs)]
    mine = range(pairs)[multihost.block(pairs, rank, world)]
    its = sum(int(refs[i].iterations) + 1 for i in mine)
    check(torch.equal(got.T_target_source, torch.stack([r.T_target_source for r in refs]))
          and torch.equal(got.iterations, torch.stack([r.iterations for r in refs])),
          "align_batch differs from the per-pair aligns")
    check(launches["K1"] == its and launches["K2"] == its,
          f"align_batch: launches {launches} in {its} LM iterations on this rank")
    say(f"  align_batch of {pairs} pairs ({cap} rows each): equal to the per-pair aligns "
        f"bit for bit, iterations {got.iterations.tolist()}")
    record("batch", {"sharded": lambda: align_batch(targets, sources, inits, mesh=mesh),
                     "unsharded": lambda: [align_impl(clouds[i], clouds[i + 1], None,
                                                      inits[i]) for i in range(pairs)]},
           launches)

    # Point-sharded: one registration, the source rows split.
    init = torch.as_tensor(inits[0])
    scale_zero()
    got, syncs = counted_syncs(lambda: align_point_sharded(clouds[0], clouds[1], init, mesh))
    launches = scale_counts()
    ref, ref_syncs = counted_syncs(lambda: align_impl(clouds[0], clouds[1], None, init,
                                                      use_fused="never"))
    its = int(got.iterations) + 1
    d_T = float((got.T_target_source - ref.T_target_source).abs().max())
    check(d_T <= 1e-5 and int(got.num_inliers) == int(ref.num_inliers),
          f"align_point_sharded: |dT| {d_T:.2e}, inliers {int(got.num_inliers)} against "
          f"{int(ref.num_inliers)}")
    check(launches["K9"] == its and launches["K2 errors-only"] == its
          and launches["K1"] == 0 and launches["K2"] == 0,
          f"align_point_sharded: launches {launches} in {its} LM iterations")
    say(f"  align_point_sharded of {int(clouds[1].num_points)} source rows: |dT| {d_T:.2e} "
        f"against the unsharded unfused align, inliers {int(got.num_inliers)} equal, "
        f"{its} iterations; {syncs} host syncs ({syncs / its:.2f} an iteration), the "
        f"unsharded unfused align {ref_syncs} in {int(ref.iterations) + 1}")
    record("point", {"sharded": lambda: align_point_sharded(clouds[0], clouds[1], init,
                                                            mesh),
                     "unsharded": lambda: align_impl(clouds[0], clouds[1], None, init,
                                                     use_fused="never")}, launches)

    # Map-block: both voxel maps over the first frames at their poses.
    Ts = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in poses]
    gvm = GaussianVoxelMap.empty(VOXEL_LEAF, GVM_SLOTS, device=dev)
    ivm = IncrementalVoxelMapCov(VOXEL_LEAF, IVM_SLOTS, voxel_capacity=IVM_VOXELS,
                                 device=dev)
    for i in range(map_frames):
        gvm, ivm = gvm.insert(clouds[i], Ts[i]), ivm.insert(clouds[i], Ts[i])
    f_q, n_q = clouds[map_frames], int(clouds[map_frames].num_points)
    q = voxelmap._transform(Ts[map_frames], f_q.points[:n_q])[:, :3].contiguous()
    g_local, i_local = shard_gaussian_voxelmap(gvm, mesh), shard_incremental_voxelmap(ivm, mesh)
    ties = {}
    for name, vm, local, nn in (("gaussian", gvm, g_local, sharded_gvm_nn),
                                ("incremental", ivm, i_local, sharded_ivm_nn)):
        d, i, f = nn(local, q, mesh)
        dr, ir, fr = vm.nearest_neighbor_search(q)
        ties[name] = int((i != ir)[f].sum())
        check(torch.equal(d, dr) and torch.equal(f, fr) and (world > 1 or ties[name] == 0),
              f"sharded {name} search differs from the unsharded one ({ties[name]} slots)")
    init_m = noisy_guess(poses[map_frames], rng)
    scale_zero()
    got = sharded_model_align(gvm, f_q, init_m, mesh)
    launches = scale_counts()
    ref = Registration(registration_type="vgicp").align(gvm, f_q, None, init_m)
    its = int(got.iterations) + 1
    d_T = float((got.T_target_source - ref.T_target_source).abs().max())
    check(d_T <= 2 * TRANS_EPS and int(got.num_inliers) == int(ref.num_inliers)
          and launches["K2"] == its and launches["K1"] == 0,
          f"sharded_model_align: |dT| {d_T:.2e}, inliers {int(got.num_inliers)} / "
          f"{int(ref.num_inliers)}, launches {launches} in {its} iterations")
    say(f"  map blocks of {gvm.capacity} Gaussian / {ivm.voxel_capacity} incremental slots "
        f"over {map_frames} frames ({int(gvm.num_voxels)} / {int(ivm.num_voxels)} voxels), "
        f"{n_q} queries: d² and found equal bit for bit, slots differing on ties "
        f"{ties}; VGICP against the sharded map |dT| {d_T:.2e}, {its} iterations")
    record("map search", {"sharded": lambda: sharded_gvm_nn(g_local, q, mesh),
                          "unsharded": lambda: gvm.nearest_neighbor_search(q)}, {})
    record("map align", {"sharded": lambda: sharded_model_align(gvm, f_q, init_m, mesh),
                         "unsharded": lambda: Registration(registration_type="vgicp").align(
                             gvm, f_q, None, init_m)}, launches)

    # Fleet: the queue split, one fleet a rank over the replicated tables.
    tables = fleet_prepare(stack_clouds(clouds[:2]), stack_clouds(clouds[1:3]))
    pair_ids = torch.arange(problems, dtype=torch.int32, device=dev) % 2
    f_inits = torch.as_tensor(np.stack([noisy_guess(gts[p % 2], rng)
                                        for p in range(problems)]), dtype=torch.float32,
                              device=dev)
    scale_zero()
    got = align_fleet_sharded(None, None, f_inits, mesh, pair_ids=pair_ids,
                              num_lanes_per_device=FLEET_LANES, prepared=tables)
    launches = scale_counts()
    ref = align_fleet(None, None, f_inits, pair_ids=pair_ids, num_lanes=FLEET_LANES,
                      prepared=tables)
    # A problem's iterates do not depend on which lanes run beside it, so the
    # rows are align_fleet's bit for bit at every world size.
    exact = all(torch.equal(getattr(got, k), getattr(ref, k))
                for k in ("T_target_source", "converged", "iterations", "num_inliers"))
    d_T = float((got.T_target_source - ref.T_target_source).abs().max())
    check(exact, f"align_fleet_sharded rows differ from align_fleet's (|dT| {d_T:.2e})")
    check(launches["K7"] > 0 and launches["K7"] == launches["K8"],
          f"align_fleet_sharded launches {launches}")
    say(f"  align_fleet_sharded, {problems} problems on 2 pairs, {FLEET_LANES} lanes a rank: "
        f"rows equal bit for bit to align_fleet's")
    record("fleet", {"sharded": lambda: align_fleet_sharded(
        None, None, f_inits, mesh, pair_ids=pair_ids, num_lanes_per_device=FLEET_LANES,
        prepared=tables), "unsharded": lambda: align_fleet(
        None, None, f_inits, pair_ids=pair_ids, num_lanes=FLEET_LANES, prepared=tables)},
        launches)

    # BatchOdometry: two lanes of consecutive frames, a lane block a rank.
    p = OdometryParams()
    lanes = [scans[k * odom_frames:(k + 1) * odom_frames] for k in range(2)]
    scale_zero()
    got = BatchOdometry(2, p, SCALE_ENGINE, mesh=mesh, device=dev).feed(lanes)
    launches = scale_counts()
    launches["K3"] = knn_moments_rows.launches
    ref = BatchOdometry(2, p, SCALE_ENGINE, device=dev).feed(lanes)
    check(np.array_equal(got, ref), f"BatchOdometry(mesh=) lanes differ from the unsharded "
          f"batch by {np.abs(got - ref).max():.2e}")
    check(launches["K1"] > 0 and launches["K2"] == launches["K1"]
          and launches["K3"] == odom_frames * 2 // world,
          f"BatchOdometry(mesh=): launches {launches} over {odom_frames * 2 // world} frames")
    say(f"  BatchOdometry(2, {SCALE_ENGINE}, mesh=) over 2 x {odom_frames} frames: lanes "
        f"equal the unsharded batch bit for bit")
    record("odometry", {"sharded": lambda: BatchOdometry(2, p, SCALE_ENGINE, mesh=mesh,
                                                         device=dev).feed(lanes),
                        "unsharded": lambda: BatchOdometry(2, p, SCALE_ENGINE,
                                                           device=dev).feed(lanes)},
           launches)
    return out


def scale_rank(rank: int, world: int, tmp: str) -> None:
    """One of ``world`` ranks sharing the card over gloo (``chip_smoke.py
    --scale-rank``): phase 12's modes on the frames the parent saved."""
    dev = torch.device("cuda", 0)
    multihost.initialize(f"file://{tmp}/store", world, rank, [0], device=dev,
                         backend="gloo")
    try:
        d = np.load(f"{tmp}/frames.npz")
        scans = [d[f"scan{i}"] for i in range(int(d["n"]))]
        mesh = multihost.global_mesh("data", device=dev)
        modes = scale_modes(scans, d["poses"], np.random.default_rng(7), dev, mesh,
                            f"cuda:0 shared by {world} ranks", world, reps=3, pairs=2,
                            problems=16, map_frames=4, odom_frames=2)
        if rank == 0:
            print("SCALE_RANKS " + json.dumps(modes), flush=True)
    finally:
        torch.distributed.destroy_process_group()


def phase_scale(scans, poses, rng, dev, card):
    """Phase 12: every scale-out mode at world size 1 over NCCL in this
    process against its unsharded call; then the same checks on two gloo
    ranks sharing the card."""
    print("== phase 12: scale-out", flush=True)
    t_phase = time.perf_counter()
    n = SCALE_MAP_FRAMES + 1
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize(f"file://{tmp}/store", 1, 0, device=dev)
        try:
            backend = torch.distributed.get_backend()
            mesh = multihost.global_mesh("data", device=dev)
            print(f"world size 1 over {backend}:", flush=True)
            modes = scale_modes(scans[:n], poses[:n], rng, dev, mesh, card, 1, reps=5)
        finally:
            torch.distributed.destroy_process_group()
        print(f"world size 1 took {time.perf_counter() - t_phase:.1f} s", flush=True)

        t0 = time.perf_counter()
        np.savez(f"{tmp}/frames.npz", n=5, poses=poses[:5],
                 **{f"scan{i}": scans[i] for i in range(5)})
        runs = multihost.run_ranks(
            lambda r: [sys.executable, os.path.abspath(__file__), "--scale-rank", str(r),
                       "--scale-dir", tmp], SCALE_RANKS, timeout=240)
    for r, (rc, log) in enumerate(runs):
        print(f"two gloo ranks sharing {card}, rank {r}: exit {rc}")
        lines = log.strip().splitlines()
        shown = lines[-30:] if rc else [ln for ln in lines if ln.startswith("  ")]
        print("\n".join(shown))
        check(rc == 0, f"two ranks sharing the card: rank {r} exited {rc}")
    two = json.loads(next(line for line in runs[0][1].splitlines()
                          if line.startswith("SCALE_RANKS "))[len("SCALE_RANKS "):])
    print(f"two gloo ranks sharing the card took {time.perf_counter() - t0:.1f} s; "
          "phase 12 in JSON: " + json.dumps({"world1": modes, "world2_gloo": two}))
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)


# ------------------------------------------------------------ phase 13 ----

API_FRAMES = 8  # the checkpointed runs and the CLI's dataset
SYNTH_FRAMES = 24  # synthetic_odometry_benchmark's sequence


def same_fields(a, b, what: str) -> None:
    """Every tensor field of two dataclasses equal bit for bit."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            check(torch.equal(x, y), f"{what}: {f.name} differs")


def generator_stats(frames):
    """(returns a frame, range histogram [8], ground share) of [N,3] frames
    in the sensor frame."""
    hist, ground = [], []
    for p in frames:
        r = np.linalg.norm(p, axis=1)
        hist.append(np.histogram(r, bins=8, range=(0, 75.0))[0] / len(p))
        ground.append(np.mean(p[:, 2] < -1.2))  # the sensor rides ≈1.8 m up
    return float(np.mean([len(p) for p in frames])), np.mean(hist, 0), float(np.mean(ground))


def phase_api(scans, poses, rng, dev, card):
    """Phase 13: checkpoint and resume, the native loader and the CLI through
    it, RegistrationTPU, the factor classes, the device generator with
    synthetic_odometry_benchmark, and the profiling utilities."""
    print("== phase 13: the rest of the API", flush=True)
    t_phase = time.perf_counter()
    times = {}
    n = API_FRAMES
    half = n // 2

    # 1. Checkpoint and resume, at OdometryParams() on frames 0-7: the chunked
    # gicp_model_fused carry and the streaming small_gicp_model's state.
    t0 = time.perf_counter()
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        params = OdometryParams()
        full = JitOdometry(params, "gicp_model_fused", chunk_frames=half, device=dev)
        fd, cd = full.preload(scans[:n])
        p_full = full.feed_preloaded(fd, cd, n_real=n)
        a = JitOdometry(params, "gicp_model_fused", chunk_frames=half, device=dev)
        a.feed_preloaded(fd[:half], cd[:half], n_real=half)
        save_pytree(f"{tmp}/carry.npz", a.carry)
        b = JitOdometry(params, "gicp_model_fused", chunk_frames=half, device=dev)
        b.carry = load_pytree(f"{tmp}/carry.npz", b.carry)
        p_tail = b.feed_preloaded(fd[half:], cd[half:], n_real=n - half)
        check(np.array_equal(p_tail, p_full[half:]),
              "gicp_model_fused resumed from its carry differs from the continuous run")
        check(torch.equal(b.carry[0], full.carry[0]) and torch.equal(b.carry[1],
                                                                      full.carry[1]),
              "gicp_model_fused: T_world / T_delta differ after the resume")
        same_fields(b.carry[2], full.carry[2], "gicp_model_fused map after the resume")
        small = JitOdometry(OdometryParams(map_capacity=65536), "gicp_model_fused",
                            chunk_frames=half, device=dev)
        try:
            load_pytree(f"{tmp}/carry.npz", small.carry)
            check(False, "a wrong-capacity carry loaded")
        except ValueError as e:
            print(f"wrong-capacity carry refused: {str(e).splitlines()[0]}")

        engine = "small_gicp_model"
        s_full = create_odometry(engine, odometry_params(engine), device=dev)
        est_full = s_full.estimate(scans[:n])
        s_a = create_odometry(engine, odometry_params(engine), device=dev)
        s_a.estimate(scans[:half])
        save_odometry_state(f"{tmp}/odo.npz", s_a)
        s_b = create_odometry(engine, odometry_params(engine), device=dev)
        load_odometry_state(f"{tmp}/odo.npz", s_b)
        s_b.estimate(scans[half:n])
        check(np.array_equal(np.stack(s_b.traj), est_full),
              f"{engine} resumed from its checkpoint differs from the continuous run")
        check(torch.equal(s_b.T_world, s_full.T_world), f"{engine}: T_world differs")
        same_fields(s_b.voxelmap, s_full.voxelmap, f"{engine} map after the resume")
        s_small = create_odometry(engine, odometry_params(engine, map_capacity=65536),
                                  device=dev)
        try:
            load_odometry_state(f"{tmp}/odo.npz", s_small)
            check(False, "a wrong-capacity engine loaded the checkpoint")
        except ValueError as e:
            print(f"wrong-capacity engine refused: {str(e)[:100]}")
    counts = read_counts()
    print(f"checkpoint/resume: gicp_model_fused over frames 0-{n - 1} ({half} + {half} "
          f"from the carry) and {engine} ({half} + {half} from save_odometry_state) "
          f"equal to the continuous runs bit for bit (poses, T_world, map tensors); "
          f"{judged('gicp_model_fused', p_full, poses[:n])}; launches {counts}")
    check(all(counts[k] > 0 for k in MAIN_KERNELS), "K1, K3 or the step kernel was not "
          "launched by the checkpointed runs")
    times["checkpoint"] = time.perf_counter() - t0

    # 2. The native loader and the CLI through it.
    t0 = time.perf_counter()
    check(native.native_available(), "the native IO library did not build")
    print(f"native IO library built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({native.library_path().name})")
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            dump_synthetic_kitti.main([tmp, "--frames", str(n)])
        print("dump_synthetic_kitti: " + out.getvalue().strip())
        paths = list_kitti_scans(tmp)
        check(len(paths) == n, f"{len(paths)} scans written")
        for p in paths:
            check(np.array_equal(native.read_kitti_bin(p), read_kitti_bin(p)),
                  f"native read of {p} differs from numpy's")
        traj = f"{tmp}/est.txt"
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = odometry_benchmark.main([tmp, traj])
        gt = load_kitti_trajectory(f"{tmp}/gt.txt")
        est = load_kitti_trajectory(traj)
        print("odometry_benchmark through DatasetLoader: "
              + " | ".join(out.getvalue().strip().splitlines()[-3:]))
        check(rc == 0 and len(est) == n, f"the CLI exited {rc} with {len(est)} poses")
        print(f"CLI trajectory against gt.txt: {judged('small_gicp', est, gt)}")
    times["native"] = time.perf_counter() - t0

    # 3. RegistrationTPU on phase 5's pair (downsampled at 0.25 m; the lazy
    # covariances at k = 10) from noisy starts, GICP then VGICP.
    t0 = time.perf_counter()
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    down = [voxelgrid_sampling(PointCloud.from_points(s, device=dev), LEAF)
            for s in scans[:2]]
    builds = []
    real_build = interop.KdTree.build

    def counted_build(*args, **kwargs):
        builds.append(1)
        return real_build(*args, **kwargs)

    interop.KdTree.build = staticmethod(counted_build)
    timer = StageTimer()
    try:
        for rtype in ("GICP", "VGICP"):
            reg = RegistrationTPU(device=dev)
            reg.setRegistrationType(rtype)
            reg.setNumNeighborsForCovariance(K_NEIGHBORS)
            reg.setInputTarget(down[0])
            reg.setInputSource(down[1])
            zero_counts()
            builds.clear()
            for rep in range(3):
                before = read_counts()
                with timer.stage(f"RegistrationTPU {rtype}") as box:
                    box["T"] = T = reg.align(noisy_guess(T_gt, rng))
                its = int(reg.getRegistrationResult().iterations) + 1
                got = {k: v - before[k] for k, v in read_counts().items()}
                rot, trans = pose_error(T, T_gt)
                print(f"RegistrationTPU {rtype} start {rep}: {rot:.4f} deg, {trans:.4f} m; "
                      f"{its} LM iterations; launches {got}")
                check(rot < 2.5 and trans < 0.2, f"RegistrationTPU {rtype} outside the "
                      "bounds")
                check(got["knn_moments"] == (2 if rep == 0 else 0),
                      f"RegistrationTPU {rtype}: K3 {got['knn_moments']} launches")
                check(got["gicp_lm_step"] == its and got["gicp_linearize"] == (
                    its if rtype == "GICP" else 0),
                    f"RegistrationTPU {rtype}: K1 {got['gicp_linearize']}, step "
                    f"{got['gicp_lm_step']} launches in {its} LM iterations")
            made = len(builds)
            reg.swapSourceAndTarget()
            before = read_counts()
            T = reg.align(np.linalg.inv(noisy_guess(T_gt, rng)))
            its = int(reg.getRegistrationResult().iterations) + 1
            got = {k: v - before[k] for k, v in read_counts().items()}
            rot, trans = pose_error(T, np.linalg.inv(T_gt))
            print(f"RegistrationTPU {rtype} after swapSourceAndTarget: {rot:.4f} deg, "
                  f"{trans:.4f} m; {its} LM iterations; launches {got}; tree builds "
                  f"{made} before the swap, {len(builds) - made} after")
            check(rot < 2.5 and trans < 0.2, f"RegistrationTPU {rtype} (swapped) outside "
                  "the bounds")
            check(got["knn_moments"] == 0 and len(builds) == made,
                  f"RegistrationTPU {rtype}: the swap made covariances or a tree again")
            check(got["gicp_lm_step"] == its, f"RegistrationTPU {rtype} (swapped): step "
                  f"{got['gicp_lm_step']} launches in {its} LM iterations")
            H = reg.getFinalHessian()
            check(H.shape == (6, 6) and np.isfinite(H).all(), "getFinalHessian")
    finally:
        interop.KdTree.build = real_build
    print(timer.report().replace("\n", "; ") + f" (StageTimer, 3 starts each) on {card}")
    times["RegistrationTPU"] = time.perf_counter() - t0

    # 4. The factor classes at the ground-truth pose, against the unfused
    # route's sums on the same correspondences.
    t0 = time.perf_counter()
    target = estimate_covariances(down[0], num_neighbors=K_NEIGHBORS)
    source = estimate_covariances(down[1], num_neighbors=K_NEIGHBORS)
    tree = KdTree.build(target)
    T = torch.as_tensor(T_gt, dtype=torch.float32, device=dev)
    zero_counts()
    H_i, b_i, e_i, mask = GICPFactor().linearize(target, source, tree, T)
    counts = read_counts()
    corr, _ = registration.search_correspondences(
        "gicp", target, tree, source.points, source.num_points, source.covs, T, 1.0)
    H, b, _ = factors.linearize(corr, T, source.points)
    H_sum, b_sum = H_i.double().sum(0), b_i.double().sum(0)
    rel_H = float((H_sum - H.double()).abs().max() / H.double().abs().max())
    rel_b = float((b_sum - b.double()).abs().max() / b.double().abs().max())
    print(f"GICPFactor().linearize at the ground truth: {int(mask.sum())} inliers of "
          f"{len(source)}; summed H within {rel_H:.2e} and b within {rel_b:.2e} (relative "
          f"to the largest entry) of the unfused route's; launches {counts}")
    check(rel_H <= 1e-5 and rel_b <= 1e-5, "the factor sums disagree with the unfused "
          "route (1e-5 relative)")
    check(counts["nearest_neighbor"] == 1, f"K9 launched {counts['nearest_neighbor']} "
          "times by the factor's search")
    times["factors"] = time.perf_counter() - t0

    # 5. The device generator: statistics of 4 frames at 64 × 1800 against the
    # host generator's, then synthetic_odometry_benchmark over 24 frames.
    t0 = time.perf_counter()
    frames_dev, counts_dev, gen_poses = generate_sequence_device(
        n_frames=4, rings=64, azimuth_steps=1800, device=dev)
    c = counts_dev.cpu().numpy()
    f = frames_dev.cpu().numpy()
    mine = generator_stats([f[i, :c[i], :3] for i in range(4)])
    host = generator_stats(scans[:4])
    print(f"generate_sequence_device (64 x 1800, 4 frames, on the card): {mine[0]:.0f} "
          f"returns a frame, ground share {mine[2]:.4f}; host generator {host[0]:.0f}, "
          f"{host[2]:.4f}; range histograms within {np.abs(mine[1] - host[1]).max():.4f}")
    check(np.array_equal(gen_poses, poses[:4]), "the device generator's poses differ")
    check(abs(mine[0] - host[0]) <= 0.03 * host[0] and abs(mine[2] - host[2]) <= 0.02
          and np.abs(mine[1] - host[1]).max() <= 0.02,
          "the device generator's statistics differ from the host generator's")
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        results = synthetic_odometry_benchmark.main([
            "--frames", str(SYNTH_FRAMES), "--engines", "gicp_model_fused",
            "--chunk-frames", "8", "--rpe-delta", "8"])
    counts = read_counts()
    lines = out.getvalue().strip().splitlines()
    print("synthetic_odometry_benchmark: " + " | ".join(lines[:2]) + f"; launches {counts}")
    ape = results["gicp_model_fused"]["ape_mean"]
    check(ape < 0.2, f"synthetic_odometry_benchmark: APE {ape} m beyond 0.2 m")
    check(all(counts[k] > 0 for k in MAIN_KERNELS), "synthetic_odometry_benchmark did not "
          "launch K1, K3 and the step kernel")
    times["generator"] = time.perf_counter() - t0

    # 6. Profiling: StageTimer above; one traced align.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            reg.align()
        path = f"{tmp}/trace.json"
        size = os.path.getsize(path) if os.path.exists(path) else 0
        kernels = open(path).read().count("gicp_step_kernel") if size else 0
    print(f"trace: {size} bytes of Chrome trace, {kernels} step-kernel events")
    check(size > 0 and kernels > 0, "trace() wrote no trace of the align's kernels")
    times["profiling"] = time.perf_counter() - t0
    print("phase 13 times: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
          + f"; phase 13 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--scale-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.scale_rank is not None:
        scale_rank(args.scale_rank, SCALE_RANKS, args.scale_dir)
        return

    t_start = time.perf_counter()
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
    # Frames 0-1 drive phases 4-5 and 7, frames 0-2 the fleet's two pairs, all
    # 17 the map: two submaps of 8 frames and the scan registered against them.
    scans, poses = generate_sequence(n_frames=2 * SUBMAP_FRAMES + 1, rings=64,
                                     azimuth_steps=1800)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    print(f"frames of {[len(s) for s in scans]} points in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(args.seed)

    records = phase_kernels(scans[:2], T_gt, rng, dev, card)
    launches, reg_per_s = phase_e2e(scans[:2], T_gt, rng, dev, card, records)
    fleet_records, fleet_launches = phase_fleet(scans[:3], poses[:3], rng, dev, card,
                                                reg_per_s)
    records.update(fleet_records)
    launches.update(fleet_launches)
    search_records, search_launches = phase_search(scans[:2], T_gt, rng, dev, card)
    records.update(search_records)
    launches.update(search_launches)
    map_records, map_launches = phase_map(scans, poses, rng, dev, card)
    records.update(map_records)
    launches.update(map_launches)
    phase_voxel(scans, poses, rng, dev, card)
    t_nine = time.perf_counter() - t_start
    phase_odometry(scans, poses, rng, dev, card)
    t_ten = time.perf_counter() - t_start
    phase_rest(scans, poses, rng, dev, card)
    t_eleven = time.perf_counter() - t_start
    phase_scale(scans, poses, rng, dev, card)
    t_twelve = time.perf_counter() - t_start
    phase_api(scans, poses, rng, dev, card)
    print(f"phases 1-9 took {t_nine:.1f} s, phase 10 {t_ten - t_nine:.1f} s, phase 11 "
          f"{t_eleven - t_ten:.1f} s, phase 12 {t_twelve - t_eleven:.1f} s, phase 13 "
          f"{time.perf_counter() - t_start - t_twelve:.1f} s")

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
