"""VGICP scan-to-model odometry (``JitOdometry`` with the ``vgicp_model``
engine) against the benchmark's plain reference (``gicp_bench/reference/
vgicp.py``: a float64 Gaussian voxel map with small_gicp's LRU, VGICP by
voxel key) on the CPU, at a small size: a seeded synthetic lap of 16 rings
× 256 steps, 12 frames 0.5 m apart in 2-frame chunks, a short LRU (horizon
3, a clear every 2 inserts) so that voxels are evicted, at 1 and 7 search
offsets. The frames are closer than the cell's 1.2 m so that a one-voxel
search converges within its 20 iterations from the previous pose: an LM
cut off there lands wherever rounding leads it, and two runs need not agree.

Every chunk goes through the comparison the cell ``odom_hdl64_vgicp``
makes (``gicp_bench/drivers/odometry_vgicp.compare_chunk``): each frame
aligned by the reference's VGICP from the program's previous pose over the
program's map before the frame (read through its views; the chunk's
earlier frames folded in by the reference), every voxel the chunk touched
(mean, covariance, count) against the reference's fold of the frame's
points at the program's pose, and the live voxel set after eviction,
counted from the frames fed. The same comparison with the reference
computed in TF32 in the program's place, and with the program's insert
broken (covariances left undivided by the count), fails."""

import dataclasses
import math

import pytest
import torch

from gicp_bench.drivers.odometry_vgicp import compare_chunk, placed
from gicp_bench.reference import vgicp as ref_vgicp
from small_gicp_tpu_torch.models import voxelmap
from small_gicp_tpu_torch.models.odometry import OdometryParams
from small_gicp_tpu_torch.models.odometry_scan import JitOdometry
from small_gicp_tpu_torch.utils import synthetic

FRAMES, CHUNK = 12, 2
FRAME_DIST = 0.5
PARAMS = OdometryParams(max_scan_points=4096, max_downsampled=4096, map_capacity=8192,
                        lru_horizon=3, lru_clear_cycle=2)
LM = dict(max_dist=PARAMS.max_correspondence_distance, max_iterations=20,
          max_inner_iterations=10, rotation_eps=0.1 * math.pi / 180.0,
          translation_eps=1e-3)
# The program computes in float32 what the reference computes in float64.
TOL = {
    # The poses: the LM stops at the first step under 0.1 deg and 1 mm, and
    # rounding may stop the program and the reference one step apart, a
    # fraction of that step: 5e-4 deg / 4e-4 m against a map of one sparse
    # frame, 2e-5 elsewhere. TF32's 10-bit mantissa moves them 5e-2 deg and
    # 1e-2 m.
    "rot_gap_deg": 2e-3,
    "trans_gap_m": 2e-3,
    # A voxel mean: points of up to 100 m placed in float32 (ulp 7.6e-6 m)
    # and the voxel's sums rebuilt from its float32 mean times its count:
    # 1e-5 m.
    "map_mean_gap_m": 1e-4,
    # Counts and the live set are integers: a point within the comparison's
    # face band is left out of both, so every other one must agree exactly.
    "map_count_off": 0,
    "voxels_off": 0,
    # A covariance entry (of order 1) scaled by the conditioning of the
    # voxel's least conditioned point: float32 rounding of the moments,
    # 1e-6.
    "map_cov_gap": 1e-5,
}


def _run(num_offsets: int):
    """(carries around each chunk, poses [F,4,4] float64, raw frames) of the
    program over the lap."""
    scans, _ = synthetic.generate_sequence(n_frames=FRAMES, seed=3, rings=16,
                                           azimuth_steps=256, frame_dist=FRAME_DIST)
    params = dataclasses.replace(PARAMS, num_offsets=num_offsets)
    odo = JitOdometry(params, engine="vgicp_model", chunk_frames=CHUNK, device="cpu")
    frames, counts = odo.preload(scans)
    carries, poses = [], []
    for s in range(0, FRAMES, CHUNK):
        before = odo.carry
        poses.append(torch.as_tensor(odo.feed_preloaded(
            frames[s:s + CHUNK], counts[s:s + CHUNK], n_real=CHUNK), dtype=torch.float64))
        carries.append((before, odo.carry))
    raws = [frames[i, :int(counts[i]), :3] for i in range(FRAMES)]
    return carries, torch.cat(poses), raws, params


def _compare(run, control: bool = False) -> dict:
    """The largest of each number over every chunk (covariance gaps: the
    largest voxel's)."""
    carries, P, raws, params = run
    out = dict.fromkeys(TOL, 0.0)
    for c, (before, after) in enumerate(carries):
        n0 = c * CHUNK
        history = [(m, placed(raws[m], P[m], params))
                   for m in range(max(0, n0 - params.lru_horizon), n0)]
        numbers, cov = compare_chunk(before[2], after[2], before[0], P[n0:n0 + CHUNK],
                                     raws[n0:n0 + CHUNK], n0, history, params, LM, control)
        numbers["map_cov_gap"] = float(cov.max()) if cov.numel() else 0.0
        for k, v in numbers.items():
            out[k] = max(out[k], v)
    return out


@pytest.fixture(scope="module", params=[1, 7], ids=["offsets1", "offsets7"])
def run(request):
    torch.set_num_threads(4)
    return _run(request.param)


def test_poses_and_map_match_the_reference(run):
    got = _compare(run)
    assert all(got[k] <= TOL[k] for k in TOL), got
    # Voxels were evicted, and the live set still agreed.
    carries = run[0]
    live = [int(after[2].num_voxels) for _, after in carries]
    assert any(b > a for b, a in zip(live, live[1:])), live


def test_tf32_reference_in_the_programs_place_fails(run):
    got = _compare(run, control=True)
    assert any(got[k] > TOL[k] for k in TOL), got


def test_insert_with_undivided_covariances_fails(monkeypatch):
    """A fault planted in the program's Gaussian insert: each voxel's
    covariance left as the sum of its points' covariances."""
    orig = voxelmap._gvm_insert

    def broken(vm, points, covs, num_points):
        out = orig(vm, points, covs, num_points)
        payload = out.payload.clone()
        payload[:, 4:13] *= payload[:, 13:14].clamp(min=1.0)
        return out.replace(payload=payload)

    monkeypatch.setattr(voxelmap, "_gvm_insert", broken)
    got = _compare(_run(7))
    assert got["map_cov_gap"] > TOL["map_cov_gap"], got


def test_reference_lookup_takes_the_first_of_equal_means():
    """Two voxel means at the same distance from a query: the reference's
    search takes the one whose offset comes first, (0,0,0) before ±x, as the
    program's does."""
    vm = ref_vgicp.GaussianVoxelMap(1.0)
    pts = torch.tensor([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5]], dtype=torch.float64)
    vm.insert(pts, torch.eye(3, dtype=torch.float64).expand(2, 3, 3))
    q = torch.tensor([[1.0, 0.5, 0.5], [1.2, 0.5, 0.5]], dtype=torch.float64)
    d2, idx = vm.lookup(7).nearest(q)
    assert idx.tolist() == [1, 1] and d2.tolist() == pytest.approx([0.25, 0.09])
    d2, idx = vm.lookup(7).nearest(q - torch.tensor([1e-12, 0.0, 0.0],
                                                    dtype=torch.float64))
    assert idx.tolist() == [0, 1]
    d2, idx = vm.lookup(1).nearest(torch.tensor([[2.7, 0.5, 0.5]], dtype=torch.float64))
    assert math.isinf(d2[0]) and idx.tolist() == [0]
