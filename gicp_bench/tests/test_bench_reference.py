"""The plain reference against brute force and against the program's CPU
path at small sizes."""

import math

import numpy as np
import pytest
import torch

from gicp_bench import workload as wl
from gicp_bench.reference import gicp as ref_gicp
from gicp_bench.reference import preprocess as ref_pre
from gicp_bench.reference.lie import pose_gap, se3_exp
from gicp_bench.reference.precision import TF32, round_tf32

CPU = torch.device("cpu")
SMALL = {"scanner": {"rings": 16, "azimuth_steps": 256, "max_range": 75.0, "noise": 0.012},
         "world": {"seed": 0, "radius": 80.0}, "frame_dist": 1.2}


@pytest.fixture(scope="module")
def pool():
    torch.manual_seed(0)
    return wl.ScanPool(SMALL, 2, 11, CPU)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -3.3, 0.0])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2.0**-10
    assert r[2] == 1.0  # a tie rounds to even
    assert r[3] == 1.0 + 2.0**-9
    assert abs(float(r[4]) + 3.3) <= 3.3 * 2.0**-11 and r[5] == 0.0
    assert (r.view(torch.int32) & 0x1FFF == 0).all()


def test_se3_and_pose_gap():
    tw = torch.tensor([0.01, -0.02, 0.03, 0.5, -0.2, 0.1], dtype=torch.float64)
    T = se3_exp(tw)
    assert torch.allclose(T[:3, :3] @ T[:3, :3].T, torch.eye(3, dtype=torch.float64))
    dr, dt = pose_gap(torch.eye(4, dtype=torch.float64), T)
    assert dr == pytest.approx(math.degrees(float(tw[:3].norm())), rel=1e-9)
    small = se3_exp(torch.tensor([1e-7, 0, 0, 0, 0, 0], dtype=torch.float64))
    assert pose_gap(torch.eye(4, dtype=torch.float64), small)[0] == pytest.approx(
        math.degrees(1e-7), rel=1e-6)


def test_grid_nearest_is_brute_force():
    g = torch.Generator().manual_seed(3)
    tgt = torch.rand(3000, 3, generator=g, dtype=torch.float64) * 8.0
    q = torch.rand(500, 3, generator=g, dtype=torch.float64) * 10.0 - 1.0
    d2, idx = ref_gicp.Grid(tgt, 1.0).nearest(q, block=128)
    full = ((q[:, None] - tgt[None]) ** 2).sum(-1)
    best, arg = full.min(1)
    near = best <= 1.0
    assert torch.equal(idx[near], arg[near])
    assert torch.allclose(d2[near], best[near])
    assert torch.isinf(d2[~near]).all()


def test_voxelgrid_matches_program(pool):
    from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling

    raw = pool.raw(0)
    got = voxelgrid_sampling(raw, 0.25, device=CPU)
    keys, means = ref_pre.voxelgrid(raw[:, :3], 0.25)
    n = int(got.num_points)
    assert n == means.shape[0] > 1000
    assert float((got.points[:n, :3].double() - means).abs().max()) < 1e-5
    _, cut = ref_pre.voxelgrid(raw[:, :3], 0.25, max_points=100)
    assert torch.equal(cut, means[:100])


def test_covariances_match_program(pool):
    import small_gicp_tpu_torch as pt

    cloud, _ = pt.preprocess_points(pool.raw(0), 0.25, num_neighbors=10, device=CPU)
    ref = ref_pre.preprocess(pool.raw(0)[:, :3], 0.25, 10)
    gaps = wl.cloud_numbers([wl.cloud_gaps(cloud.points, int(cloud.num_points),
                                           cloud.covs, ref)])
    assert gaps["voxels_off"] == 0 and gaps["point_gap_m"] < 1e-5
    assert gaps["cov_gap_p99"] < 1e-5
    low = ref_pre.preprocess(pool.raw(0)[:, :3], 0.25, 10, TF32)
    bad = wl.cloud_numbers([wl.cloud_gaps(low[1], low[1].shape[0], low[2], ref)])
    assert bad["cov_gap_p99"] > 100 * gaps["cov_gap_p99"]


def test_registration_matches_program(pool):
    """On the program's own clouds the reference follows the program's
    path to float rounding; on its own clouds it lands within the spread
    that ill-conditioned covariances allow."""
    import small_gicp_tpu_torch as pt

    (t, tree), (s, _) = (pt.preprocess_points(pool.raw(i), 0.25, num_neighbors=10,
                                              device=CPU) for i in (0, 1))
    T_rel = pool.relative(0, 1)
    T0 = wl.noisy_guesses(T_rel[None], np.random.default_rng(1), 0.03, 0.2)[0]
    got = pt.align(t, s, tree, T0.astype(np.float32), device=CPU)
    config = {"max_correspondence_distance": 1.0, "max_iterations": 20,
              "max_inner_iterations": 10, "rotation_eps": 0.1 * math.pi / 180,
              "translation_eps": 1e-3}
    tgt = wl.live(t.points, int(t.num_points), t.covs)
    src = wl.live(s.points, int(s.num_points), s.covs)
    ref = wl.reference_registration(tgt, src, T0, config)
    answer = dict(T=got.T_target_source.double(), iterations=int(got.iterations),
                  inliers=int(got.num_inliers), converged=bool(got.converged),
                  H=got.H, b=got.b, error=float(got.error))
    n = wl.answer_numbers(answer, tgt, src, config, wl.grid_of(tgt, config), ref)
    assert n["rot_gap_deg"] < 1e-4 and n["trans_gap_m"] < 1e-4
    assert n["converged_off"] == 0 and n["inliers_gap"] < 1e-3
    assert n["H_gap"] < 1e-4 and n["error_gap"] < 1e-4
    refs = wl.RefClouds(pool, 0.25, 10)
    own = wl.reference_registration((refs(0)[1], refs(0)[2]), (refs(1)[1], refs(1)[2]),
                                    T0, config)
    dr, dt = pose_gap(got.T_target_source.double(), own.T)
    assert dr < 0.05 and dt < 0.01
    assert pose_gap(own.T, T_rel)[1] < 0.05  # it registers
