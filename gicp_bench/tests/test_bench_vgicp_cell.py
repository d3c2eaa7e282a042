"""The cell ``odom_hdl64_vgicp`` at a tiny size on the CPU: a sound run comes
out correct and its traced run reports the cell's program metrics (none,
and no failure, without the program's record); the control and the
``odometry`` driver's planted faults come out not correct; and the
reference's Gaussian map holds a hand-worked three-voxel example."""

import pytest
import torch

from gicp_bench import core, faults, program_spans
from gicp_bench.reference import vgicp as ref_vgicp
from gicp_bench.tests import tiny

CELL = "odom_hdl64_vgicp"
SEED = 2**33 + 17


def test_sound_run_is_correct_and_reports_its_metrics():
    from small_gicp_tpu_torch.utils import profiling

    profiling.reset()
    r = tiny.run(CELL, seed=SEED, trace=True)
    assert r["attempted"] > 0
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(tiny.cell(CELL).limits)
    program = {m["name"] for m in tiny.cell(CELL).per_layer
               if m["source"] in ("program_span", "program_counter")}
    assert program == {"vgicp_lm_iters_per_frame", "vgicp_search_ms", "vgicp_factors_ms",
                       "vgicp_insert_ms"}
    assert program <= set(r["metrics"]), sorted(program - set(r["metrics"]))
    assert all(r["metrics"][k]["value"] > 0 for k in program)


def test_readers_report_nothing_without_a_record(monkeypatch):
    from small_gicp_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "collected")
    assert program_spans.record() is None
    specs = [m for m in tiny.cell(CELL).per_layer if m["source"] != "device_trace"]
    assert core.read_metrics(specs, core.Context()) == {}


def test_control_is_not_correct():
    c = tiny.cell(CELL)
    drv = c.driver.Driver(c.config, c.traffic, SEED, tiny.CPU)
    drv.step(False)
    drv.release()
    assert not core.all_within(core.judge(drv.check(control=True), c.limits))


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_odometry_faults_are_not_correct(fault):
    undo = faults.plant("odometry", fault)
    try:
        r = tiny.run(CELL, seed=SEED)
    finally:
        undo()
    assert r["attempted"] > 0
    assert not r["correct"], r["checks"]


def test_reference_map_by_hand():
    """Three voxels of a 1 m map: two points in (0,0,0), one in (1,0,0), one
    in (0,0,-1); then a second insert that touches (0,0,0) only, and the
    clear at the second insert (cycle 2, horizon 1) evicts the others."""
    d = torch.float64
    vm = ref_vgicp.GaussianVoxelMap(1.0, lru_horizon=1, lru_clear_cycle=2)
    pts = torch.tensor([[0.2, 0.4, 0.6], [0.6, 0.8, 0.2], [1.5, 0.5, 0.5],
                        [0.5, 0.5, -0.5]], dtype=d)
    covs = torch.stack([torch.eye(3, dtype=d) * s for s in (1.0, 3.0, 2.0, 4.0)])
    vm.insert(pts, covs)
    assert vm.counter == 1
    # Keys ascend by (z, y, x): (0,0,-1), (0,0,0), (1,0,0).
    assert vm.count.tolist() == [1, 2, 1]
    assert torch.allclose(vm.means, torch.tensor(
        [[0.5, 0.5, -0.5], [0.4, 0.6, 0.4], [1.5, 0.5, 0.5]], dtype=d))
    assert torch.allclose(vm.covs, torch.stack(
        [torch.eye(3, dtype=d) * s for s in (4.0, 2.0, 2.0)]))
    assert vm.stamp.tolist() == [0, 0, 0]
    vm.insert(torch.tensor([[0.1, 0.1, 0.1]], dtype=d), torch.eye(3, dtype=d)[None] * 5.0)
    # Counter 2: a clear; stamps 0 + 1 < 2 go, the touched voxel (stamp 1)
    # stays with the sums of its three points.
    assert vm.counter == 2
    assert vm.count.tolist() == [3]
    assert torch.allclose(vm.means, torch.tensor([[0.3, 1.3 / 3, 0.3]], dtype=d))
    assert torch.allclose(vm.covs, torch.eye(3, dtype=d)[None] * 3.0)
    assert vm.stamp.tolist() == [1]
    d2, idx = vm.lookup(7).nearest(torch.tensor([[0.3, 0.4, 0.3], [1.2, 0.4, 0.3],
                                                 [2.5, 0.4, 0.3]], dtype=d))
    assert idx.tolist() == [0, 0, 0]
    assert d2[:2].tolist() == pytest.approx([(0.4 - 1.3 / 3) ** 2,
                                             0.9 ** 2 + (0.4 - 1.3 / 3) ** 2])
    assert d2[2] == float("inf")
