"""Each cell runs end to end at a tiny size on the CPU: a sound run comes
out correct against the cell's limits; the control (the reference in TF32
in the program's place) and the program with its timed path broken
underneath (``gicp_bench/faults.py``) come out not correct."""

import pytest
import torch

from gicp_bench import core, faults
from gicp_bench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_run_is_correct(name):
    r = tiny.run(name)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["attempted"] > 0
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(tiny.cell(name).limits)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_is_not_correct(name):
    c = tiny.cell(name)
    drv = c.driver.Driver(c.config, c.traffic, 2**31 + 11, tiny.CPU)
    drv.step(False)
    drv.window_counts()
    drv.release()
    checks = core.judge(drv.check(control=True), c.limits)
    assert not core.all_within(checks), checks


def test_traced_run_reads_its_metrics():
    r = tiny.run("pair_hdl64_prepared", trace=True)
    assert {"pair_align_ms_p95", "lm_iters_per_reg"} <= set(r["metrics"])
    assert list(r)[-2:] == ["breakdown", "checks"]


# ------------------------------------------------------------- faults --

@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", tiny.CELLS)
def test_broken_timed_path_is_not_correct(name, fault):
    undo = faults.plant(tiny.cell(name).traffic["driver"], fault)
    try:
        r = tiny.run(name)
    finally:
        undo()
    assert r["attempted"] > 0
    assert not r["correct"], r["checks"]


class _Map:
    """A map as the odometry's comparison reads it: its public views."""

    def __init__(self, points, covs, live):
        self.p, self.c, self.live = points, covs, live

    def points_flat(self):
        return self.p

    def covs_flat(self):
        return self.c

    def valid_points_mask(self):
        return self.live


def test_odometry_split_matches_rows_wherever_stored():
    """The rows a chunk kept, added and evicted are found by value, so a map
    that stores its rows at other slots reads the same."""
    from gicp_bench.drivers import odometry

    g = torch.Generator().manual_seed(5)
    rows = torch.randn(40, 4, generator=g)
    covs = torch.randn(40, 3, 3, generator=g)
    live0 = torch.arange(40) < 30          # rows 0-29 before the chunk
    live1 = (torch.arange(40) >= 10)       # 0-9 evicted, 30-39 added
    m0 = _Map(rows, covs, live0)
    for order in (torch.arange(40), torch.randperm(40, generator=g)):
        m1 = _Map(rows[order], covs[order], live1[order])
        kept, added, evicted = odometry._split(m0, m1)
        assert sorted(kept[0][:, 0].tolist()) == sorted(rows[10:30, 0].tolist())
        assert sorted(added[0][:, 0].tolist()) == sorted(rows[30:, 0].tolist())
        assert sorted(evicted[0][:, 0].tolist()) == sorted(rows[:10, 0].tolist())
        assert torch.equal(added[1][added[0][:, 0].argsort()],
                           covs[30:][rows[30:, 0].argsort()])


def test_pair_pool_is_the_same_for_every_seed():
    """Every seed registers the same pairs (spread round the loop); only the
    sensor noise and the order move with it."""
    from gicp_bench import workload as wl

    c = tiny.cell("pair_hdl64_prepared")
    a = wl.pair_pool(c.config, 4, 2**31 + 11, tiny.CPU)
    b = wl.pair_pool(c.config, 4, 2**33 + 5, tiny.CPU)
    assert a.ids.tolist() == b.ids.tolist()
    assert a.ids[1::2].tolist() == (a.ids[::2] + 1).tolist()
    assert a.ids[2] - a.ids[0] > 100
    assert not torch.equal(a.frames, b.frames)
