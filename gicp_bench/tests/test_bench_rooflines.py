"""Each roofline count equals its formula on hand-counted shapes, depends on
inputs and outputs only, and each roofline metric reads its kernels by
name from a trace."""

from types import SimpleNamespace

import pytest

from gicp_bench import core, peaks
from gicp_bench.profiling import TraceSummary, union_seconds


def test_k1_hand_counted():
    # 2 launches of a 1,000-row source against a 2,000-row target, 900 inliers each.
    work = {"launches": 2, "source_rows": 2000, "target_rows": 4000, "inliers": 1800}
    flops = 8 * 2000 + 150 * 1800  # 286,000
    nbytes = 36 * 6000 + 288 * 2  # 216,576
    assert core.roofline("k1").least_seconds(work) == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12))
    assert nbytes / 3.35e12 > flops / 67e12  # bytes bound the least time


def test_k3_hand_counted():
    work = {"launches": 2, "rows": 50_000, "k": 10}
    assert core.roofline("k3").least_seconds(work) == pytest.approx(
        max(18 * 10 * 50_000 / 67e12, 52 * 50_000 / 3.35e12))


def test_k7_hand_counted():
    work = {"problem_iterations": 10, "source_rows": 10 * 20_000, "inliers": 10 * 18_000,
            "pair_rows_once": 2 * 40_000}
    flops = 8 * 200_000 + 150 * 180_000
    assert core.roofline("k7").least_seconds(work) == pytest.approx(
        max(flops / 67e12, 36 * 80_000 / 3.35e12))


def test_counts_ignore_what_the_kernel_visits():
    """The same inputs give the same least time whatever else the work
    record carries (pairs or tiles visited)."""
    base = {"launches": 1, "source_rows": 100, "target_rows": 100, "inliers": 50}
    assert core.roofline("k1").least_seconds(dict(base, pairs_visited=10**9)) == \
        core.roofline("k1").least_seconds(base)


def test_peaks():
    assert peaks.least_seconds(67e12, 0) == 1.0
    assert peaks.least_seconds(0, 3.35e12) == 1.0


@pytest.mark.parametrize("kernel, name", [
    ("k1", "void gicp_linearize_listed_kernel<float, 16, false>(float const*)"),
    ("k3", "void knn_moments_kernel<16>(float const*, float const*)"),
    ("k7", "gicp_linearize_fleet_kernel(float const*, float const*)")])
def test_roofline_metric_reads_its_kernel(kernel, name):
    work = {"k1": {"source_rows": 10**6, "target_rows": 10**6, "inliers": 10**6},
            "k3": {"rows": 10**6, "k": 10},
            "k7": {"source_rows": 10**6, "inliers": 10**6, "pair_rows_once": 10**6}}
    trace = TraceSummary(window_s=1.0, busy_s=0.5,
                         kernels={name: (4, 0.01), "knn_moments_kernel_v1": (9, 9.0)})
    ctx = core.Context(trace=trace, trace_work={kernel: work[kernel]})
    mod = core.load_module(core.BENCH_DIR / "metrics" / f"{kernel}_roofline.py", "m")
    least = core.roofline(kernel).least_seconds(dict(work[kernel], launches=4))
    assert mod.read(ctx) == pytest.approx(100 * least / 0.01)
    assert mod.read(core.Context(trace=trace, trace_work={})) is None


def test_union_of_device_intervals():
    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert union_seconds([]) == 0


def test_idle_share_reads_nothing_without_device_work():
    mod = core.load_module(core.BENCH_DIR / "metrics" / "idle_share.pair.py", "m")
    assert mod.read(core.Context(trace=SimpleNamespace(window_s=2.0, busy_s=0.5))) == 75.0
    assert mod.read(core.Context(trace=SimpleNamespace(window_s=2.0, busy_s=0.0))) is None
