"""The port's recorder of spans and counters (``utils/profiling.py``) on
the CPU: nesting and self time, nothing recorded and no profiler call made
while it is off, flat profiler annotations named by the open path, the
spans and counters of an ``align`` and of a two-chunk ``JitOdometry`` on
the synthetic world, poses bit for bit the same with tracing on and off,
and ``trace(logdir)`` writing the spans out."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from small_gicp_tpu_torch.models.helper import align
from small_gicp_tpu_torch.models.odometry import OdometryParams
from small_gicp_tpu_torch.models.odometry_scan import JitOdometry
from small_gicp_tpu_torch.utils import profiling, synthetic

ALIGN_SPANS = {"align", "preprocess", "pre.voxelgrid", "pre.tree", "pre.covs",
               "align.state", "align.prepare", "lm.iter", "lm.linearize", "lm.step",
               "read.stop"}
ODOM_SPANS = {"odom.chunk", "odom.frame", "odom.preprocess", "pre.voxelgrid", "pre.covs",
              "odom.register", "align.state", "align.prepare", "lm.iter",
              "lm.linearize", "lm.step", "read.stop", "odom.insert", "insert.sort",
              "insert.lookup", "insert.evict", "insert.scatter", "read.chunk_sync",
              "read.poses"}


@pytest.fixture(autouse=True)
def clean_record():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    scans, poses = synthetic.generate_sequence(n_frames=4, rings=8, azimuth_steps=128)
    return scans, poses


def _align(world):
    scans, poses = world
    T0 = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    return align(scans[0], scans[1], init_T_target_source=T0, device="cpu")


def _odometry(world):
    params = OdometryParams(max_scan_points=1024, max_downsampled=1024, map_capacity=4096)
    odo = JitOdometry(params, engine="gicp_model_fused", chunk_frames=2, device="cpu")
    frames, counts = odo.preload(world[0])
    return odo.feed_preloaded(frames, counts, n_real=len(world[0]))


def _annotations(prof, names):
    """(start, end, name) of the program's profiler annotations: the events
    named by a path of the program's span names."""
    def program(path):
        return all(part in names or part.startswith("read.") for part in path.split("/"))

    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if program(e.name))


def test_nesting_and_self_time():
    with profiling.tracing():
        with profiling.span("outer"):
            time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.004)
                with profiling.host_read("x"):
                    pass
            with profiling.span("inner"):
                profiling.count("units", 3)
    rec = profiling.collected()
    outer, inner, read = (rec["spans"][k] for k in ("outer", "inner", "read.x"))
    assert (outer["count"], inner["count"], read["count"]) == (1, 2, 1)
    assert inner["self_s"] == pytest.approx(inner["total_s"] - read["total_s"], abs=1e-9)
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    assert outer["self_s"] >= 0.002 and inner["total_s"] >= 0.004
    assert rec["counters"] == {"units": 3, "host_reads": 1}
    by_id = {r["id"]: r for r in rec["records"]}
    assert [r["name"] for r in rec["records"]] == ["read.x", "inner", "inner", "outer"]
    for r in rec["records"]:
        parent = by_id.get(r["parent"])
        if r["name"] == "outer":
            assert r["parent"] == -1
        else:
            assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] <= parent["end_ns"]
    assert rec["dropped"] == 0


def test_tracing_records_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.tracing():
        with profiling.tracing():
            profiling.count("a")
        profiling.count("a")
        with profiling.span("s"):
            pass
    profiling.count("a")
    rec = profiling.collected()
    assert rec["counters"] == {"a": 2}
    assert rec["spans"]["s"]["count"] == 1
    profiling.reset()
    assert profiling.collected()["counters"] == {}


def test_off_records_nothing_and_opens_no_annotation(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler annotation opened while tracing is off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_annotate", refuse)
    sites = [profiling.span("a"), profiling.host_read("b"), profiling.span("c")]
    assert all(s is sites[0] for s in sites)
    with profiling.span("a"):
        with profiling.host_read("b"):
            profiling.count("frames")
    assert profiling.collected() == {"spans": {}, "counters": {}, "records": [],
                                     "dropped": 0}


def test_annotations_are_flat_and_named_by_the_open_path():
    x = torch.ones(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("a"):
            x = x.cumsum(0)
            with profiling.span("b"):
                x = x * 2
                with profiling.host_read("c"):
                    x.sum().item()
            x = x + 1
            with profiling.span("d"):
                x = x - 1
            x = x / 2
    notes = _annotations(prof, {"a", "b", "d"})
    assert [n for _, _, n in notes] == ["a", "a/b", "a/b/read.c", "a/b", "a", "a/d", "a"]
    for (_, end, _), (start, _, _) in zip(notes, notes[1:]):
        assert end <= start
    rec = profiling.collected()
    assert rec["spans"]["a"]["count"] == 1 and rec["counters"]["host_reads"] == 1


def test_align_records_every_span(world):
    with profiling.tracing():
        r = _align(world)
    rec = profiling.collected()
    assert ALIGN_SPANS <= set(rec["spans"])
    n = rec["counters"]["lm_iterations"]
    assert rec["counters"]["registrations"] == 1
    assert n == int(r.iterations) + 1
    assert rec["spans"]["lm.iter"]["count"] == n == rec["spans"]["read.stop"]["count"]
    assert rec["spans"]["preprocess"]["count"] == 2
    reads = sum(v["count"] for k, v in rec["spans"].items() if k.startswith("read."))
    assert rec["counters"]["host_reads"] == reads


def test_odometry_records_every_span_and_keeps_its_poses(world):
    off = _odometry(world)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _odometry(world)
    assert np.array_equal(off, on)
    rec = profiling.collected()
    spans, counters = rec["spans"], rec["counters"]
    assert ODOM_SPANS <= set(spans)
    frames = len(on)
    assert counters["frames"] == frames == spans["odom.frame"]["count"]
    assert counters["registrations"] == frames
    assert counters["lm_iterations"] == spans["lm.iter"]["count"]
    assert spans["odom.chunk"]["count"] == spans["read.chunk_sync"]["count"] == 2
    inside = sum(spans[k]["total_s"] for k in ("odom.preprocess", "odom.register",
                                                "odom.insert"))
    assert inside <= spans["odom.frame"]["total_s"]
    notes = _annotations(prof, ODOM_SPANS)
    assert len(notes) > 2 * spans["odom.frame"]["count"]
    for (_, end, _), (start, _, _) in zip(notes, notes[1:]):
        assert end <= start
    assert {"odom.chunk/odom.frame/odom.insert/insert.scatter",
            "odom.chunk/odom.frame/odom.register/lm.iter/read.stop",
            "read.poses"} <= {n for _, _, n in notes}


def test_align_poses_bit_identical_with_tracing_on_and_off(world):
    off = _align(world)
    with profiling.tracing():
        on = _align(world)
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _align(world)
    assert torch.equal(off.T_target_source, on.T_target_source)
    assert torch.equal(off.T_target_source, profiled.T_target_source)
    assert int(off.iterations) == int(on.iterations) == int(profiled.iterations)


def test_trace_writes_the_spans(tmp_path):
    with profiling.span("before"):  # not recorded: nothing records yet
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(64).cumsum(0)
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())
             ["traceEvents"]}
    assert {"outer", "outer/inner"} <= names
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert set(spans["spans"]) == {"outer", "inner"}
    assert [r["name"] for r in spans["records"]] == ["inner", "outer"]


def test_stage_timer_stages_are_spans():
    timer = profiling.StageTimer()
    with profiling.tracing():
        with timer.stage("load") as box:
            box["x"] = torch.ones(4)
    rec = profiling.collected()
    assert rec["spans"]["load"]["count"] == 1 and rec["spans"]["read.stage"]["count"] == 1
    assert rec["counters"] == {"host_reads": 1}
    assert timer.stages["load"].count == 1
