"""BENCHMARK.json against the benchmark's contract, and every piece it
names found on disk by its name."""

import json
import re

import pytest

from gicp_bench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return core.load_json(core.ROOT / "BENCHMARK.json")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == KEYS["top"]
    assert bench["command"][:2] == ["python3", "gicp_bench/run.py"]
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (core.ROOT / p).is_dir()
    for w in bench["command"]:
        assert line(w) and not w.startswith("/") and ".." not in w
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == KEYS["config"]
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["name"] in used
        assert c["file"].startswith("gicp_bench/") and c["file"] not in files
        files.add(c["file"])
        conf = core.load_json(core.ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert "assumed" in conf
        for k in c["reduced"]:
            assert NAME.match(k)


def test_workloads(bench):
    names = set()
    pairs = set()
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == KEYS["workload"]
        assert NAME.match(w["name"]) and w["name"] not in names
        names.add(w["name"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        assert (core.BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"]
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"]
        assert m["moves"] in e2e and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        layers.add(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (core.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        cell = core.load_cell(w["name"], core.ROOT, bench)
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
        assert (core.BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
        assert cell.limits and all(v is not None for v in cell.limits.values())


def test_rooflines_named_by_metrics(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["better"] == "higher"
            kernel = m["name"][: -len("_roofline")]
            assert hasattr(core.roofline(kernel), "least_seconds")


def test_spare_cells_would_report_enough():
    """The spare cells' entries, copied into BENCHMARK.json, make cells that
    meet the same rules."""
    from gicp_bench.tests import tiny

    test_every_cell_reports_enough(tiny.bench())
    test_rooflines_named_by_metrics(tiny.bench())
