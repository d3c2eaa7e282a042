"""The harness finds every configuration, traffic mix, driver, limit,
metric and roofline by name, and a new one is added as new files and
entries, with no existing file edited."""

import json
import shutil
from types import SimpleNamespace

from gicp_bench import core


def test_every_piece_found_by_name():
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = core.load_cell(w["name"], core.ROOT, bench)
        assert cell.config["name"] == w["config"]
        assert hasattr(cell.driver, "Driver")
        for m in cell.end_to_end + cell.per_layer:
            mod = core.load_module(core.BENCH_DIR / "metrics" / f"{m['name']}.py", "m")
            assert callable(mod.read)


def test_added_as_new_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix (for an
    existing driver), a cell, its limits, a per-layer metric and a roofline
    by new files and new entries only; the copy's harness finds them all."""
    shutil.copytree(core.BENCH_DIR, tmp_path / "gicp_bench")
    before = {p: p.read_bytes() for p in (tmp_path / "gicp_bench").rglob("*")
              if p.is_file()}
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    base = core.load_json(core.BENCH_DIR / "configs" / "hdl64_pair_gicp.json")
    new = tmp_path / "gicp_bench"
    (new / "configs" / "os128_pair_gicp.json").write_text(json.dumps(
        dict(base, name="os128_pair_gicp",
             scanner=dict(base["scanner"], rings=128, azimuth_steps=2048))))
    (new / "traffic" / "pair_prepared_wide.json").write_text(json.dumps(
        dict(core.load_json(core.BENCH_DIR / "traffic" / "pair_prepared.json"),
             guess_sigma_rot=0.3, guess_sigma_trans=2.0)))
    (new / "limits" / "pair_os128_wide.json").write_text(json.dumps({"rot_gap_deg": 1.0}))
    (new / "rooflines" / "k9.py").write_text(
        "def least_seconds(work):\n    return work['queries'] * 8 / 67e12\n")
    (new / "metrics" / "k9_roofline.py").write_text(
        "from gicp_bench import core\n\n\ndef read(ctx):\n"
        "    return 42.0 if ctx.trace_work.get('k9') else None\n")
    bench["configs"].append({"name": "os128_pair_gicp", "source": "https://example.org",
                             "file": "gicp_bench/configs/os128_pair_gicp.json",
                             "reduced": [], "why": "denser frames"})
    bench["workloads"].append({"name": "pair_os128_wide", "config": "os128_pair_gicp",
                               "traffic": "pair_prepared_wide", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "k9_roofline", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "Kernels",
                               "moves": "pair_reg_per_s",
                               "workloads": ["pair_os128_wide"]})
    bench["end_to_end"][1]["workloads"].append("pair_os128_wide")
    copy = core.load_module(new / "core.py", "gicp_bench_core_copy")
    cell = copy.load_cell("pair_os128_wide", tmp_path, bench)
    assert cell.config["scanner"]["rings"] == 128
    assert cell.traffic["guess_sigma_rot"] == 0.3
    assert cell.driver.__file__.startswith(str(new))
    assert cell.limits == {"rot_gap_deg": 1.0}
    assert [m["name"] for m in cell.end_to_end] == ["pair_reg_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["k9_roofline"]
    ctx = copy.Context(trace=SimpleNamespace(), trace_work={"k9": {"queries": 1}})
    assert copy.read_metrics(cell.per_layer, ctx) == {
        "k9_roofline": {"value": 42.0, "unit": "%"}}
    assert copy.roofline("k9").least_seconds({"queries": 67e12}) == 8.0
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
