"""The harness that no cell owns: it reads ``BENCHMARK.json``, finds a
cell's configuration, traffic mix, driver, limits and metric readers by
name, runs set-up, the measured window, the traced stretch and the
comparison with the reference, and builds the result line.

Layout under ``gicp_bench/`` (each piece found by the name that
``BENCHMARK.json`` or a traffic file gives it, so that a later change adds
a piece as a new file and an entry, never by editing one):
  * ``configs/<config>.json``  — a deployment's sizes and semantics;
  * ``traffic/<traffic>.json`` — a traffic mix: parameters, and the name
    of the driver that reads them (``"driver"``);
  * ``drivers/<driver>.py``    — builds the inputs from the seed, warms up,
    drives the program's entry one unit at a time, and compares what the
    timed path produced with the reference;
  * ``limits/<workload>.json`` — each compared number's limit in a cell;
  * ``metrics/<metric>.py``    — ``read(ctx)``: one metric from the
    window's counts and clock, the spans, or the traced stretch;
  * ``rooflines/<kernel>.py``  — ``least_seconds(work)``: a kernel's least
    time on the card from its inputs alone.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "small_gicp_tpu")


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    chips: int
    driver: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]


def applies(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed in its
    ``workloads``, or, without that key, reported wherever what it moves
    (an end-to-end metric: everywhere) is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    driver = load_module(BENCH_DIR / "drivers" / f"{traffic['driver']}.py",
                         f"gicp_bench_driver_{traffic['driver']}")
    limits_path = BENCH_DIR / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if applies(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if applies(m, name, e2e_names)]
    return Cell(name=name, config=config, traffic=traffic, limits=limits,
                chips=int(w["chips"]), driver=driver, end_to_end=e2e,
                per_layer=per_layer)


@dataclass
class Context:
    """What metric readers read."""

    setup_s: float = 0.0
    window_s: float = 0.0
    counts: Dict[str, float] = field(default_factory=dict)  # the window's work
    spans: Dict[str, List[float]] = field(default_factory=dict)  # host-clock spans, s
    trace: object = None  # profiling.TraceSummary of the traced stretch
    trace_counts: Dict[str, float] = field(default_factory=dict)
    trace_work: Dict[str, dict] = field(default_factory=dict)  # per kernel, for rooflines


def read_metrics(specs: List[dict], ctx: Context) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every spec whose reader finds something
    to read; a reader that finds nothing returns None and is left out."""
    out = {}
    for m in specs:
        mod = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                          f"gicp_bench_metric_{m['name'].replace('.', '_')}")
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def roofline(kernel: str) -> ModuleType:
    return load_module(BENCH_DIR / "rooflines" / f"{kernel}.py",
                       f"gicp_bench_roofline_{kernel}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}}; a number without a limit has none to pass."""
    return {k: {"value": float(v), "limit": limits.get(k)} for k, v in numbers.items()}


def all_within(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(
        c["limit"] is not None and c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Set-up, window, (traced stretch), comparison: the result line's dict.
    ``t_start`` is the process's first clock reading (set-up starts there)."""
    import torch

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    from gicp_bench import hostinfo

    drv = cell.driver.Driver(cell.config, cell.traffic, seed, device)
    sync()
    ctx = Context(setup_s=time.perf_counter() - t_start)
    attempted = 0
    host = hostinfo.Window()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while (now := time.perf_counter()) < deadline:
        host.tick(now, attempted)
        attempted += drv.step(trace)
    sync()
    ctx.window_s = time.perf_counter() - t0
    host = host.close(attempted)
    host["gpu"] = hostinfo.gpu() if cuda else {}
    ctx.counts = drv.window_counts()
    ctx.spans = drv.spans

    result = {}
    if trace:
        from gicp_bench.profiling import summarize
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            drv.traced_stretch()
            sync()
            tw = time.perf_counter() - t1
        ctx.trace = summarize(prof, tw)
        ctx.trace_counts, ctx.trace_work = drv.trace_counts(), drv.trace_work()
        del prof

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded in the benchmark's process: {bad}")

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = drv.failed()
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
    drv.release()
    t_check = time.perf_counter()
    checks = judge(drv.check(), cell.limits)
    check_s = time.perf_counter() - t_check
    correct = attempted > 0 and all_within(checks)
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev_info["busy_s"] = ctx.trace.busy_s
        dev_info["window_s"] = ctx.trace.window_s
    result.update({"correct": correct, "attempted": attempted, "failed": failed,
                   "metrics": metrics, "device": dev_info})
    if trace:
        result["breakdown"] = {"device_ops": [list(x) for x in ctx.trace.device_ops],
                               "idle_gaps": [list(x) for x in ctx.trace.idle_gaps]}
    result["checks"] = checks
    print(f"gicp_bench: host {json.dumps(host)}", file=sys.stderr)
    print(f"gicp_bench: window {ctx.window_s:.3f} s, comparison {check_s:.3f} s",
          file=sys.stderr)
    return result
