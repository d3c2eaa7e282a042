"""Nothing the benchmark runs imports JAX or the JAX package; the
reference imports nothing of the program; ``run.py`` refuses to run
without the cards or without the program."""

import ast
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from gicp_bench import core


def imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_imports_jax():
    for path in core.BENCH_DIR.rglob("*.py"):
        for name in imported_names(path):
            assert name.split(".")[0] not in core.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (core.BENCH_DIR / "reference").rglob("*.py"):
        for name in imported_names(path):
            top = name.split(".")[0]
            assert top not in ("small_gicp_tpu_torch",) + core.FORBIDDEN, (path, name)
            if top == "gicp_bench":
                assert name.startswith("gicp_bench.reference"), (path, name)


@pytest.mark.parametrize("name, bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("small_gicp_tpu", True), ("small_gicp_tpu.ops.knn", True),
    ("small_gicp_tpu_torch", False), ("small_gicp_tpu_torch.ops.knn", False),
    ("jaxtyping", False), ("gicp_bench", False)])
def test_forbidden_compares_whole_top_level_names(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in core.forbidden_modules()) == bad


def test_harness_loads_no_jax():
    """Everything a run imports on its way to the result, in a fresh
    interpreter: the harness, every driver, metric and roofline, the
    reference and the program."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(core.ROOT)!r})
        from gicp_bench import core, calibrate, profiling, workload
        import small_gicp_tpu_torch
        from small_gicp_tpu_torch.models import odometry_scan
        bench = core.load_json(core.ROOT / "BENCHMARK.json")
        for w in bench["workloads"]:
            core.load_cell(w["name"], core.ROOT, bench)
        for p in sorted((core.BENCH_DIR / "metrics").glob("*.py")):
            core.load_module(p, "m")
        for p in sorted((core.BENCH_DIR / "rooflines").glob("*.py")):
            core.load_module(p, "r")
        print(core.forbidden_modules())
    """)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def run_py(cwd, *extra):
    return subprocess.run([sys.executable, "gicp_bench/run.py", "--workload",
                           "pair_hdl64_prepared", "--seed", "5", "--seconds", "1",
                           "--trace", "0", *extra], cwd=cwd, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_refuses_without_a_card():
    out = run_py(core.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(core.BENCH_DIR, tmp_path / "gicp_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
