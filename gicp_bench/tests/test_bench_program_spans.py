"""The metrics read from the program's own spans and counters
(``program_spans.py``): a tiny traced run of each cell reports every one of
its cell's, and a program that keeps no record (one from before the
recorder) makes each reader report nothing rather than fail."""

import pytest

from gicp_bench import core, program_spans
from gicp_bench.tests import tiny

CELLS = ("odom_hdl64_stream", "pair_hdl64_prepared", "pair_hdl64_raw")


def _program_metrics(name):
    return {m["name"] for m in tiny.cell(name).per_layer
            if m["source"] in ("program_span", "program_counter")}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_program_metrics(name):
    from small_gicp_tpu_torch.utils import profiling

    profiling.reset()
    r = tiny.run(name, trace=True)
    want = _program_metrics(name)
    assert len(want) >= 4
    assert want <= set(r["metrics"]), sorted(want - set(r["metrics"]))
    values = {k: r["metrics"][k]["value"] for k in want}
    assert all(v >= 0 for v in values.values()), values
    if name == "odom_hdl64_stream":
        # The CPU makes no synchronize call: every read is named.
        assert values["odom_unnamed_syncs_per_frame"] == 0
        assert values["odom_register_ms"] > 0
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_readers_report_nothing_without_a_record(name, monkeypatch):
    """As on a program from before the recorder: ``collected`` absent."""
    from small_gicp_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "collected")
    assert program_spans.record() is None
    ctx = core.Context()
    specs = [m for m in tiny.cell(name).per_layer if m["name"] in _program_metrics(name)]
    assert core.read_metrics(specs, ctx) == {}
