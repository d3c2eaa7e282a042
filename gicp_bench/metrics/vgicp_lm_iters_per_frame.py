"""vgicp_lm_iters_per_frame: LM iterations a VGICP odometry frame runs, the
program's ``lm_iterations`` over its ``frames`` counter in the traced
stretch."""

from gicp_bench.program_spans import record


def read(ctx):
    rec = record()
    n = rec["counters"].get("frames") if rec else None
    return rec["counters"].get("lm_iterations", 0) / n if n else None
