"""vgicp_launches_per_lm_iter: kernel launches the host issues (the
profiler's CUDA runtime launch calls) over the traced stretch, per LM
iteration the program counted in it (``lm_iterations``)."""

from gicp_bench.program_spans import record


def read(ctx):
    rec = record() if ctx.trace else None
    n = rec["counters"].get("lm_iterations") if rec else None
    return ctx.trace.api["launches"] / n if n else None
