"""launches_per_lm_iter: kernel launches the host issues (the profiler's
CUDA runtime launch calls) over the traced stretch, per LM iteration run in
it."""


def read(ctx):
    n = ctx.trace_counts.get("lm_iterations") if ctx.trace else None
    return ctx.trace.api["launches"] / n if n else None
