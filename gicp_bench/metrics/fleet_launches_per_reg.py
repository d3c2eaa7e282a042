"""fleet_launches_per_reg: kernel launches the host issues (the profiler's
CUDA runtime launch calls) over the traced stretch, per fleet problem."""


def read(ctx):
    n = ctx.trace_counts.get("problems") if ctx.trace else None
    return ctx.trace.api["launches"] / n if n else None
