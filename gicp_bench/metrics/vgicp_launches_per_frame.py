"""vgicp_launches_per_frame: kernel launches the host issues (the profiler's
CUDA runtime launch calls) over the traced stretch, per VGICP odometry
frame."""


def read(ctx):
    n = ctx.trace_counts.get("frames") if ctx.trace else None
    return ctx.trace.api["launches"] / n if n else None
