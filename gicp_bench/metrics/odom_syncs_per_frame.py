"""odom_syncs_per_frame: host synchronizations with the card (the
profiler's stream, device and event synchronize calls) over the traced
stretch, per odometry frame."""


def read(ctx):
    n = ctx.trace_counts.get("frames") if ctx.trace else None
    return ctx.trace.api["syncs"] / n if n else None
