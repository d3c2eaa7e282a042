"""odom_unnamed_syncs_per_frame: host synchronizations with the card that
no named host read of the program accounts for, per the program's
``frames`` counter: the profiler's stream, device and event synchronize
calls over the traced stretch, less the program's ``host_reads`` counter
and the stretch's two closing synchronizes, which are not the program's
(the benchmark's own that ends the stretch, ``core.run_cell``, and the
profiler's at its exit); 0 where the reads outnumber them, as on the CPU,
which makes no such call."""

from gicp_bench.program_spans import record

CLOSING_SYNCS = 2


def read(ctx):
    rec = record()
    if rec is None or not ctx.trace:
        return None
    frames = rec["counters"].get("frames")
    if not frames:
        return None
    named = rec["counters"].get("host_reads", 0) + CLOSING_SYNCS
    return max(ctx.trace.api["syncs"] - named, 0) / frames
