"""vgicp_insert_ms: host milliseconds a frame in the program's
``odom.insert`` span (``GaussianVoxelMap.insert``) over the traced
stretch, per the program's ``frames`` counter."""

from gicp_bench.program_spans import ms_per


def read(ctx):
    return ms_per(["odom.insert"], "frames")
