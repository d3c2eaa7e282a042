"""odom_preprocess_ms: host milliseconds a frame in the program's
``odom.preprocess`` span (the frame's voxelgrid and covariances in
``odometry_scan_step``) over the traced stretch, per the program's
``frames`` counter."""

from gicp_bench.program_spans import ms_per


def read(ctx):
    return ms_per(["odom.preprocess"], "frames")
