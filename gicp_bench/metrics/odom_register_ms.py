"""odom_register_ms: host milliseconds a frame in the program's
``odom.register`` span (the map's cloud view and ``align_impl`` against it)
over the traced stretch, per the program's ``frames`` counter."""

from gicp_bench.program_spans import ms_per


def read(ctx):
    return ms_per(["odom.register"], "frames")
