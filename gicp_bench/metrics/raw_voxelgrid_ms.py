"""raw_voxelgrid_ms: host milliseconds a registration in the voxelgrid of
``preprocess_points`` (the program's ``pre.voxelgrid`` span, both scans),
over the traced stretch, per the program's ``registrations`` counter."""

from gicp_bench.program_spans import ms_per


def read(ctx):
    return ms_per(["pre.voxelgrid"], "registrations")
