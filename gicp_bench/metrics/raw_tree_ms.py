"""raw_tree_ms: host milliseconds a registration in ``KdTree.build`` of
``preprocess_points`` (the program's ``pre.tree`` span, both scans), over
the traced stretch, per the program's ``registrations`` counter."""

from gicp_bench.program_spans import ms_per


def read(ctx):
    return ms_per(["pre.tree"], "registrations")
