"""raw_covs_ms: host milliseconds a registration in the covariances of
``preprocess_points`` (the program's ``pre.covs`` span: K3 and the
eigen-solves, both scans), over the traced stretch, per the program's
``registrations`` counter."""

from gicp_bench.program_spans import ms_per


def read(ctx):
    return ms_per(["pre.covs"], "registrations")
