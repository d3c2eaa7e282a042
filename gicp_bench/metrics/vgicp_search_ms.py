"""vgicp_search_ms: host milliseconds an unfused LM iteration spends in the
program's ``lm.search`` span (the transform, the voxel-directory search,
the gather of the winners' rows and the weights) over the traced stretch,
per the program's ``lm_unfused_iterations`` counter."""

from gicp_bench.program_spans import ms_per


def read(ctx):
    return ms_per(["lm.search"], "lm_unfused_iterations")
