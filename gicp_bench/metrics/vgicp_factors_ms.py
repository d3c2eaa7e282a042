"""vgicp_factors_ms: host milliseconds an unfused LM iteration spends in the
program's ``lm.factors`` (the torch factors and their sums) and ``lm.pack``
(the corr rows the step kernel reads) spans over the traced stretch, per
the program's ``lm_unfused_iterations`` counter."""

from gicp_bench.program_spans import ms_per


def read(ctx):
    return ms_per(["lm.factors", "lm.pack"], "lm_unfused_iterations")
