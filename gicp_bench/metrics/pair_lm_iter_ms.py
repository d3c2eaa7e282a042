"""pair_lm_iter_ms: host milliseconds an LM iteration spends launching its
work, the program's ``lm.iter`` span less the stop-flag read inside it
(``read.stop``), over the traced stretch, per the program's
``lm_iterations`` counter."""

from gicp_bench.program_spans import ms_per


def read(ctx):
    return ms_per(["lm.iter"], "lm_iterations", less=["read.stop"])
