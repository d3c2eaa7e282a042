"""lm_iters_per_reg: LM iterations a registration runs (the solver's
``iterations`` + 1, the index of its last iteration plus one), averaged over
the traced run's window."""


def read(ctx):
    n = ctx.counts.get("registrations")
    return ctx.counts["lm_iterations"] / n if n else None
