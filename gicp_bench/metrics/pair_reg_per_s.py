"""pair_reg_per_s: registrations of preprocessed scan pairs completed, each pose read back to the host, over the whole measured window (all the window's work
over all its time, host clock)."""


def read(ctx):
    n = ctx.counts.get("registrations")
    return None if not n else n / ctx.window_s
