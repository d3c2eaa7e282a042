"""raw_reg_per_s: one-call registrations of raw scans, both clouds preprocessed in the call, each pose read back to the host, over the whole measured window (all the window's work
over all its time, host clock)."""


def read(ctx):
    n = ctx.counts.get("registrations")
    return None if not n else n / ctx.window_s
