"""idle_share: percent of the traced stretch in which no operation ran on
the card: 1 − (the union of the device events' intervals) / (the stretch's
host-clock length)."""


def read(ctx):
    if not ctx.trace or ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
