"""fleet_reg_per_s: problems (a pair and a guess) registered by the fleet, each batch's table preparation included, over the whole measured window (all the window's work
over all its time, host clock)."""


def read(ctx):
    n = ctx.counts.get("problems")
    return None if not n else n / ctx.window_s
