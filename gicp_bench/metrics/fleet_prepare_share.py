"""fleet_prepare_share: percent of a fleet batch's host-clock time spent in
``fleet_prepare`` (ended by a synchronize), over every batch of the traced
run's window."""


def read(ctx):
    prep, whole = ctx.spans.get("fleet_prepare") or [], ctx.spans.get("fleet_batch") or []
    return 100.0 * sum(prep) / sum(whole) if whole else None
