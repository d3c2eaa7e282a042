"""preprocess_ms_per_pair: host-clock milliseconds of ``preprocess_points``
of a scan pair (both scans, ended by a synchronize), averaged over every
registration of the traced run's window, which splits the one-call align
into its two layers."""


def read(ctx):
    spans = ctx.spans.get("preprocess") or []
    return sum(spans) / len(spans) * 1e3 if spans else None
