"""pair_align_ms_p95: the 95th percentile over every registration of the
traced run's window of the host-clock time of one ``align`` call, ended by
the read of its pose."""

import numpy as np


def read(ctx):
    spans = ctx.spans.get("align") or []
    return float(np.percentile(spans, 95)) * 1e3 if spans else None
