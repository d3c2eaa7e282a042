"""pair_prepare_ms: host milliseconds a registration in the optimizer
loop's set-up, the program's ``align.state`` (the LM record, built on the
host and copied to the card) and ``align.prepare`` (``gicp_prepare`` and
K1's buffers) spans, over the traced stretch, per the program's
``registrations`` counter."""

from gicp_bench.program_spans import ms_per


def read(ctx):
    return ms_per(["align.state", "align.prepare"], "registrations")
