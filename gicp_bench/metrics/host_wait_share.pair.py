"""host_wait_share: percent of the traced stretch's host-clock length that
the program spent waiting for the card, in its named host reads (the
``read.*`` spans: stop flags, chunk syncs, pose and count copies)."""

from gicp_bench.program_spans import wait_share


def read(ctx):
    return wait_share(ctx)
