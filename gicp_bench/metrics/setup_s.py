"""setup_s: seconds from the process's start to the first timed call —
the torch import and the CUDA context, the inputs made on the card from the
seed, the preprocessing set-up does, and the warm-up of the cell's shapes
(and, in the first run of a checkout, the kernels' build)."""


def read(ctx):
    return ctx.setup_s
