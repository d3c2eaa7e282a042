"""k7_roofline: percent of its roofline that K7 (csrc/gicp_fleet.cu) reaches over the
traced stretch: the least time of its launches' work counted from their
inputs (``rooflines/k7.py``) over the device time of the kernels whose
name matches KERNELS in the profiler's trace."""

from gicp_bench import core

KERNELS = r"gicp_linearize_fleet_kernel"


def read(ctx):
    work = ctx.trace_work.get("k7") if ctx.trace else None
    if not work:
        return None
    launches, seconds = ctx.trace.kernel(KERNELS)
    if not launches or seconds <= 0:
        return None
    work = dict(work, launches=launches)
    return 100.0 * core.roofline("k7").least_seconds(work) / seconds
