"""k3_roofline: percent of its roofline that K3 (csrc/cov_fused.cu) reaches over the
traced stretch: the least time of its launches' work counted from their
inputs (``rooflines/k3.py``) over the device time of the kernels whose
name matches KERNELS in the profiler's trace."""

from gicp_bench import core

KERNELS = r"knn_moments_kernel[<(]"


def read(ctx):
    work = ctx.trace_work.get("k3") if ctx.trace else None
    if not work:
        return None
    launches, seconds = ctx.trace.kernel(KERNELS)
    if not launches or seconds <= 0:
        return None
    work = dict(work, launches=launches)
    return 100.0 * core.roofline("k3").least_seconds(work) / seconds
