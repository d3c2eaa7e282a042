"""K3 — ``csrc/cov_fused.cu`` ``knn_moments_kernel``: the moment sums of
each row's k nearest neighbours (Σd and Σddᵀ over the offsets d from the
row, and the neighbour count), the covariances' input.

Counted from the inputs alone, whatever the kernel visits:

    operations = 18·k·N
    bytes      = 52·N

* for each of the N live rows and each of its k neighbours: the offset (3
  subtractions), Σd (3 additions) and the 6 unique entries of Σddᵀ (6
  multiply-adds, 12 FLOP): 18 FLOP;
* each row's point is read once (3 float32, 12 bytes) and its sums are
  written once: Σd 3, Σddᵀ 6 unique, the count 1, as float32 (40 bytes).

The search for the neighbours is not counted: it depends on the
implementation, so a better search cannot read over 100 %.
"""

from gicp_bench import peaks


def least_seconds(work: dict) -> float:
    """``work``: rows (summed over the launches) and k."""
    return peaks.least_seconds(18 * work["k"] * work["rows"], 52 * work["rows"])
