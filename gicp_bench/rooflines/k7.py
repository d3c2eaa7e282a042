"""K7 — ``csrc/gicp_fleet.cu`` ``gicp_linearize_fleet_kernel``: one round of
the fleet, a GICP linearization for every active lane, each lane's problem
against its pair's clouds at its own pose.

Counted from the inputs alone, whatever the kernel visits, over the
problem-iterations of a stretch (one per active lane per round):

    operations = 8·ΣNₛ + 150·ΣI
    bytes      = 36·Σ (Nₜ + Nₛ) of each batch's distinct pairs

* K1's count for each problem-iteration: 8 FLOP a live source row for its
  nearest target row, 150 FLOP an inlier for its linearization
  (``rooflines/k1.py``);
* each pair's clouds are read at least once by a batch's launches: its
  rows' points and symmetric covariances, 36 bytes a row. Rereads by later
  rounds, lanes' poses and outputs are left out: a lower bound.

The search's pairs, tiles and boxes are not counted, so a better search
cannot read over 100 %.
"""

from gicp_bench import peaks


def least_seconds(work: dict) -> float:
    """``work``: source_rows and inliers summed over the problem-iterations,
    pair_rows_once summed over batches."""
    flops = 8 * work["source_rows"] + 150 * work["inliers"]
    return peaks.least_seconds(flops, 36 * work["pair_rows_once"])
