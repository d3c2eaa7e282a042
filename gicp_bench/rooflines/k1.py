"""K1 — ``csrc/gicp_listed.cu`` ``gicp_linearize_listed_kernel``: one GICP
linearization, the nearest target row of each transformed source row and
H, b, e summed over the inliers, at one pose.

Counted from the inputs alone, whatever the kernel visits:

    operations = 8·Nₛ + 150·I
    bytes      = 36·(Nₜ + Nₛ) + 288 per launch

* each of the Nₛ live source rows needs at least one squared distance to
  its nearest target row: 3 subtractions and 3 multiply-adds, 8 FLOP (a
  multiply-add counts 2);
* each of the I inliers needs at least 150 FLOP: the point transformed
  (R·p + t, 18), the combined covariance Cₜ + R·Cₛ·Rᵀ (the product R·Cₛ alone
  is 54), its symmetric inverse (≥ 30), the residual (3), the error rᵀWr
  (≥ 15), and the 27 unique entries of H and b (≥ 30);
* each target and source row is read once: its point (3 float32) and the 6
  unique float32 of its symmetric covariance, 36 bytes; the pose (16
  float32) is read once and H's 21 unique entries, b's 6 and e are written
  once as float64: 64 + 224 bytes a launch.

The search's pairs, tiles and boxes are not counted, so a better search
cannot read over 100 %. Over a stretch of launches the totals give
max(Σoperations / peak, Σbytes / bandwidth), which is at most the sum of
each launch's least time.
"""

from gicp_bench import peaks


def least_seconds(work: dict) -> float:
    """``work``: totals over the launches — launches, source_rows,
    target_rows, inliers (each summed launch by launch)."""
    flops = 8 * work["source_rows"] + 150 * work["inliers"]
    nbytes = 36 * (work["target_rows"] + work["source_rows"]) + 288 * work["launches"]
    return peaks.least_seconds(flops, nbytes)
