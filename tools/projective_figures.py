#!/usr/bin/env python3
"""The projective search's found share and its agreement with the exact
nearest neighbour on ``chip_smoke.py`` phase 11's frame pair, computed on
the CPU by the JAX package's ``ProjectiveSearch`` and by the port's.

    python3 tools/projective_figures.py [--queries 8192] [--seed 0]

Frames 0 and 1 of ``generate_sequence(rings=64, azimuth_steps=1800)``
(≈108k points each, 1.2 m apart); the image is built over frame 0 at the
default geometry (1024 × 64 over 120°, window 21 × 11). A sample of
``--queries`` rows of frame 1, moved into frame 0 by the ground truth, is
searched; the exact nearest neighbour comes from ``scipy``'s cKDTree in
float64. A query agrees when it is found and its row is the exact one or
its d² is within 1e-5 relative of the exact d². Phase 11 holds the card's
figures, over every row of frame 1, to these less a stated margin. JAX runs
on the CPU here; it is not part of the port.
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.spatial import cKDTree  # noqa: E402

from small_gicp_tpu.ops.projective_search import ProjectiveSearch as JProjective  # noqa: E402
from small_gicp_tpu.point_cloud import PointCloud as JCloud  # noqa: E402
from small_gicp_tpu_torch.ops.projective_search import ProjectiveSearch  # noqa: E402
from small_gicp_tpu_torch.point_cloud import PointCloud  # noqa: E402
from small_gicp_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402


def figures(d2, idx, found, d_ref, i_ref):
    """(found share, agreement share) of a search against the exact NN."""
    d2, idx, found = (np.asarray(a) for a in (d2, idx, found))
    agree = found & ((idx == i_ref) | (d2 <= d_ref * (1 + 1e-5) + 1e-9))
    return float(found.mean()), float(agree.mean())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    scans, poses = generate_sequence(n_frames=2, rings=64, azimuth_steps=1800)
    T_gt = np.linalg.inv(poses[0]) @ poses[1]
    tgt = scans[0].astype(np.float32)
    rows = np.random.default_rng(args.seed).choice(len(scans[1]), args.queries, replace=False)
    src = scans[1][rows].astype(np.float64)
    q = (src @ T_gt[:3, :3].T + T_gt[:3, 3]).astype(np.float32)
    dist, i_ref = cKDTree(tgt.astype(np.float64)).query(q.astype(np.float64))
    d_ref = dist ** 2

    jps = JProjective.build(JCloud.from_points(tgt))
    j = figures(*jps.nearest_neighbor_search(jnp.asarray(q)), d_ref, i_ref)
    tps = ProjectiveSearch.build(PointCloud.from_points(tgt, device="cpu"))
    t = figures(*(a.numpy() for a in tps.nearest_neighbor_search(torch.from_numpy(q))),
                d_ref, i_ref)
    print(f"frames of {len(scans[0])} / {len(scans[1])} points, {args.queries} queries; "
          f"JAX (CPU): found {j[0]:.4f}, agreement with the exact NN {j[1]:.4f}; "
          f"port (CPU): found {t[0]:.4f}, agreement {t[1]:.4f}")


if __name__ == "__main__":
    main()
