#!/usr/bin/env python3
"""Phase 6 (the fleet) of ``chip_smoke.py`` for several checkouts of the
port, in turns on one card, each in its own process on the same generated
frames.

    python3 tools/fleet_ab.py PARENT_TREE . . PARENT_TREE

Each argument is the root of a checkout (unpack the parent with ``git
archive`` into a directory that ``.gitignore`` lists). The lines that
phase 6 prints — K7, K8, fleet registrations/s, busy share — follow a
``tree …`` line per run. Exits non-zero if a run fails.
"""

import os
import subprocess
import sys

RUN = """
import subprocess, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke as cs
from small_gicp_tpu_torch import _build
from small_gicp_tpu_torch.utils.synthetic import generate_sequence
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True,
                      check=True).stdout.strip().splitlines()[0]
scans, poses = generate_sequence(n_frames=3, rings=64, azimuth_steps=1800)
cs.phase_fleet(scans, poses, np.random.default_rng(0), torch.device("cuda"), card, 0.0)
"""


def main() -> None:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    for tree in sys.argv[1:]:
        tree = os.path.abspath(tree)
        print(f"tree {tree}", flush=True)
        subprocess.run([sys.executable, "-c", RUN, tree], cwd=tree, check=True)


if __name__ == "__main__":
    main()
