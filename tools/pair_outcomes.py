#!/usr/bin/env python3
"""Every registration's outcome in a pair cell of the benchmark, for a fixed
number of registrations: to hold two versions of the program to the same
answers, guess by guess.

    python3 tools/pair_outcomes.py --workload pair_hdl64_raw --seed 7 --count 4096 \\
        --out chiprun_out/outcomes_raw_7.npz

from the root of a checkout on a machine with a card. The cell's driver
(``gicp_bench/drivers/pair.py``) is set up from the seed as the benchmark
sets it up, then takes ``--count`` registrations in its order, untimed,
with the program's recorder on (``profiling.tracing()``). Written to
``--out``: each registration's guess, pair, convergence, iterations and
pose, a SHA-256 of each of the cell's 64 preprocessed clouds (points,
normals and covariances as the program made them) and the recorder's
counters. A summary (failures, the ``covs.*`` counters a registration)
goes to standard output as one JSON line. ``--compare A.npz B.npz``
prints where two such files differ.
"""

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _digest(cloud) -> str:
    h = hashlib.sha256()
    for t in (cloud.points, cloud.normals, cloud.covs):
        if t is not None:
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def run(workload: str, seed: int, count: int, out: Path) -> dict:
    import torch

    from gicp_bench import core
    from small_gicp_tpu_torch.utils import profiling

    cell = core.load_cell(workload, ROOT)
    dev = torch.device("cuda", 0)
    drv = cell.driver.Driver(cell.config, cell.traffic, seed, dev)
    if drv.clouds is not None:
        digests = [_digest(c) for c, _ in drv.clouds]
    else:
        digests = [_digest(drv._preprocess(r)[0]) for r in drv.raws]
    profiling.reset()
    with profiling.tracing():
        for _ in range(count):
            drv.step(False)
        torch.cuda.synchronize()
    counters = profiling.collected()["counters"]
    profiling.reset()
    drv.window_counts()
    a = drv.answers
    np.savez(out, guess=np.array([x["guess"] for x in a]),
             pair=np.array([x["pair"] for x in a]),
             converged=np.array([x["converged"] for x in a]),
             iterations=np.array([x["iterations"] for x in a]),
             T=np.stack([x["T"] for x in a]), digests=np.array(digests),
             counters=json.dumps(counters))
    return {"workload": workload, "seed": seed, "registrations": len(a),
            "failed": int(sum(not x["converged"] for x in a)),
            "covs_per_registration": {k: v / len(a) for k, v in counters.items()
                                      if k.startswith("covs.")},
            "device": torch.cuda.get_device_name(0)}


def compare(a: Path, b: Path) -> dict:
    x, y = np.load(a), np.load(b)
    n = min(len(x["guess"]), len(y["guess"]))
    same_order = bool(np.array_equal(x["guess"][:n], y["guess"][:n]))
    return {"a": str(a), "b": str(b), "registrations": n, "same_guesses": same_order,
            "clouds_apart": int(sum(p != q for p, q in zip(x["digests"], y["digests"]))),
            "converged_apart": int((x["converged"][:n] != y["converged"][:n]).sum()),
            "iterations_apart": int((x["iterations"][:n] != y["iterations"][:n]).sum()),
            "poses_apart": int((x["T"][:n] != y["T"][:n]).any(axis=(1, 2)).sum()),
            "failed": [int((~x["converged"][:n]).sum()), int((~y["converged"][:n]).sum())]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--count", type=int, default=4096)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", nargs=2, type=Path)
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare)))
        return 0
    args.out.parent.mkdir(parents=True, exist_ok=True)
    print(json.dumps(run(args.workload, args.seed, args.count, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
