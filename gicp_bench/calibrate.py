"""Readings for a cell's limits: the numbers compared, from sound runs of
the program on many seeds and from the control (the reference computed in
TF32 in the program's place) on a few, all in one process.

    python3 gicp_bench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 3 [--first-seed N] [--fault F] [--out FILE]

Each seed gets its own set-up and a short window at the cell's own load,
then the comparison the benchmark makes, and prints one JSON line
(``kind`` "program" or "control"); ``--out`` appends the lines to a file.
With ``--fault`` (``gicp_bench/faults.py``) the program runs with that
fault planted under its timed path (``kind`` "fault:<name>", no control).
The benchmark's own runs never run the control or a fault.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gicp_bench import faults  # noqa: E402


def readings(cell, seed: int, seconds: float, control: bool, device,
             kind: str = "program") -> list:
    """[(kind, numbers)] of one seed: the program's and, with ``control``,
    the control's."""
    import torch

    from gicp_bench import workload as wl

    drv = cell.driver.Driver(cell.config, cell.traffic, seed, device)
    t0 = time.perf_counter()
    units = 0
    while time.perf_counter() < t0 + seconds:
        units += drv.step(False)
    wl.sync(device)
    rate = units / (time.perf_counter() - t0)
    drv.window_counts()
    drv.release()
    out = [(kind, dict(drv.check(), rate=rate))]
    if control:
        out.append(("control", drv.check(control=True)))
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=faults.FAULTS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from gicp_bench import core

    cell = core.load_cell(args.workload, ROOT)
    device = torch.device(args.device)
    if args.fault:
        faults.plant(cell.traffic["driver"], args.fault)
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        for kind, numbers in readings(
                cell, seed, args.seconds, not args.fault and i < args.control_seeds,
                device, f"fault:{args.fault}" if args.fault else "program"):
            line = json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                               "seconds": time.perf_counter() - t0, **numbers})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
