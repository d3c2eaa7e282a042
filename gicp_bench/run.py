"""Run one cell of the benchmark once and print its result line.

    python3 gicp_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
It loads and warms up (set-up, ``setup_s``), measures for ``--seconds``,
with ``--trace 1`` profiles a fixed stretch of the same work afterwards,
compares what the timed path produced with the plain reference, and prints
the numbers compared beside their limits on standard error and, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced), then
``checks``. It exits non-zero, printing no result, without the cards, with
the program absent, or with JAX or the JAX package loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every cache the run may fill lives at a fixed place inside the checkout;
# the kernels themselves are built into <checkout>/build/kernels.
CACHE = ROOT / "build" / "gicp_bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
# One host thread for the process's own CPU work: the cells are host-bound,
# and a pool of threads competing for the host's cores only adds jitter.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def fail(msg: str, code: int = 2):
    print(f"gicp_bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "small_gicp_tpu_torch" / "__init__.py").is_file():
        fail(f"the program (small_gicp_tpu_torch) is not in {ROOT}")
    from gicp_bench import core

    cell = core.load_cell(args.workload, ROOT)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} cards, found "
             f"{torch.cuda.device_count()}")
    import small_gicp_tpu_torch

    if not Path(small_gicp_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        fail(f"imported the program from {small_gicp_tpu_torch.__file__}, not {ROOT}")
    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    print(f"correct = {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
