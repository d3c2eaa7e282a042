"""The benchmark's cells, and its spare ones, cut to a size the CPU runs
in seconds: 16 × 256 rays a frame, a few frames and problems, small
odometry capacities. Only the tests use these; the cells' limits are the
real ones."""

import torch

from gicp_bench import core

CPU = torch.device("cpu")
CELLS = ("odom_hdl64_stream", "pair_hdl64_prepared", "fleet_hdl64_refine",
         "pair_hdl64_raw")


def bench() -> dict:
    """BENCHMARK.json with the spare cells' entries (``spare_cells.json``)
    added, so that the tests run those cells too."""
    b = core.load_json(core.ROOT / "BENCHMARK.json")
    spare = core.load_json(core.BENCH_DIR / "spare_cells.json")
    for key in ("workloads", "end_to_end", "per_layer"):
        b[key] = b[key] + spare[key]
    return b


def cell(name: str) -> core.Cell:
    c = core.load_cell(name, core.ROOT, bench())
    c.config["scanner"].update(rings=16, azimuth_steps=256)
    if "odometry_params" in c.config:
        c.config["odometry_params"].update(max_scan_points=4096, max_downsampled=4096,
                                           map_capacity=8192)
        c.config["chunk_frames"] = 2
        c.traffic.update(warm_chunks=1, trace_units=1, check_laps=[0],
                         check_within=1)
    else:
        c.traffic.update(pairs=4, guesses=16, trace_units=1, check_samples=8,
                         pairs_per_batch=2, guesses_per_pair=4, lanes=4, guess_batches=2)
    return c


def run(name: str, seed: int = 2**31 + 11, trace: bool = False) -> dict:
    """One run of the tiny cell on the CPU: one unit of work in the window."""
    torch.set_num_threads(4)
    return core.run_cell(cell(name), seed, 1e-3, trace, CPU, 0.0)
