"""Batched refinement of scan pairs through the fleet (``fleet_prepare`` +
``align_fleet``), closed loop, one client: a batch's poses are read back to
the host before the next batch starts.

Traffic parameters: ``pairs`` pairs of consecutive frames, spread evenly
round the loop and the same for every seed (``workload.pair_pool``),
preprocessed in set-up at one capacity (the largest voxel count +
``capacity_margin`` rows, rounded up to ``capacity_round``). A batch takes
``pairs_per_batch`` pairs (the pool's blocks in turn) × ``guesses_per_pair``
initial guesses each, the true relative pose perturbed by sigma
``guess_sigma_rot`` rad / ``guess_sigma_trans`` m, through ``lanes`` lanes;
``fleet_prepare`` of the batch's pairs runs inside the window, as a user
with new pairs pays it. ``guess_batches`` batches of guesses are drawn
from ``guess_seed``, the same for every seed, and taken in turn from one
drawn from the seed: every seed gets the same work in another order, and
moves the sensor noise, the order and the problems compared. In the traced
run's window each batch's preparation is timed apart (a synchronize after
it); ``trace_units`` batches make the traced stretch; ``check_samples``
problems of the window, drawn from the seed, are compared with the
reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gicp_bench import workload as wl
from gicp_bench.reference.precision import F64, TF32

POSE_KEYS = ("rot_gap_deg", "trans_gap_m", "converged_off", "H_gap", "inliers_gap",
             "error_gap")


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import small_gicp_tpu_torch as pt
        from small_gicp_tpu_torch.ops.downsampling import voxelgrid_sampling

        self.pt, self.cfg, self.tr, self.seed, self.dev = pt, config, traffic, seed, device
        npairs = int(traffic["pairs"])
        self.pool = wl.pair_pool(config, npairs, seed, device)
        leaf, k = config["downsampling_resolution"], config["num_neighbors"]
        raws = [self.pool.raw(i) for i in range(2 * npairs)]
        most = max(int(voxelgrid_sampling(r, leaf, device=device).num_points) for r in raws)
        rnd = int(traffic["capacity_round"])
        self.capacity = (most + int(traffic["capacity_margin"]) + rnd - 1) // rnd * rnd
        clouds = [pt.preprocess_points(r, leaf, num_neighbors=k, max_points=self.capacity,
                                       device=device)[0] for r in raws]
        self.clouds = [(c.points, c.num_points, c.covs) for c in clouds]
        U = int(traffic["pairs_per_batch"])
        H = int(traffic["guesses_per_pair"])
        self.halves = []  # (first pair, stacked targets, stacked sources)
        for first in range(0, npairs, U):
            ids = list(range(first, first + U))
            self.halves.append((first, pt.stack_clouds([clouds[2 * i] for i in ids]),
                                pt.stack_clouds([clouds[2 * i + 1] for i in ids])))
        self.problems = U * H
        self.pair_ids = torch.arange(U, dtype=torch.int32,
                                     device=device).repeat_interleave(H)
        B = int(traffic["guess_batches"])
        if B % len(self.halves):
            raise ValueError(f"{B} batches of guesses do not go round {len(self.halves)} "
                             "blocks of pairs evenly")
        g = wl.rng(traffic["guess_seed"], 3)
        inits = []
        for b in range(B):
            first = self.halves[b % len(self.halves)][0]
            T_rel = np.stack([self.pool.relative(2 * (first + u), 2 * (first + u) + 1)
                              for u in range(U)])
            T_rel = np.repeat(T_rel, H, axis=0)
            inits.append(wl.noisy_guesses(T_rel, g, traffic["guess_sigma_rot"],
                                          traffic["guess_sigma_trans"]))
        self.inits = torch.from_numpy(np.stack(inits).astype(np.float32)).to(device)
        self.spans = {"fleet_prepare": [], "fleet_batch": []}
        self.b = 0
        self.results, self.stretch = [], []
        for _ in self.halves:  # every block's shapes once
            self._next(False)
        self.b = int(wl.rng(seed, 1).integers(0, B))

    def _batch(self, b: int, timed: bool):
        first, tgts, srcs = self.halves[b % len(self.halves)]
        t0 = time.perf_counter()
        tables = self.pt.fleet_prepare(tgts, srcs)
        if timed:
            wl.sync(self.dev)
            t1 = time.perf_counter()
        c = self.cfg
        res = self.pt.align_fleet(
            None, None, self.inits[b % len(self.inits)], pair_ids=self.pair_ids,
            num_lanes=int(self.tr["lanes"]), prepared=tables,
            max_iterations=c["max_iterations"],
            max_inner_iterations=c["max_inner_iterations"],
            max_correspondence_distance=c["max_correspondence_distance"],
            rotation_eps=c["rotation_eps"], translation_eps=c["translation_eps"])
        T = res.T_target_source.cpu().numpy()
        if timed:
            self.spans["fleet_prepare"].append(t1 - t0)
            self.spans["fleet_batch"].append(time.perf_counter() - t0)
        return (b, first, res, T)

    def _next(self, timed: bool):
        out = self._batch(self.b, timed)
        self.b += 1
        return out

    def step(self, trace: bool) -> int:
        self.results.append(self._next(timed=trace))
        return self.problems

    def traced_stretch(self):
        for _ in range(int(self.tr["trace_units"])):
            self.stretch.append(self._next(timed=False))

    # --------------------------------------------------------- counters --
    def _read(self, rows):
        out = []
        for b, first, res, T in rows:
            pair = first + self.pair_ids.cpu().numpy()
            out.append(dict(batch=b, pair=pair, T=T, iterations=res.iterations.cpu().numpy(),
                            inliers=res.num_inliers.cpu().numpy(),
                            converged=res.converged.cpu().numpy(), H=res.H.cpu().numpy(),
                            b=res.b.cpu().numpy(), error=res.error.cpu().numpy()))
        return out

    def window_counts(self) -> dict:
        self.answers = self._read(self.results)
        return {"problems": self.problems * len(self.answers),
                "batches": len(self.answers),
                "lm_iterations": int(sum((a["iterations"] + 1).sum() for a in self.answers))}

    def failed(self) -> int:
        return int(sum((~a["converged"]).sum() for a in self.answers))

    def trace_counts(self) -> dict:
        self.stretch_answers = self._read(self.stretch)
        return {"problems": self.problems * len(self.stretch_answers),
                "batches": len(self.stretch_answers),
                "lm_iterations": int(sum((a["iterations"] + 1).sum()
                                         for a in self.stretch_answers))}

    def trace_work(self) -> dict:
        from gicp_bench.reference.preprocess import pack, voxel_coords

        rows = {}
        for i in range(len(self.pool.counts_host)):
            keys = pack(voxel_coords(self.pool.raw(i)[:, :3],
                                     self.cfg["downsampling_resolution"]))
            rows[i] = int(torch.unique(keys).numel())
        k7 = {"problem_iterations": 0, "source_rows": 0, "inliers": 0,
              "pair_rows_once": 0}
        for a in self.stretch_answers:
            n = a["iterations"] + 1
            k7["problem_iterations"] += int(n.sum())
            k7["source_rows"] += int(sum(int(m) * rows[2 * int(p) + 1]
                                         for m, p in zip(n, a["pair"])))
            k7["inliers"] += int((n * a["inliers"]).sum())
            # Each pair's clouds are read at least once by a batch's launches.
            k7["pair_rows_once"] += sum(rows[2 * int(p)] + rows[2 * int(p) + 1]
                                        for p in np.unique(a["pair"]))
        return {"k7": k7}

    # ------------------------------------------------------- comparison --
    def release(self):
        self.results = self.stretch = self.halves = None
        self.clouds = [(p, int(n), c) for p, n, c in self.clouds]
        wl.free_cached(self.dev)

    def check(self, control: bool = False) -> dict:
        """The numbers compared. ``control``: the reference computed in TF32
        stands where the program stood, its clouds and its answers."""
        leaf, k = self.cfg["downsampling_resolution"], self.cfg["num_neighbors"]
        refs = wl.RefClouds(self.pool, leaf, k, F64, self.capacity)
        low = wl.RefClouds(self.pool, leaf, k, TF32, self.capacity) if control else None
        total = self.problems * len(self.answers)
        S = min(int(self.tr["check_samples"]), total)
        pick = sorted(wl.rng(self.seed, 4).choice(total, size=S, replace=False))
        clouds, grids, low_grids = {}, {}, {}

        def cloud(i):
            """Frame i's cloud as the fleet took it (the program's, set-up's)."""
            if i not in clouds:
                clouds[i] = ((low(i)[1].double(), low(i)[2].double()) if control
                             else wl.live(*self.clouds[i]))
                grids[i] = wl.grid_of(clouds[i], self.cfg)
            return clouds[i]

        rows = []
        inits = self.inits.cpu().numpy()
        for q in pick:
            a = self.answers[q // self.problems]
            j = q % self.problems
            p = 2 * int(a["pair"][j])  # the target's frame; the source's is p + 1
            T0 = inits[a["batch"] % len(inits), j]
            tgt, src = cloud(p), cloud(p + 1)
            if control:
                lt, ls = (low(p)[1], low(p)[2]), (low(p + 1)[1], low(p + 1)[2])
                if p not in low_grids:
                    low_grids[p] = wl.grid_of(lt, self.cfg, TF32)
                ans = wl.as_answer(wl.reference_registration(lt, ls, T0, self.cfg, TF32,
                                                             low_grids[p]))
            else:
                ans = {key: a[key][j] for key in ("T", "iterations", "inliers", "converged",
                                                  "H", "b", "error")}
            ref = wl.reference_registration(tgt, src, T0, self.cfg, F64, grids[p])
            rows.append(wl.answer_numbers(ans, tgt, src, self.cfg, grids[p], ref))
        out = wl.registration_numbers(rows, POSE_KEYS)
        used = sorted({2 * int(a["pair"][q % self.problems]) + d for q in pick
                       for a in [self.answers[q // self.problems]] for d in (0, 1)})
        gaps = []
        for i in used:
            if control:
                _, m, c, _ = low(i)
                gaps.append(wl.cloud_gaps(m, m.shape[0], c, refs(i)))
            else:
                gaps.append(wl.cloud_gaps(*self.clouds[i], refs(i)))
        out.update(wl.cloud_numbers(gaps))
        return out
