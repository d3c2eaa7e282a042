"""Scan-pair registration through the one-call ``align``, closed loop, one
client: each registration's pose is read back to the host before the next
starts.

Traffic parameters: ``pairs`` pairs of consecutive frames, spread evenly
round the loop and the same for every seed (``workload.pair_pool``), taken
in turn, each registration from a fresh initial guess, the true relative
pose perturbed by a twist of sigma ``guess_sigma_rot`` rad /
``guess_sigma_trans`` m: ``guesses`` of them drawn from ``guess_seed``, the
same for every seed, and taken in turn from one drawn from the seed. So
every seed gets the same work in another order; the seed moves the sensor
noise, the order and the registrations compared. With ``"raw": false``
set-up preprocesses every frame (``preprocess_points``) and the window
calls ``align(target, source, target_tree, guess)``; with ``"raw": true``
the window calls ``align(raw_target, raw_source, init_T_target_source=
guess)``, which preprocesses both scans itself, and the traced run's
window calls ``preprocess_points`` twice and then ``align`` on the results,
each span ended by a synchronize. ``trace_units`` registrations make the
traced stretch; ``check_samples`` registrations of the window, drawn from
the seed, are compared with the reference.

The comparison registers each sampled pair in the reference from the same
guess over the clouds the program registered (set-up's, or, for the
one-call align, which preprocesses inside the call, the same
``preprocess_points`` call on the same raw scans made again after the
window), and checks those clouds apart against the reference's
preprocessing of the raw scans: over its own clouds the reference lands as
far from the program as the control does (see PERF.md §2).
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

        self.pt, self.cfg, self.tr, self.seed, self.dev = pt, config, traffic, seed, device
        self.raw_mode = bool(traffic["raw"])
        self.npairs = int(traffic["pairs"])
        self.pool = wl.pair_pool(config, self.npairs, seed, device)
        self.raws = [self.pool.raw(i) for i in range(2 * self.npairs)]
        self.clouds, self.remade = None, {}
        if not self.raw_mode:
            self.clouds = [self._preprocess(r) for r in self.raws]
        G = int(traffic["guesses"])
        if G % self.npairs:
            raise ValueError(f"{G} guesses do not go round {self.npairs} pairs evenly")
        pair_of = np.arange(G) % self.npairs
        T_rel = np.stack([self.pool.relative(2 * p, 2 * p + 1) for p in pair_of])
        self.inits = wl.noisy_guesses(T_rel, wl.rng(traffic["guess_seed"], 3),
                                      traffic["guess_sigma_rot"],
                                      traffic["guess_sigma_trans"]).astype(np.float32)
        self.spans = {"align": [], "preprocess": []}
        self.results, self.stretch = [], []
        self._nrows = {}
        for p in range(self.npairs):  # every pair's shapes once
            self._register(p, self.inits[p])
        self.r = int(wl.rng(seed, 1).integers(0, G))

    # ---------------------------------------------------------- program --
    def _preprocess(self, raw):
        return self.pt.preprocess_points(raw, self.cfg["downsampling_resolution"],
                                         num_neighbors=self.cfg["num_neighbors"],
                                         device=self.dev)

    def _align(self, tgt, src, tree, T0):
        c = self.cfg
        return self.pt.align(tgt, src, tree, T0,
                             downsampling_resolution=c["downsampling_resolution"],
                             max_correspondence_distance=c["max_correspondence_distance"],
                             max_iterations=c["max_iterations"],
                             rotation_eps=c["rotation_eps"],
                             translation_eps=c["translation_eps"], device=self.dev)

    def _register(self, p: int, T0):
        if self.raw_mode:
            res = self._align(self.raws[2 * p], self.raws[2 * p + 1], None, T0)
        else:
            (tgt, tree), (src, _) = self.clouds[2 * p], self.clouds[2 * p + 1]
            res = self._align(tgt, src, tree, T0)
        return res, res.T_target_source.cpu().numpy()

    def _next(self, split: bool):
        p, g = self.r % self.npairs, self.r % len(self.inits)
        t0 = time.perf_counter()
        if split:
            tgt, tree = self._preprocess(self.raws[2 * p])
            src, _ = self._preprocess(self.raws[2 * p + 1])
            wl.sync(self.dev)
            t1 = time.perf_counter()
            res = self._align(tgt, src, tree, self.inits[g])
            T = res.T_target_source.cpu().numpy()
            self.spans["preprocess"].append(t1 - t0)
            t0 = t1
        else:
            res, T = self._register(p, self.inits[g])
        self.spans["align"].append(time.perf_counter() - t0)
        self.r += 1
        return (self.r - 1, p, g, res, T)

    def step(self, trace: bool) -> int:
        self.results.append(self._next(split=trace and self.raw_mode))
        return 1

    def traced_stretch(self):
        for _ in range(int(self.tr["trace_units"])):
            self.stretch.append(self._next(split=False))

    # --------------------------------------------------------- counters --
    @staticmethod
    def _read(rows):
        """Every answer's fields on the host (one copy a field)."""
        if not rows:
            return []
        res = [r[3] for r in rows]
        f = {k: torch.stack([getattr(x, k) for x in res]).cpu().numpy()
             for k in ("iterations", "num_inliers", "converged", "H", "b", "error")}
        return [dict(r=r, pair=p, guess=g, T=T, iterations=int(f["iterations"][i]),
                     inliers=int(f["num_inliers"][i]), converged=bool(f["converged"][i]),
                     H=f["H"][i], b=f["b"][i], error=float(f["error"][i]))
                for i, (r, p, g, _, T) in enumerate(rows)]

    def window_counts(self) -> dict:
        self.answers = self._read(self.results)
        return {"registrations": len(self.answers),
                "lm_iterations": sum(a["iterations"] + 1 for a in self.answers)}

    def failed(self) -> int:
        return sum(not a["converged"] for a in self.answers)

    def trace_counts(self) -> dict:
        self.stretch_answers = self._read(self.stretch)
        return {"registrations": len(self.stretch_answers),
                "lm_iterations": sum(a["iterations"] + 1 for a in self.stretch_answers)}

    def _rows(self, i: int) -> int:
        """Live rows of frame i's preprocessed cloud (the voxels of its
        returns: an input's property, counted by the reference's grid)."""
        from gicp_bench.reference.preprocess import pack, voxel_coords

        if i not in self._nrows:
            keys = pack(voxel_coords(self.raws[i][:, :3], self.cfg["downsampling_resolution"]))
            self._nrows[i] = int(torch.unique(keys).numel())
        return self._nrows[i]

    def trace_work(self) -> dict:
        k1 = {"launches": 0, "source_rows": 0, "target_rows": 0, "inliers": 0}
        for a in self.stretch_answers:
            n = a["iterations"] + 1
            k1["launches"] += n
            k1["source_rows"] += n * self._rows(2 * a["pair"] + 1)
            k1["target_rows"] += n * self._rows(2 * a["pair"])
            k1["inliers"] += n * a["inliers"]
        work = {"k1": k1}
        if self.raw_mode:
            rows = [self._rows(2 * a["pair"]) + self._rows(2 * a["pair"] + 1)
                    for a in self.stretch_answers]
            work["k3"] = {"launches": 2 * len(rows), "rows": sum(rows),
                          "k": self.cfg["num_neighbors"]}
        return work

    # ------------------------------------------------------- comparison --
    def release(self):
        """Drop the program's state that the comparison does not read."""
        self.results = self.stretch = None
        if self.clouds is not None:
            self.clouds = [(c.points, int(c.num_points), c.covs) for c, _ in self.clouds]
        wl.free_cached(self.dev)

    def _program_cloud(self, i: int):
        """Frame i's cloud as the program registered it: (points, live rows,
        covariances) of set-up's, or, where the one-call align preprocessed
        it inside the call, of the same call made again."""
        if self.clouds is not None:
            return self.clouds[i]
        if i not in self.remade:
            c, _ = self._preprocess(self.raws[i])
            self.remade[i] = (c.points, int(c.num_points), c.covs)
        return self.remade[i]

    def check(self, control: bool = False) -> dict:
        """The numbers compared. ``control``: the reference computed in TF32
        stands where the program stood, its clouds and its answers."""
        refs = wl.RefClouds(self.pool, self.cfg["downsampling_resolution"],
                            self.cfg["num_neighbors"], F64)
        low = wl.RefClouds(self.pool, self.cfg["downsampling_resolution"],
                           self.cfg["num_neighbors"], TF32) if control else None
        S = min(int(self.tr["check_samples"]), len(self.answers))
        pick = sorted(wl.rng(self.seed, 4).choice(len(self.answers), size=S, replace=False))
        clouds, grids, low_grids = {}, {}, {}

        def cloud(i):
            """Frame i's cloud as the registration took it."""
            if i not in clouds:
                clouds[i] = ((low(i)[1].double(), low(i)[2].double()) if control
                             else wl.live(*self._program_cloud(i)))
                grids[i] = wl.grid_of(clouds[i], self.cfg)
            return clouds[i]

        rows = []
        for i in pick:
            a = self.answers[i]
            t, src, T0 = 2 * a["pair"], 2 * a["pair"] + 1, self.inits[a["guess"]]
            tgt, srcc = cloud(t), cloud(src)
            if control:
                lt, ls = (low(t)[1], low(t)[2]), (low(src)[1], low(src)[2])
                if t not in low_grids:
                    low_grids[t] = wl.grid_of(lt, self.cfg, TF32)
                a = wl.as_answer(wl.reference_registration(lt, ls, T0, self.cfg, TF32,
                                                           low_grids[t]))
            ref = wl.reference_registration(tgt, srcc, T0, self.cfg, F64, grids[t])
            rows.append(wl.answer_numbers(a, tgt, srcc, self.cfg, grids[t], ref))
        out = wl.registration_numbers(rows, POSE_KEYS)
        # Set-up's clouds are all checked; the one-call align's, those of the
        # compared registrations.
        frames = (range(len(self.raws)) if not self.raw_mode else
                  sorted({2 * self.answers[i]["pair"] + d for i in pick for d in (0, 1)}))
        gaps = []
        for i in frames:
            if control:
                _, m, c, _ = low(i)
                gaps.append(wl.cloud_gaps(m, m.shape[0], c, refs(i)))
            else:
                gaps.append(wl.cloud_gaps(*self._program_cloud(i), refs(i)))
        out.update(wl.cloud_numbers(gaps))
        return out
