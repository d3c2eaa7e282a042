"""One LiDAR stream through the chunked scan-to-model odometry
(``JitOdometry.feed_preloaded``), closed loop: each chunk's poses are read
back to the host before the next chunk starts.

Traffic parameters: set-up makes one closed lap of ``lap_frames`` frames
on the device (the configuration's ``frame_dist`` is the loop's length over
``lap_frames``, so the lap closes on itself), starting at a frame drawn from
the seed, and warms up with the stream's first ``warm_chunks`` chunks. The
window continues the same stream round the lap again and again, so that
the map and its LRU eviction stay in a steady state. ``trace_units``
chunks make the traced stretch. For each entry n of ``check_laps`` one
chunk is compared with the reference, drawn from the seed among the
``check_within`` window chunks that start at or after n laps of the stream
(lap 0: the window's first chunks; lap 1: the first revisit of the lap,
with the map's eviction in its steady state); the odometry's state before
and after each is kept (the map's inserts return new maps, so keeping one
costs no work).

The comparison follows the program from its own state (and checks the
stream's start apart, where the state is known: the first frame at the
identity over an empty map, whose voxels the map must then hold): the reference
preprocesses each frame of a compared chunk from its raw returns, aligns
it from the program's previous pose against the map the program held
before that frame, and checks every row the chunk wrote into the map
against the reference's point and covariance of the frame it came from,
placed by the program's pose. The maps are read through their public
views (``points_flat``, ``covs_flat``, ``valid_points_mask``) and their
rows matched by value, wherever they are stored: the rows a chunk added
are those of the map after it that the map before it did not hold, the
rows it evicted the converse. The map before frame i of the chunk is the
chunk's starting map, the rows its earlier frames added and, up to the
insert that evicted, the rows it evicted: the reference's LRU semantics
(small_gicp's ``IncrementalVoxelMap``: the counter counts inserts, one a
frame, and every ``lru_clear_cycle``-th insert evicts), counted by the
benchmark from the frames it fed, not read from the program.
"""

from __future__ import annotations

import math

import torch

from gicp_bench import workload as wl
from gicp_bench.reference import gicp as ref_gicp
from gicp_bench.reference import preprocess as ref_pre
from gicp_bench.reference.lie import pose_gap
from gicp_bench.reference.precision import F64, TF32

# Rows written by a chunk are matched to the reference's points within this
# radius (m); a row with none nearer counts as this far.
MATCH_CELL = 0.25
# Float rounding may put a point this close to a voxel face (m) in either
# voxel.
FACE_EPS = 1e-5


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from small_gicp_tpu_torch.models.odometry import OdometryParams
        from small_gicp_tpu_torch.models.odometry_scan import JitOdometry

        self.cfg, self.tr, self.seed, self.dev = config, traffic, seed, device
        self.params = OdometryParams(**config["odometry_params"])
        F, C = int(traffic["lap_frames"]), int(config["chunk_frames"])
        lap = 2 * math.pi * config["world"]["radius"] / config["frame_dist"]
        if abs(lap - F) > 1e-6:
            raise ValueError(f"frame_dist makes a lap of {lap} frames, not {F}")
        self.F, self.C = F, C
        pool = wl.ScanPool(config, F, seed, device, pad_rows=self.params.max_scan_points)
        # The lap's first C - 1 frames again after its last: any chunk of the
        # stream is one contiguous view.
        self.frames = torch.cat([pool.frames, pool.frames[:C - 1]])
        self.counts = torch.cat([pool.counts, pool.counts[:C - 1]])
        del pool
        self.odo = JitOdometry(self.params, engine=config["engine"], chunk_frames=C,
                               device=device)
        self.c = 0
        self.sampled, self.snaps = set(), {}
        self.spans = {}
        self.window_chunks = self.stretch_chunks = 0
        empty = self.odo.carry
        self.start_poses = self._chunk()
        self.start_carries = (empty, self.odo.carry)
        for _ in range(int(traffic["warm_chunks"]) - 1):
            self._chunk()
        within = int(traffic["check_within"])
        g = wl.rng(seed, 5)
        # The first chunk that starts at or after n laps of the stream.
        self.sampled = {max(self.c, -(-n * F // C)) + int(g.integers(0, within))
                        for n in traffic["check_laps"]}

    def _chunk(self):
        s = (self.c * self.C) % self.F
        before = self.odo.carry
        poses = self.odo.feed_preloaded(self.frames[s:s + self.C],
                                        self.counts[s:s + self.C], n_real=self.C)
        if self.c in self.sampled:
            self.snaps[self.c] = (before, self.odo.carry, s, poses)
        self.c += 1
        return poses

    def step(self, trace: bool) -> int:
        self._chunk()
        self.window_chunks += 1
        return self.C

    def traced_stretch(self):
        for _ in range(int(self.tr["trace_units"])):
            self._chunk()
            self.stretch_chunks += 1

    def window_counts(self) -> dict:
        return {"frames": self.C * self.window_chunks, "chunks": self.window_chunks}

    def failed(self) -> int:
        return 0

    def trace_counts(self) -> dict:
        return {"frames": self.C * self.stretch_chunks, "chunks": self.stretch_chunks}

    def trace_work(self) -> dict:
        return {}

    def release(self):
        self.odo = None
        wl.free_cached(self.dev)

    # ------------------------------------------------------- comparison --
    def _raw(self, f: int) -> torch.Tensor:
        return self.frames[f, :int(self.counts[f]), :3]

    def check(self, control: bool = False) -> dict:
        """The numbers compared. ``control``: the reference computed in TF32
        stands where the program's poses and inserted rows stood."""
        cfg = self.cfg
        leaf, k = cfg["downsampling_resolution"], self.params.num_neighbors
        cap = self.params.max_downsampled
        lm = wl.lm_settings(cfg)
        out = {"rot_gap_deg": 0.0, "trans_gap_m": 0.0, "map_point_gap_m": 0.0}
        cov_rows = []
        if len(self.snaps) < len(self.sampled):
            raise RuntimeError(f"the window ran {len(self.snaps)} of the "
                               f"{len(self.sampled)} chunks to compare")
        for c in sorted(self.snaps):
            before, after, s, poses = self.snaps[c]
            refs = [ref_pre.preprocess(self._raw(s + i), leaf, k, F64, cap)
                    for i in range(self.C)]
            lows = ([ref_pre.preprocess(self._raw(s + i), leaf, k, TF32, cap)
                     for i in range(self.C)] if control else None)
            P = torch.as_tensor(poses, dtype=torch.float64, device=self.dev)
            kept, new, gone = _split(before[2], after[2])
            rows, cov_gap, frame_of = self._inserted(new, P, refs, None)
            if control:
                rows, cov_gap, _ = self._inserted(new, P, refs, lows)
            out["map_point_gap_m"] = max(out["map_point_gap_m"], rows)
            cov_rows.append(cov_gap)
            targets = self._targets(c, kept, new, gone, frame_of)
            guess = before[0].to(torch.float64)
            for i in range(self.C):
                tp, tc = targets(i)
                _, m, cv, _ = refs[i]
                grid = ref_gicp.Grid(tp, lm["max_dist"], F64)
                ref = ref_gicp.gicp_lm(tp, tc, m, cv, guess, F64, grid=grid, **lm)
                got = P[i]
                if control:
                    _, lm_, lc, _ = lows[i]
                    got = ref_gicp.gicp_lm(tp, tc, lm_, lc, guess, TF32,
                                           grid=ref_gicp.Grid(tp, lm["max_dist"], TF32),
                                           **lm).T
                dr, dt = pose_gap(got, ref.T)
                out["rot_gap_deg"] = max(out["rot_gap_deg"], dr)
                out["trans_gap_m"] = max(out["trans_gap_m"], dt)
                guess = P[i]
        rows = torch.cat(cov_rows)
        out["map_cov_gap_p99"] = (float(torch.quantile(rows.cpu(), wl.COV_QUANTILE))
                                  if rows.numel() else 0.0)
        out.update(self._start(control, leaf, k, cap))
        return out

    def _start(self, control, leaf, k, cap) -> dict:
        """The stream's start, checked apart from the program's state, which
        is known there: the map is empty before the first frame and the
        first frame sits at the identity, so the first frame's insert opens
        every 1 m voxel its points fall in (the map is far from full). The
        share of those voxels that hold none of the first frame's rows after
        the first chunk; a point within ``FACE_EPS`` of a voxel face may
        count in either voxel, as float rounding may place it."""
        vleaf = self.params.voxel_resolution
        refs = [ref_pre.preprocess(self._raw(i), leaf, k, F64, cap) for i in range(self.C)]
        P = torch.as_tensor(self.start_poses, dtype=torch.float64, device=self.dev)
        if control:
            q = TF32.q
            m = ref_pre.preprocess(self._raw(0), leaf, k, TF32, cap)[1]
            held = q(q(m @ q(P[0, :3, :3]).T) + q(P[0, :3, 3])).double()
        else:
            empty, after = self.start_carries
            _, new, _ = _split(empty[2], after[2])
            _, _, frame_of = self._inserted(new, P, refs, None)
            held = new[0][frame_of == 0].double()
        have = torch.unique(ref_pre.pack(torch.floor(held / vleaf).to(torch.int64)))
        want = refs[0][1]
        hit = torch.zeros(want.shape[0], dtype=torch.bool, device=want.device)
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    shift = torch.tensor([sx, sy, sz], dtype=want.dtype,
                                         device=want.device) * FACE_EPS
                    key = ref_pre.pack(torch.floor((want + shift) / vleaf).to(torch.int64))
                    hit |= torch.isin(key, have)
        voxels = ref_pre.pack(torch.floor(want / vleaf).to(torch.int64))
        missed = torch.unique(voxels[~hit]).numel()
        return {"start_missing_share": missed / max(torch.unique(voxels).numel(), 1)}

    def _inserted(self, new, P, refs, lows):
        """The rows ``new`` (points, covariances) a chunk added to the map,
        each matched to the nearest reference point of the chunk's frames
        placed by the program's pose: (largest point gap, scaled covariance
        gaps [n], the frame each row came from [n]). With ``lows`` the rows
        are the TF32 reference's points instead of the program's."""
        pts_ref, cov_ref, cond, frame = [], [], [], []
        for i, (_, m, cv, ev) in enumerate(refs):
            R, t = P[i, :3, :3], P[i, :3, 3]
            pts_ref.append(m @ R.T + t)
            cov_ref.append(R @ cv @ R.T)
            cond.append((ev[:, 1] - ev[:, 0]) / ev[:, 2].clamp(min=1e-30))
            frame.append(torch.full((m.shape[0],), i, device=m.device))
        pts_ref, cov_ref = torch.cat(pts_ref), torch.cat(cov_ref)
        cond, frame = torch.cat(cond), torch.cat(frame)
        if lows is None:
            got_p, got_c = new[0].double(), new[1].double()
        else:
            q = TF32.q
            got_p, got_c = [], []
            for i, (_, m, cv, _) in enumerate(lows):
                R, t = q(P[i, :3, :3]), q(P[i, :3, 3])
                got_p.append(q(q(m @ R.T) + t).double())
                got_c.append(q(R @ cv @ R.T).double())
            got_p, got_c = torch.cat(got_p), torch.cat(got_c)
        if got_p.shape[0] == 0:
            empty = torch.zeros(0, dtype=torch.float64, device=P.device)
            return 0.0, empty, torch.zeros(0, dtype=torch.int64, device=P.device)
        grid = ref_gicp.Grid(pts_ref, MATCH_CELL, F64)
        d2, idx = grid.nearest(got_p)
        found = torch.isfinite(d2)
        gap = float(torch.where(found, d2.sqrt(), MATCH_CELL).max())
        cgap = (got_c - cov_ref[idx]).abs().amax((1, 2)) * cond[idx]
        cgap = torch.where(found, cgap, 1.0)
        return gap, cgap, torch.where(found, frame[idx], -1)

    def _targets(self, c, kept, new, gone, frame_of):
        """frame i → (points [M,3], covs [M,3,3]) of the map the program held
        before frame i of chunk ``c``: the rows the chunk kept, those its
        frames before i added, and those it evicted up to the insert that
        evicted them (the reference's LRU count: chunk c follows c·C
        inserts, and the n-th insert evicts where n is a multiple of
        ``lru_clear_cycle``)."""
        cycle = int(self.params.lru_clear_cycle)
        if self.C > cycle:
            raise ValueError(f"a chunk of {self.C} frames may evict more than once "
                             f"(lru_clear_cycle {cycle})")
        n0 = c * self.C
        evict_at = next((i for i in range(self.C) if (n0 + 1 + i) % cycle == 0), None)

        def rows(i):
            parts = [kept, (new[0][frame_of < i], new[1][frame_of < i])]
            if evict_at is None or i <= evict_at:
                parts.append(gone)
            return (torch.cat([p[0] for p in parts]).double(),
                    torch.cat([p[1] for p in parts]).double())

        return rows


def _live(vm):
    """A map's stored rows through its public views: (points [n,3],
    covariances [n,3,3])."""
    live = vm.valid_points_mask()
    return vm.points_flat()[live, :3], vm.covs_flat()[live]


def _split(map0, map1):
    """(kept, added, evicted): the rows, each (points, covariances), that
    both maps hold, that ``map1`` holds and ``map0`` did not, and that
    ``map0`` held and ``map1`` does not, matched as whole rows by value."""
    (p0, c0), (p1, c1) = _live(map0), _live(map1)
    r0 = torch.cat([p0, c0.reshape(-1, 9)], 1)
    r1 = torch.cat([p1, c1.reshape(-1, 9)], 1)
    _, inv = torch.unique(torch.cat([r0, r1]), dim=0, return_inverse=True)
    n0 = r0.shape[0]
    groups = int(inv.max()) + 1 if inv.numel() else 0
    in0 = torch.bincount(inv[:n0], minlength=groups) > 0
    in1 = torch.bincount(inv[n0:], minlength=groups) > 0
    kept, added = in0[inv[n0:]], ~in0[inv[n0:]]
    evicted = ~in1[inv[:n0]]
    return (p1[kept], c1[kept]), (p1[added], c1[added]), (p0[evicted], c0[evicted])
