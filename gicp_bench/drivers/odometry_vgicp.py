"""One LiDAR stream through VGICP scan-to-model odometry
(``JitOdometry.feed_preloaded`` with the ``vgicp_model`` engine: a Gaussian
voxel map searched by voxel key), closed loop. The window, the stream, the
traced stretch and the chunks compared are the ``odometry`` driver's, with
the same traffic parameters (this driver extends it); only the comparison
is its own, since a Gaussian map keeps per voxel a mean, a covariance and a
count where the incremental map keeps points.

The comparison follows the program from its own state, chunk by chunk. The
reference's Gaussian map (``reference/vgicp.py``) starts from the map the
program held before the chunk, read through its public views (``means``,
``covs``, ``counts``, ``valid_mask()``; each voxel's key is its mean's),
each voxel's sums its mean and covariance times its count. Its LRU stamps
and insert counter are counted by the benchmark from the frames it fed: the
counter counts inserts, one a frame, and a voxel's stamp is the last insert
among the last ``lru_horizon`` whose points, placed by the program's pose
for that frame, fall in it. Each frame of the chunk is preprocessed by the
reference from its raw returns, aligned by the reference's VGICP from the
program's previous pose against the reference map before that frame, and
inserted at the program's pose. After the chunk the program's map is read
again and held to the reference map: every voxel the chunk touched (its
mean, covariance and count) and the set of live voxels after eviction.

A placed point within ``FACE_EPS`` of a voxel face may fall in either voxel
where the program rounds in float32: the voxels it may reach are left out
of the per-voxel numbers, and so are those whose eviction at the chunk's
clear turns on such a point; the live set counts them neither way. The
stream's start is checked apart: after the first chunk the map holds every
1 m voxel of the first frame, which sits at the identity over an empty map.
"""

from __future__ import annotations

import torch

from gicp_bench import workload as wl
from gicp_bench.drivers import odometry
from gicp_bench.reference import preprocess as ref_pre
from gicp_bench.reference import vgicp as ref_vgicp
from gicp_bench.reference.lie import pose_gap
from gicp_bench.reference.precision import F64, TF32

# The program places a point by four float32 operations on coordinates of
# up to about 160 m (ulp 1.5e-5 m) from a downsampled point rounded once to
# float32: within 5e-5 m of the float64 placement. Twice that is the band
# round a voxel face in which either voxel may take the point.
FACE_EPS = 1e-4
# A stamp older than any insert: the voxel goes at the next clear.
NEVER = -(1 << 40)


def _candidates(points: torch.Tensor, leaf: float):
    """(floor keys [n], on a face [n] bool, every key within FACE_EPS [n,8])
    of placed points [n,3]."""
    shifts = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                           for sz in (-1, 1)], dtype=torch.float64,
                          device=points.device) * FACE_EPS
    p = points.double()
    cand = ref_vgicp.pack(ref_vgicp.coords((p[:, None, :] + shifts[None]).reshape(-1, 3),
                                           leaf)).reshape(-1, 8)
    key = ref_vgicp.pack(ref_vgicp.coords(p, leaf))
    return key, (cand != key[:, None]).any(1), cand


def _last(keys: torch.Tensor, at: torch.Tensor):
    """(unique keys, the largest ``at`` of each)."""
    u, inv = torch.unique(keys, return_inverse=True)
    last = torch.full((u.numel(),), NEVER, dtype=torch.int64, device=keys.device)
    return u, last.scatter_reduce(0, inv, at, reduce="amax")


def _get(keys: torch.Tensor, vals: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``vals`` at the keys ``q`` (sorted ``keys``), NEVER where absent."""
    if keys.numel() == 0:
        return torch.full_like(q, NEVER)
    pos = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    return torch.where(keys[pos] == q, vals[pos], NEVER)


def _views(vm, leaf: float):
    """A program map's live voxels through its public views: (keys [M]
    ascending, means [M,3], covariances [M,3,3], counts [M] int64)."""
    live = vm.valid_mask()
    means = vm.means[live, :3].double()
    keys = ref_vgicp.pack(ref_vgicp.coords(means, leaf))
    order = torch.argsort(keys)
    return (keys[order], means[order], vm.covs[live].double()[order],
            torch.round(vm.counts[live].double()).to(torch.int64)[order])


def placed(raw: torch.Tensor, pose: torch.Tensor, p) -> torch.Tensor:
    """A raw frame's downsampled points (the reference's voxelgrid) placed
    by ``pose`` [4,4], in float64."""
    means = ref_pre.voxelgrid(raw, p.downsampling_resolution, F64, p.max_downsampled)[1]
    return means @ pose[:3, :3].T + pose[:3, 3]


def compare_chunk(before, after, T_before: torch.Tensor, P: torch.Tensor, raws,
                  n0: int, history, p, lm: dict, control: bool = False):
    """One chunk of the program's VGICP odometry against the reference:
    ``before``, ``after`` its Gaussian maps around the chunk, ``T_before``
    its pose before it, ``P`` [C,4,4] its poses of the chunk's frames,
    ``raws`` those frames' raw returns [n,3], ``n0`` the inserts before the
    chunk, ``history`` (m, placed points) of the inserts before it back to
    at least ``n0 - lru_horizon`` (``placed``), ``p`` the odometry
    parameters, ``lm`` the LM settings (``workload.lm_settings``). With
    ``control`` the reference computed in TF32 stands in the program's
    place. Returns ({rot_gap_deg, trans_gap_m, map_mean_gap_m,
    map_count_off, voxels_off}, each touched voxel's scaled covariance gap
    [n])."""
    leaf, k, cap = p.downsampling_resolution, p.num_neighbors, p.max_downsampled
    vleaf, H, cycle = p.voxel_resolution, int(p.lru_horizon), int(p.lru_clear_cycle)
    C = len(raws)
    if C > min(cycle, H):
        raise ValueError(f"a chunk of {C} frames may evict more than once or evict "
                         f"voxels it touched (lru_clear_cycle {cycle}, lru_horizon {H})")
    dev = P.device

    # Touches of the inserts that a clear in the chunk reads: by each
    # point's floor key (the reference's), by the keys of points clear of
    # every face (certain), by every key a point may reach.
    at_ref, at_sure, at_any = [], [], []

    def touch(m, key, face, cand):
        full = torch.full_like(key, m)
        at_ref.append((key, full))
        at_sure.append((key[~face], full[~face]))
        at_any.append((cand.reshape(-1), torch.full_like(cand.reshape(-1), m)))

    def last(pairs):
        if not pairs:
            z = torch.zeros(0, dtype=torch.int64, device=dev)
            return z, z
        return _last(torch.cat([a for a, _ in pairs]), torch.cat([b for _, b in pairs]))

    for m, pts in history:
        touch(m, *_candidates(pts, vleaf))

    bkeys, bmeans, bcovs, bcounts = _views(before, vleaf)
    uk, ul = last(at_ref)
    ref = ref_vgicp.GaussianVoxelMap.from_views(
        vleaf, bmeans, bcovs, bcounts, _get(uk, ul, bkeys), n0, H, cycle)
    dup = bkeys.numel() - ref.keys.numel()  # two voxels at one key
    low = ref.copy() if control else None

    refs = [ref_pre.preprocess(r, leaf, k, F64, cap) for r in raws]
    lows = [ref_pre.preprocess(r, leaf, k, TF32, cap) for r in raws] if control else None
    guess = T_before.to(torch.float64)
    out = {"rot_gap_deg": 0.0, "trans_gap_m": 0.0}
    unsettled, touched, conds = [], [], []
    for i in range(C):
        m = n0 + i
        _, pts, cv, ev = refs[i]
        r = ref_vgicp.vgicp_lm(ref, pts, cv, guess, F64, p.num_offsets, **lm)
        got = P[i]
        if control:
            _, lp, lc, _ = lows[i]
            got = ref_vgicp.vgicp_lm(ref, lp, lc, guess, TF32, p.num_offsets, **lm).T
        dr, dt = pose_gap(got, r.T)
        out["rot_gap_deg"] = max(out["rot_gap_deg"], dr)
        out["trans_gap_m"] = max(out["trans_gap_m"], dt)
        guess = P[i]

        R, t = P[i, :3, :3], P[i, :3, 3]
        pts_w = pts @ R.T + t
        key, face, cand = _candidates(pts_w, vleaf)
        touch(m, key, face, cand)
        unsettled.append(cand[face].reshape(-1))
        touched.append(key)
        conds.append((ev[:, 1] - ev[:, 0]) / ev[:, 2].clamp(min=1e-30))
        if (m + 1) % cycle == 0:
            # The clear after insert m keeps a voxel stamped at or after
            # m + 1 - H; where only a point on a face decides, either way.
            ks, ls = last(at_sure)
            ka, la = last(at_any)
            seen = torch.unique(torch.cat([ref.keys, ka]))
            cut = m + 1 - H
            unsettled.append(seen[(_get(ks, ls, seen) < cut) & (_get(ka, la, seen) >= cut)])
        ref.insert(pts_w, R @ cv @ R.T)
        if control:
            q = TF32.q
            Rq, tq = q(R), q(t)
            low.insert(q(q(lp @ Rq.T) + tq).double(), q(Rq @ lc @ Rq.T).double())

    got = (low.keys, low.means, low.covs, low.count) if control else _views(after, vleaf)
    unsettled = torch.unique(torch.cat(unsettled))
    key_t, inv = torch.unique(torch.cat(touched), return_inverse=True)
    cond_t = torch.full((key_t.numel(),), float("inf"), dtype=torch.float64,
                        device=dev).scatter_reduce(0, inv, torch.cat(conds), reduce="amin")
    keep = ~torch.isin(key_t, unsettled)
    numbers, rows = _map_numbers(ref, got, key_t[keep], cond_t[keep], unsettled)
    numbers["voxels_off"] += dup
    out.update(numbers)
    return out, rows


def _map_numbers(ref, got, key_t, cond_t, unsettled):
    """The map after a chunk, ``got`` (keys ascending, means, covariances,
    counts), against the reference's: over the settled voxels the chunk
    touched (keys ``key_t``, each with the smallest conditioning of the
    chunk's points in it, ``cond_t``), the largest mean gap, the counts off
    and each voxel's scaled covariance gap; and the live voxels off."""
    gkeys, gmeans, gcovs, gcounts = got
    rpos = torch.searchsorted(ref.keys, key_t)  # the chunk evicts no voxel it touched
    if gkeys.numel():
        gpos = torch.searchsorted(gkeys, key_t).clamp(max=gkeys.numel() - 1)
        held = gkeys[gpos] == key_t
    else:
        gpos = torch.zeros_like(key_t)
        held = torch.zeros_like(key_t, dtype=torch.bool)
    rp, gp = rpos[held], gpos[held]
    mean_gap = (gmeans[gp] - ref.means[rp]).norm(dim=1)
    count_off = (gcounts[gp] - ref.count[rp]).abs().sum()
    cov_gap = (gcovs[gp] - ref.covs[rp]).abs().amax((1, 2)) * cond_t[held]
    sure = ref.keys[~torch.isin(ref.keys, unsettled)]
    extra = gkeys[~torch.isin(gkeys, ref.keys) & ~torch.isin(gkeys, unsettled)]
    dup = gkeys.numel() - torch.unique(gkeys).numel()
    off = int((~torch.isin(sure, gkeys)).sum()) + extra.numel() + dup
    return ({"map_mean_gap_m": float(mean_gap.max()) if mean_gap.numel() else 0.0,
             "map_count_off": int(count_off), "voxels_off": off}, cov_gap)


class Driver(odometry.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        # Every chunk's poses, up to the last chunk compared: the stamps and
        # the counter are counted from the frames fed and where they were put.
        self.chunk_poses = {}
        super().__init__(config, traffic, seed, device)

    def _chunk(self):
        c = self.c
        poses = super()._chunk()
        if not self.sampled or c <= max(self.sampled):
            self.chunk_poses[c] = poses
        return poses

    def _poses(self, c: int) -> torch.Tensor:
        """Chunk c's poses [C,4,4] in float64 on the device."""
        return torch.as_tensor(self.chunk_poses[c], dtype=torch.float64, device=self.dev)

    # ------------------------------------------------------- comparison --
    def check(self, control: bool = False) -> dict:
        """The numbers compared. ``control``: the reference computed in TF32
        stands where the program's poses and map stood."""
        if len(self.snaps) < len(self.sampled):
            raise RuntimeError(f"the window ran {len(self.snaps)} of the "
                               f"{len(self.sampled)} chunks to compare")
        p, C = self.params, self.C
        out = {"rot_gap_deg": 0.0, "trans_gap_m": 0.0, "map_mean_gap_m": 0.0,
               "map_count_off": 0, "voxels_off": 0}
        cov_rows = []
        for c in sorted(self.snaps):
            before, after, s, _ = self.snaps[c]
            n0 = c * C
            history = ((m, placed(self._raw(m % self.F), self._poses(m // C)[m % C], p))
                       for m in range(max(0, n0 - int(p.lru_horizon)), n0))
            numbers, rows = compare_chunk(
                before[2], after[2], before[0], self._poses(c),
                [self._raw(s + i) for i in range(C)], n0, history, p,
                wl.lm_settings(self.cfg), control)
            for k, v in numbers.items():
                out[k] = out[k] + v if k in ("map_count_off", "voxels_off") else max(out[k], v)
            cov_rows.append(rows)
        rows = torch.cat(cov_rows)
        out["map_cov_gap_p99"] = (float(torch.quantile(rows.cpu(), wl.COV_QUANTILE))
                                  if rows.numel() else 0.0)
        out.update(self._start(control))
        return out

    def _start(self, control: bool) -> dict:
        """The stream's start, checked apart from the program's state, which
        is known there: the map is empty before the first frame and the
        first frame sits at the identity, so the first frame's insert opens
        every 1 m voxel its points fall in, which the first chunk keeps. The
        share of those voxels missing from the map after the first chunk; a
        point within ``FACE_EPS`` of a voxel face may count in either
        voxel."""
        vleaf = self.params.voxel_resolution
        leaf, cap = self.cfg["downsampling_resolution"], self.params.max_downsampled
        want = ref_pre.voxelgrid(self._raw(0), leaf, F64, cap)[1]
        if control:
            have = torch.unique(ref_vgicp.pack(ref_vgicp.coords(
                ref_pre.voxelgrid(self._raw(0), leaf, TF32, cap)[1].double(), vleaf)))
        else:
            have = _views(self.start_carries[1][2], vleaf)[0]
        _, _, cand = _candidates(want, vleaf)
        key = ref_vgicp.pack(ref_vgicp.coords(want, vleaf))
        hit = torch.isin(cand, have).any(1)
        missed = torch.unique(key[~hit]).numel()
        return {"start_missing_share": missed / max(torch.unique(key).numel(), 1)}
