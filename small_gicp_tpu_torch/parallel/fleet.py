"""Persistent-lane fleet registration: a queue of P problems streamed
through B resident lanes.

Counterpart of ``small_gicp_tpu/parallel/fleet.py`` (single device):

  * P registration problems = (pair id, initial pose) form a queue;
  * B lanes each run ONE LM iteration per round: one fused linearize over
    all lanes (kernel K7 on the card: each block of 64 Morton-sorted source
    rows scans only the target tiles within the rejector radius) and one
    trial-error pass over all lanes (K8), each a single launch;
  * a lane whose problem converged, failed or hit max_iterations retires
    its result into the problem's output slot and loads the next problem
    in the same round, in lane order;
  * lanes read their pair's prepared tables in place through a lane → pair
    id, so a problem switch moves no table bytes.

Iteration semantics per problem are those of ``align_impl``'s LM path
(``models/registration.py``): correspondences re-searched at every
iteration, K λ-trials λ·f^j with frozen correspondences, accept the first
trial that does not increase the error (λ ← λ_j/f), otherwise λ ← λ·f^K
and the problem stops as failed; convergence on the accepted δ. Inactive
lanes are exact no-ops. All loop state stays on the device as [B] and [P]
tensors; the host reads one flag per round.

``align_fleet_sharded`` splits the queue over a mesh (``parallel/
multihost.py``): each rank runs an independent fleet over its contiguous
block of problems against the replicated tables, and one gather returns
the [P] results.

Restrictions (the fused kernels' contract): LM optimizer, float32 clouds,
no DoF mask, at most 65,536 target rows per pair. All three factors
(``registration_type`` "gicp", "plane_icp", "icp") and the Huber/Cauchy
robust kernels run inside the kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from small_gicp_tpu_torch.point_cloud import PointCloud, stack_clouds
from small_gicp_tpu_torch.models.registration import RegistrationResult
from small_gicp_tpu_torch.ops.eigh3 import solve6x6
from small_gicp_tpu_torch.parallel.multihost import all_gather_fields, block, mesh_group
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    GicpTables,
    gicp_error_multi_fleet,
    gicp_fleet_prepare,
    gicp_linearize_fleet,
)
from small_gicp_tpu_torch.utils.lie import se3_exp


def fleet_prepare(targets: PointCloud, sources: PointCloud, block_q: int = 512,
                  registration_type: str = "gicp") -> GicpTables:
    """Prepare the kernel tables of U stacked pairs once: K1's tables and
    each pair's Morton-sorted target rows, their boxes and the source's
    Morton order. ``block_q`` (the TPU kernels' query block) sits in the
    JAX package's position and is ignored: the CUDA kernels fix their own.

    targets/sources are one pair (2-D points) or [U]-stacked clouds
    (``stack_clouds``). registration_type selects the factor: "gicp"
    (both clouds need covariances), "plane_icp" (targets need normals),
    "icp".
    """
    if targets.points.dim() == 2:
        targets = stack_clouds([targets])
    if sources.points.dim() == 2:
        sources = stack_clouds([sources])
    return gicp_fleet_prepare(
        targets.points, targets.num_points, sources.points, sources.num_points,
        factor=registration_type, target_covs=targets.covs,
        source_covs=sources.covs, target_normals=targets.normals)


def align_fleet(targets: Optional[PointCloud], sources: Optional[PointCloud],
                init_Ts, pair_ids=None, num_lanes: int = 32,
                max_iterations: int = 20, max_inner_iterations: int = 10,
                max_correspondence_distance: float = 1.0,
                rotation_eps: float = 0.1 * math.pi / 180.0,
                translation_eps: float = 1e-3, init_lambda: float = 1e-3,
                lambda_factor: float = 10.0, block_q: int = 512,
                prepared: Optional[GicpTables] = None, interpret: Optional[bool] = None,
                robust_kernel: Optional[str] = None, robust_c: float = 1.0,
                registration_type: str = "gicp") -> RegistrationResult:
    """Register P problems through B persistent lanes.

    Args:
      targets/sources: one pair or [U]-stacked pairs of one capacity, on
        the device the fleet runs on (ignored when ``prepared`` is given).
      init_Ts: [P,4,4] initial guesses, one problem per row.
      pair_ids: [P] the pair each problem registers (default: all 0 for a
        single pair, else arange(U), which requires P == U).
      num_lanes: resident lanes B (the round's parallel width).
      prepared: the tables of ``fleet_prepare(targets, sources, ...)``, to
        reuse across calls; they also fix the factor.
      block_q, interpret: the JAX package's Pallas options, accepted in its
        positions and ignored.

    Returns a RegistrationResult with a leading [P] axis; each row solves
    what ``align_impl(target, source, None, init_T)`` solves for that
    problem.
    """
    tables = prepared if prepared is not None else fleet_prepare(
        targets, sources, registration_type=registration_type)
    dev = tables.qtab.device
    f32 = torch.float32
    init_Ts = torch.as_tensor(init_Ts).to(device=dev, dtype=f32)
    if init_Ts.dim() == 2:
        init_Ts = init_Ts[None]
    P, U = init_Ts.shape[0], tables.ttab.shape[0]
    if P == 0:
        raise ValueError("align_fleet needs at least one problem")
    if pair_ids is None:
        if U == 1:
            pair_ids = torch.zeros(P, dtype=torch.int32)
        elif P == U:
            pair_ids = torch.arange(P, dtype=torch.int32)
        else:
            raise ValueError(f"pair_ids required when P={P} problems != U={U} pairs")
    pair_ids = torch.as_tensor(pair_ids).to(device=dev, dtype=torch.int32)
    if tuple(pair_ids.shape) != (P,):
        raise ValueError(f"pair_ids must be [P]={P}, got {tuple(pair_ids.shape)}")

    B, K = int(num_lanes), int(max_inner_iterations)
    md2 = max_correspondence_distance ** 2
    lane = torch.arange(B, device=dev)
    pid = torch.where(lane < P, lane, -1).to(torch.int32)
    first = pid.clamp(min=0).long()
    uid = pair_ids[first]
    T = init_Ts[first]
    lam = torch.full((B,), init_lambda, dtype=f32, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    nxt = torch.tensor(min(B, P), dtype=torch.int32, device=dev)
    powers = torch.arange(K, dtype=f32, device=dev)

    # Output slots; row P takes the writes of lanes that do not retire.
    out_T = torch.eye(4, dtype=f32, device=dev).repeat(P + 1, 1, 1)
    out_conv = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    out_iters = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    out_inliers = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    out_H = torch.zeros((P + 1, 6, 6), dtype=f32, device=dev)
    out_b = torch.zeros((P + 1, 6), dtype=f32, device=dev)
    out_err = torch.zeros(P + 1, dtype=torch.float64, device=dev)

    while bool((pid >= 0).any()):  # the one host read of the round
        active = pid >= 0
        H, b, inliers, corr = gicp_linearize_fleet(
            tables, uid, T, md2, active, robust_kernel, robust_c)
        H, b = H.to(f32), b.to(f32)

        # The K λ-trials of every lane, as align_impl's LM body.
        lambdas = lam[:, None] * lambda_factor ** powers  # [B,K]
        deltas = solve6x6(H[:, None], -b[:, None], lambdas)  # [B,K,6]
        Ts = T[:, None] @ se3_exp(deltas)  # [B,K,4,4]
        errs_all = gicp_error_multi_fleet(
            corr, tables, uid, torch.cat([T[:, None], Ts], dim=1), robust_kernel,
            robust_c)  # [B,K+1]
        e0, errs = errs_all[:, 0], errs_all[:, 1:]
        ok = errs <= e0[:, None]
        accepted = ok.any(dim=1)
        j = torch.argmax(ok.to(torch.int32), dim=1)  # first accepted trial
        T_f = torch.where(accepted[:, None, None], Ts[lane, j], T)
        e_f = torch.where(accepted, errs[lane, j], e0)
        delta = torch.where(accepted[:, None], deltas[lane, j], 0.0)
        lam_f = torch.where(accepted, lambdas[lane, j] / lambda_factor,
                            lam * lambda_factor ** K)
        conv = accepted & (
            (torch.linalg.vector_norm(delta[:, :3], dim=1) <= rotation_eps)
            & (torch.linalg.vector_norm(delta[:, 3:], dim=1) <= translation_eps))

        i_next = it + 1  # result.iterations = index of the last executed iteration
        continuing = active & ~conv & accepted & (i_next < max_iterations)
        done = active & ~continuing

        # Retire finished lanes into their problem's slot.
        slot = torch.where(done, pid, P).long()
        out_T[slot] = T_f
        out_conv[slot] = conv
        out_iters[slot] = it
        out_inliers[slot] = inliers.to(torch.int32)
        out_H[slot] = H
        out_b[slot] = b
        out_err[slot] = e_f

        # Refill retired lanes from the queue, in lane order.
        cand = nxt + torch.cumsum(done.to(torch.int32), 0, dtype=torch.int32) - 1
        refill = done & (cand < P)
        safe = cand.clamp(min=0, max=P - 1).long()
        pid_new = torch.where(refill, cand, torch.where(done, -1, pid))
        uid_new = torch.where(refill, pair_ids[safe], uid)
        T_new = torch.where(refill[:, None, None], init_Ts[safe], T_f)
        lam_new = torch.where(refill, init_lambda, lam_f)
        i_new = torch.where(refill, 0, i_next)

        # Inactive lanes keep their state exactly.
        pid = torch.where(active, pid_new, pid)
        uid = torch.where(active, uid_new, uid)
        T = torch.where(active[:, None, None], T_new, T)
        lam = torch.where(active, lam_new, lam)
        it = torch.where(active, i_new, it)
        nxt = nxt + done.sum(dtype=torch.int32)

    return RegistrationResult(
        T_target_source=out_T[:P], converged=out_conv[:P], iterations=out_iters[:P],
        num_inliers=out_inliers[:P], H=out_H[:P], b=out_b[:P], error=out_err[:P])


def align_fleet_sharded(targets: Optional[PointCloud], sources: Optional[PointCloud],
                        init_Ts, mesh, pair_ids=None, axis_name: str = "data",
                        num_lanes_per_device: int = 32,
                        prepared: Optional[GicpTables] = None,
                        interpret: Optional[bool] = None, **kwargs) -> RegistrationResult:
    """Fleet registration with the problem queue split over a mesh.

    The [P] problems split into contiguous blocks, one a rank (P a multiple
    of the mesh size); each rank runs an independent ``align_fleet`` of
    ``num_lanes_per_device`` lanes over its block against the replicated
    tables (``prepared``, or ``fleet_prepare`` of the pairs on every rank),
    with no collective in its rounds, and one gather returns the [P] results
    in problem order to every rank. A problem's iterates do not depend on
    the scheduling, so each row equals ``align_fleet``'s. ``pair_ids``
    defaults as in ``align_fleet``; ``axis_name`` and ``interpret`` sit in the
    JAX package's positions (the mesh is 1-D, and there is no interpreter).
    ``kwargs`` go to ``align_fleet`` (max_iterations, eps, registration_type,
    ...).
    """
    del axis_name, interpret
    group, rank, size = mesh_group(mesh)
    tables = prepared if prepared is not None else fleet_prepare(
        targets, sources, block_q=kwargs.get("block_q", 512),
        registration_type=kwargs.get("registration_type", "gicp"))
    init_Ts = torch.as_tensor(init_Ts, dtype=torch.float32)
    if init_Ts.dim() == 2:
        init_Ts = init_Ts[None]
    P, U = init_Ts.shape[0], tables.ttab.shape[0]
    if P % size:
        raise ValueError(f"P={P} problems must divide evenly over {size} devices")
    if pair_ids is None:
        if U == 1:
            pair_ids = torch.zeros(P, dtype=torch.int32)
        elif P == U:
            pair_ids = torch.arange(P, dtype=torch.int32)
        else:
            raise ValueError(f"pair_ids required when P={P} problems != U={U} pairs")
    pair_ids = torch.as_tensor(pair_ids, dtype=torch.int32)
    mine = block(P, rank, size)
    res = align_fleet(None, None, init_Ts[mine], pair_ids=pair_ids[mine],
                      num_lanes=num_lanes_per_device, prepared=tables, **kwargs)
    return all_gather_fields(res, group, size)
