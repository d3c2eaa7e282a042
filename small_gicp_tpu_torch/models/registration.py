"""Registration engine: GN / LM optimization over the fused kernels.

Counterpart of ``small_gicp_tpu/models/registration.py`` for point-cloud
targets. Semantics kept from the reference:
  * outer loop ≤ max_iterations; correspondences are re-searched at each
    linearization against the transformed source and rejected beyond
    max_dist_sq;
  * LM evaluates K = max_inner_iterations λ-trials (trial j uses λ·f^j)
    with frozen correspondences in one batched call together with the
    current pose, and accepts the first trial that does not increase the
    error; on accept λ ← λ_j / f, if every trial is rejected λ ← λ·f^K
    and the optimizer stops;
  * convergence: ‖δ_rot‖ ≤ rotation_eps and ‖δ_trans‖ ≤ translation_eps;
    GN applies the update on the converging iteration too;
  * result.iterations is the index of the last executed iteration.

Two routes, chosen as the JAX package chooses them (``use_fused``):
  * fused ("auto", for a PointCloud target, a KdTree or no searcher and
    float32 clouds): the tables are prepared once before the loop
    (``gicp_prepare``), every linearization goes through
    ``gicp_linearize_tables`` — kernel K1 on the card, or for targets above
    1,572,864 rows the swept kernel K6, both walking the Morton-sorted,
    boxed target (``fused_route`` forces either; a ``KdTree`` built over
    the target keeps that sort and those boxes from the covariance stage
    and from one align to the next, without it they are made anew) — and
    every error evaluation
    through ``gicp_error_multi`` (K2); on CPU tensors those run their
    plain versions;
  * unfused ("never", or float64 clouds): ``search_correspondences`` —
    transform, ``KdTree.nearest_neighbor_search`` (kernel K9 on the card),
    gather of the winners' payload, ``make_weights``, rejector mask — feeds
    ``factors.linearize`` and ``factors.error_multi``, plain torch ops as
    they are XLA ops in the JAX package.
The loop state stays on the device; the host reads one stop flag per outer
iteration (with ``verbose``, the printed values ride in the same read).
Parameters sit in the JAX package's positions; ``fused_route`` follows them
as a keyword only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.ops.eigh3 import solve6x6
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    ROBUST_KERNELS,
    ROUTES,
    auto_route,
    gicp_error_multi,
    gicp_linearize_tables,
    gicp_prepare,
)
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.utils.lie import se3_exp
from small_gicp_tpu_torch.models import factors
from small_gicp_tpu_torch.models.factors import GICP, ICP, PLANE_ICP, Correspondences

_NOT_PORTED = ("voxel-map targets (GaussianVoxelMap, IncrementalVoxelMap) and "
               "VGICP wait for ROADMAP item A6")


@dataclass
class RegistrationResult:
    """One registration's result; ``align_fleet`` adds a leading [P] axis."""

    T_target_source: torch.Tensor  # [4,4]
    converged: torch.Tensor  # 0-d bool
    iterations: torch.Tensor  # 0-d int32
    num_inliers: torch.Tensor  # 0-d int32
    H: torch.Tensor  # [6,6]
    b: torch.Tensor  # [6]
    error: torch.Tensor  # 0-d float64


def _converged(delta, rot_eps, trans_eps):
    return ((torch.linalg.vector_norm(delta[:3]) <= rot_eps)
            & (torch.linalg.vector_norm(delta[3:]) <= trans_eps))


def search_correspondences(factor_type: str, target: PointCloud, target_tree,
                           source_points: torch.Tensor, source_num: torch.Tensor,
                           source_covs: Optional[torch.Tensor], T: torch.Tensor,
                           max_dist_sq: float) -> Correspondences:
    """Nearest target row of every transformed source point, with the
    factor's weight matrices and the rejector mask (the point-cloud branch
    of the JAX package's ``_search_correspondences``)."""
    transed = source_points @ T.T  # [N,4]
    n = source_points.shape[0]
    tree = target_tree if target_tree is not None else KdTree.build(target)
    sq_dists, idx = tree.nearest_neighbor_search(transed[:, :3])
    idx = idx.long()
    mu = target.points[idx, :3]
    t_normals = target.normals[idx] if target.normals is not None else None
    t_covs = target.covs[idx] if target.covs is not None else None
    mask = (sq_dists <= max_dist_sq) & (
        torch.arange(n, device=source_points.device) < source_num)
    W = factors.make_weights(factor_type, T, n, source_covs, t_normals, t_covs)
    return Correspondences(target_mu=mu, W=W, mask=mask, target_idx=idx)


def align_impl(target: PointCloud, source: PointCloud, target_tree, init_T,
               registration_type: str = GICP, optimizer: str = "lm",
               robust_kernel: Optional[str] = None, robust_c: float = 1.0,
               max_iterations: int = 20, max_inner_iterations: int = 10,
               max_dist_sq: float = 1.0,
               rotation_eps: float = 0.1 * math.pi / 180.0,
               translation_eps: float = 1e-3, init_lambda: float = 1e-3,
               lambda_factor: float = 10.0, gn_lambda: float = 1e-6,
               dof_mask=None, dof_lambda: float = 1e9, verbose: bool = False,
               use_fused: str = "auto", psum_axis: Optional[str] = None,
               solve_dtype: str = "same", *,
               fused_route: Optional[str] = None) -> RegistrationResult:
    """Register ``source`` to ``target``; both clouds on the same device.

    ``verbose`` prints the JAX package's line once per iteration: LM
    ``iter e new_e lambda dr dt``, GN ``iter e gn_lambda dr dt``.
    ``use_fused``: "auto" takes the fused kernels for float32 clouds;
    "never" keeps the unfused search + linearize route, which float64
    clouds always take. ``psum_axis`` (the point-sharded mode) is not
    ported. ``fused_route``: "listed" or "swept" forces the fused search's
    route; None chooses by the target's size.
    """
    if psum_axis is not None:
        raise NotImplementedError(
            "psum_axis (the point-sharded registration) waits for ROADMAP item A10")
    if not isinstance(target, PointCloud):
        raise NotImplementedError(_NOT_PORTED)
    if target_tree is not None and not isinstance(target_tree, KdTree):
        raise NotImplementedError(
            "only the exact KdTree searcher is ported; projective search "
            "waits for ROADMAP item A9")
    if registration_type not in (ICP, PLANE_ICP, GICP):
        raise ValueError(f"unknown registration type {registration_type!r}")
    if optimizer not in ("gn", "lm"):
        raise ValueError(f"unknown optimizer {optimizer!r} (use 'gn' or 'lm')")
    if robust_kernel is not None and robust_kernel not in ROBUST_KERNELS:
        raise ValueError(f"unknown robust kernel {robust_kernel!r}")
    if solve_dtype not in ("same", "float64"):
        raise ValueError(f"solve_dtype must be 'same' or 'float64', got {solve_dtype!r}")
    if use_fused not in ("auto", "never"):
        raise ValueError(f"use_fused must be 'auto' or 'never', got {use_fused!r}")
    if fused_route is not None and fused_route not in ROUTES:
        raise ValueError(f"fused_route must be None, 'listed' or 'swept', got "
                         f"{fused_route!r}")

    dt, dev = source.dtype, source.device
    solve_dt = dt if solve_dtype == "same" else torch.float64
    T = torch.as_tensor(init_T if init_T is not None else torch.eye(4), dtype=dt,
                        device=dev)
    dof = None
    if dof_mask is not None:
        dof = dof_lambda * torch.diag(torch.abs(
            torch.as_tensor(dof_mask, dtype=solve_dt, device=dev) - 1.0))

    if use_fused == "auto" and dt == torch.float32:
        route = fused_route or auto_route(target.points)
        # A tree over this very target keeps its sort and boxes across aligns
        # (and from the covariance stage of preprocess_points).
        kept = (target_tree.pruned_target()
                if isinstance(target_tree, KdTree)
                and target_tree.points is target.points else None)
        tables = gicp_prepare(
            target.points, target.num_points, source.points, source.num_points,
            factor=registration_type,
            target_covs=target.covs if registration_type == GICP else None,
            source_covs=source.covs if registration_type == GICP else None,
            target_normals=target.normals if registration_type == PLANE_ICP else None,
            route=route, target=kept,
        )

        def linearize(T):
            """(H, b, inliers, frozen correspondences) at T."""
            H, b, inliers, corr = gicp_linearize_tables(
                tables, T, max_dist_sq, robust_kernel, robust_c)
            return H, b, inliers.to(torch.int32), corr

        def errors(corr, Ts):
            return gicp_error_multi(corr, source.points, Ts, source.num_points,
                                    robust_kernel, robust_c)
    else:
        source_covs = source.covs if registration_type == GICP else None

        def linearize(T):
            corr = search_correspondences(
                registration_type, target, target_tree, source.points,
                source.num_points, source_covs, T, max_dist_sq)
            H, b, _ = factors.linearize(corr, T, source.points, robust_kernel,
                                        robust_c)
            return H, b, corr.mask.sum().to(torch.int32), corr

        def errors(corr, Ts):
            return factors.error_multi(corr, Ts, source.points, robust_kernel,
                                       robust_c)

    def linearize_for_solve(T):
        H, b, inliers, corr = linearize(T)
        H = H.to(solve_dt)
        if dof is not None:
            H = H + dof
        return H, b.to(solve_dt), inliers, corr

    lam = torch.tensor(init_lambda, dtype=dt, device=dev)
    H = torch.zeros((6, 6), dtype=dt, device=dev)
    b = torch.zeros(6, dtype=dt, device=dev)
    last_e = torch.zeros((), dtype=torch.float64, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    num_inliers = torch.zeros((), dtype=torch.int32, device=dev)
    iterations = 0
    K = max_inner_iterations
    powers = torch.arange(K, dtype=dt, device=dev)
    gn_damping = torch.tensor(gn_lambda, dtype=solve_dt, device=dev)

    for i in range(max_iterations):
        iterations = i
        Hs, bs, num_inliers, corr = linearize_for_solve(T)
        if optimizer == "gn":
            e = errors(corr, T[None])[0]
            delta = solve6x6(Hs, -bs, gn_damping).to(dt)
            converged = _converged(delta, rotation_eps, translation_eps)
            T = T @ se3_exp(delta)
            stop = converged
            shown = (e, gn_damping)
        else:
            lambdas = lam * lambda_factor ** powers
            deltas = solve6x6(Hs, -bs, lambdas.to(solve_dt)).to(dt)  # [K,6]
            Ts = T @ se3_exp(deltas)
            errs_all = errors(corr, torch.cat([T[None], Ts]))
            e0, errs = errs_all[0], errs_all[1:]
            ok = errs <= e0
            accepted = ok.any()
            j = torch.argmax(ok.to(torch.int32))  # first accepted trial
            T = torch.where(accepted, Ts[j], T)
            e = torch.where(accepted, errs[j], e0)
            delta = torch.where(accepted, deltas[j], torch.zeros_like(deltas[0]))
            lam = torch.where(accepted, lambdas[j] / lambda_factor,
                              lam * lambda_factor ** K)
            converged = accepted & _converged(delta, rotation_eps, translation_eps)
            stop = converged | ~accepted
            shown = (e0, e, lam)
        H, b, last_e = Hs.to(dt), bs.to(dt), e
        if verbose:  # the iteration's one host read carries the line's values
            vals = torch.stack([v.to(torch.float64) for v in (
                stop, *shown, torch.linalg.vector_norm(delta[:3]),
                torch.linalg.vector_norm(delta[3:]))]).tolist()
            names = (("e", "gn_lambda") if optimizer == "gn"
                     else ("e", "new_e", "lambda")) + ("dr", "dt")
            print(f"iter={i} " + " ".join(f"{n}={v}" for n, v in zip(names, vals[1:])))
            if vals[0]:
                break
        elif bool(stop):  # the one host read of the iteration
            break

    return RegistrationResult(
        T_target_source=T,
        converged=converged,
        iterations=torch.tensor(iterations, dtype=torch.int32, device=dev),
        num_inliers=num_inliers,
        H=H,
        b=b,
        error=last_e,
    )


class Registration:
    """Configured registration pipeline (factor / optimizer / rejector /
    robust kernel chosen by configuration)."""

    def __init__(self, registration_type: str = GICP, optimizer: str = "lm",
                 robust_kernel: Optional[str] = None, robust_c: float = 1.0,
                 max_iterations: int = 20, max_inner_iterations: int = 10,
                 max_correspondence_distance: float = 1.0,
                 rotation_eps: float = 0.1 * math.pi / 180.0,
                 translation_eps: float = 1e-3, dof_rotation_mask=None,
                 dof_translation_mask=None, verbose: bool = False,
                 solve_dtype: str = "same", *, fused_route: Optional[str] = None):
        if registration_type == "vgicp":
            raise NotImplementedError(_NOT_PORTED)
        if registration_type not in (ICP, PLANE_ICP, GICP):
            raise ValueError(f"unknown registration type {registration_type!r}")
        if solve_dtype not in ("same", "float64"):
            raise ValueError(
                f"solve_dtype must be 'same' or 'float64', got {solve_dtype!r}")
        self.registration_type = registration_type
        self.optimizer = optimizer
        self.robust_kernel = robust_kernel
        self.robust_c = robust_c
        self.max_iterations = max_iterations
        self.max_inner_iterations = max_inner_iterations
        self.max_correspondence_distance = max_correspondence_distance
        self.rotation_eps = rotation_eps
        self.translation_eps = translation_eps
        self.verbose = verbose
        self.solve_dtype = solve_dtype
        self.fused_route = fused_route
        self.dof_mask = None
        if dof_rotation_mask is not None or dof_translation_mask is not None:
            rm = [1.0] * 3 if dof_rotation_mask is None else list(dof_rotation_mask)
            tm = [1.0] * 3 if dof_translation_mask is None else list(dof_translation_mask)
            self.dof_mask = rm + tm

    def align(self, target: PointCloud, source: PointCloud, target_tree=None,
              init_T=None) -> RegistrationResult:
        return align_impl(
            target, source, target_tree, init_T,
            registration_type=self.registration_type,
            optimizer=self.optimizer,
            robust_kernel=self.robust_kernel,
            robust_c=self.robust_c,
            max_iterations=self.max_iterations,
            max_inner_iterations=self.max_inner_iterations,
            max_dist_sq=self.max_correspondence_distance ** 2,
            rotation_eps=self.rotation_eps,
            translation_eps=self.translation_eps,
            dof_mask=self.dof_mask,
            verbose=self.verbose,
            solve_dtype=self.solve_dtype,
            fused_route=self.fused_route,
        )


def align_points(target: PointCloud, source: PointCloud, target_tree=None,
                 init_T=None, **kwargs) -> RegistrationResult:
    """Functional one-shot align over preprocessed clouds."""
    return Registration(**kwargs).align(target, source, target_tree, init_T)
