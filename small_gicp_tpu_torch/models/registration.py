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
    ``gicp_linearize_sums`` — kernel K1 on the card, or for targets above
    1,572,864 rows the swept kernel K6, both walking the Morton-sorted,
    boxed target (``fused_route`` forces either; a ``KdTree`` built over
    the target keeps that sort and those boxes from the covariance stage
    and from one align to the next, without it they are made anew) — and
    the rest of the iteration (the λ-trial solves, se3_exp, the trial
    errors and the accept) is one launch of the step kernel
    (``ops/lm_step.gicp_lm_step``, K2 redesigned); on CPU tensors those run
    their plain versions;
  * unfused ("never", float64 clouds, a ``ProjectiveSearch`` searcher,
    ``psum_axis``, and every voxel-map target — VGICP is the GICP factor
    against a ``GaussianVoxelMap``, and a ``ShardedVoxelMapTarget`` is a map
    whose slots are split over a mesh): the correspondence search —
    transform, ``KdTree.nearest_neighbor_search`` (kernel K9 on the card),
    the projective window search (a miss: mask 0, d² 1e18), the map's own
    voxel search or the map-block search (``parallel/map_sharding.py``), one
    gather of the winners' payload, ``make_weights``,
    rejector mask — feeds ``factors.linearize``,
    torch ops as they are XLA ops in the JAX package. For float32 clouds
    the correspondences are then packed into the corr rows the step kernel
    reads (``pack_corr_rows``) and the iteration ends in the same step as
    the fused route's (on the card, its kernel: no float32 route runs the
    plain step there); float64 clouds pack float64 rows for the plain step,
    since the kernel's corr rows are float32.
  * point-sharded (``psum_axis``, set by ``parallel/sharding.
    align_point_sharded``): the unfused route over this rank's source rows,
    the 44 float64 sums all-reduced over the mesh, then the step's plain
    functions (the λ-trial solves, ``se3_exp``, the accept) around the trial
    errors of the local rows — the step kernel's errors-only mode on the
    card — all-reduced in turn: the one-launch step cannot hold a collective
    between its solves and its accept. Every decision is taken from reduced
    values, which every rank holds bit for bit.
A target's searched rows are its first ``num_points`` live rows (w > 0.5,
``point_cloud.live_rows``), wherever they stand: a voxel map's cloud view
(``ivm_as_cloud``, ``voxelmap_as_cloud``) keeps them at slot positions, and
both routes search exactly those rows.
The loop state lives on the device in one record (``ops/lm_step.LmState``),
whose pose K1 reads in place; each iteration is K1 (or the unfused
search, factors and packing: spans ``lm.search``, ``lm.factors``, ``lm.pack``
inside ``lm.linearize``, counter ``lm_unfused_iterations``), the step, and
one host read of the stop flag (with ``verbose``,
the printed values ride in the same read). The result's tensors are views
of that record.
Parameters sit in the JAX package's positions; ``fused_route`` and
``source_rows`` follow them as keywords only.
"""

from __future__ import annotations

import math
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from small_gicp_tpu_torch.point_cloud import PointCloud
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    ROBUST_KERNELS,
    ROUTES,
    auto_route,
    gicp_error_multi,
    gicp_error_multi_plain,
    gicp_linearize_sums,
    gicp_prepare,
    linearize_buffers,
)
from small_gicp_tpu_torch.ops.knn import KdTree
from small_gicp_tpu_torch.ops.projective_search import ProjectiveSearch
from small_gicp_tpu_torch.ops.lm_step import (
    gicp_lm_step,
    gicp_lm_step_plain,
    lm_state,
    step_norms,
)
from small_gicp_tpu_torch.models import factors
from small_gicp_tpu_torch.models.factors import GICP, ICP, PLANE_ICP, Correspondences
from small_gicp_tpu_torch.models.voxelmap import GaussianVoxelMap, IncrementalVoxelMap
from small_gicp_tpu_torch.utils.profiling import count, host_read, span

VGICP = "vgicp"


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

    def replace(self, **changes) -> "RegistrationResult":
        return dataclasses.replace(self, **changes)


def search_correspondences(factor_type: str, target, target_tree,
                           source_points: torch.Tensor, source_num: torch.Tensor,
                           source_covs: Optional[torch.Tensor], T: torch.Tensor,
                           max_dist_sq: float) -> Tuple[Correspondences, torch.Tensor]:
    """Nearest target row (or voxel) of every transformed source point, with
    the factor's weight matrices and the rejector mask, and the winners' d²
    [N]: the JAX package's ``_search_correspondences`` for a PointCloud
    (searched by ``target_tree`` — a ``KdTree`` or a ``ProjectiveSearch``,
    whose misses mask out —, or a ``KdTree`` built here), a
    ``GaussianVoxelMap``, an ``IncrementalVoxelMap`` or a
    ``ShardedVoxelMapTarget`` (the winners' payload arrives gathered)."""
    # The parallel layer sits above this one: imported where it is used.
    from small_gicp_tpu_torch.parallel.map_sharding import (
        ShardedVoxelMapTarget,
        sharded_nn_payload,
    )

    transed = source_points @ T.T  # [N,4]
    n = source_points.shape[0]
    found = None
    if isinstance(target, ShardedVoxelMapTarget):
        sq_dists, found, mu, t_covs, t_normals = sharded_nn_payload(
            target.vm, transed[:, :3], target.mesh)
        idx = torch.zeros(n, dtype=torch.int64, device=source_points.device)
    elif isinstance(target, GaussianVoxelMap):
        # The slot table's payload is one [mean | cov | count] row: one gather.
        sq_dists, idx, found = target.nearest_neighbor_search(transed[:, :3])
        rows = target.payload[idx.long()]
        mu, t_normals, t_covs = rows[:, :3], None, rows[:, 4:13].reshape(-1, 3, 3)
    elif isinstance(target, IncrementalVoxelMap):
        # One gather of the [point | normal? | cov?] rows.
        sq_dists, idx, found = target.nearest_neighbor_search(transed[:, :3])
        rows = target.payload[idx.long()]
        mu, off, t_normals, t_covs = rows[:, :3], 4, None, None
        if target.has_normals:
            t_normals, off = rows[:, off:off + 4], off + 4
        if target.has_covs:
            t_covs = rows[:, off:off + 9].reshape(-1, 3, 3)
    else:
        if isinstance(target_tree, ProjectiveSearch):
            sq_dists, idx, found = target_tree.nearest_neighbor_search(transed[:, :3])
        else:
            tree = target_tree if target_tree is not None else KdTree.build(target)
            sq_dists, idx = tree.nearest_neighbor_search(transed[:, :3])
        idx = idx.long()
        mu = target.points[idx, :3]
        t_normals = target.normals[idx] if target.normals is not None else None
        t_covs = target.covs[idx] if target.covs is not None else None
    mask = (sq_dists <= max_dist_sq) & (
        torch.arange(n, device=source_points.device) < source_num)
    if found is not None:
        mask = mask & found
    W = factors.make_weights(factor_type, T, n, source_covs, t_normals, t_covs)
    return Correspondences(target_mu=mu, W=W, mask=mask, target_idx=idx.long()), sq_dists


def pack_corr_rows(corr: Correspondences, sq_dists: torch.Tensor) -> torch.Tensor:
    """[N,16] corr rows in source order and the correspondences' dtype, the
    layout K1 writes and the step kernel reads: [μ 3 | W 9 | mask | d² | 0 0].
    A row with mask 0 keeps its nearest candidate (nothing reads it)."""
    n = corr.mask.shape[0]
    dt = corr.target_mu.dtype
    return torch.cat([corr.target_mu, corr.W.reshape(n, 9).to(dt),
                      corr.mask.to(dt)[:, None], sq_dists.to(dt)[:, None],
                      corr.target_mu.new_zeros((n, 2))], dim=1)


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
               fused_route: Optional[str] = None,
               source_rows: Optional[int] = None) -> RegistrationResult:
    """Register ``source`` to ``target`` (a PointCloud, a ``GaussianVoxelMap``
    — VGICP with the GICP factor — or an ``IncrementalVoxelMap``), all on
    one device.

    ``verbose`` prints the JAX package's line once per iteration: LM
    ``iter e new_e lambda dr dt``, GN ``iter e gn_lambda dr dt``.
    ``use_fused``: "auto" takes the fused kernels for float32 clouds against
    a PointCloud searched by a ``KdTree`` (or none); "never" keeps the
    unfused search + linearize route, which float64 clouds, a
    ``ProjectiveSearch``, ``psum_axis`` and voxel maps always take.
    ``psum_axis``: a 1-D ``DeviceMesh`` (or its process group) over which
    the source rows are split (``align_point_sharded`` passes this rank's
    block): the sums and the trial errors are all-reduced over it each
    iteration. ``fused_route``: "listed" or "swept"
    forces the fused search's route; None chooses by the target's size.
    ``max_inner_iterations``: any K ≥ 0, at most 99 where the step kernel
    runs (float32 clouds on the card). ``source_rows``: a host bound on the
    source's valid rows for the fused route's chunk plan (``gicp_prepare``);
    None reads the count from the card once.
    """
    from small_gicp_tpu_torch.parallel.map_sharding import ShardedVoxelMapTarget
    from small_gicp_tpu_torch.parallel.multihost import mesh_group

    group = None
    if psum_axis is not None:
        try:
            group = mesh_group(psum_axis)[0]
        except TypeError:
            raise TypeError(f"psum_axis must be a 1-D DeviceMesh or a process group, "
                            f"got {type(psum_axis).__name__}") from None
    if not isinstance(target, (PointCloud, GaussianVoxelMap, IncrementalVoxelMap,
                               ShardedVoxelMapTarget)):
        raise TypeError(f"target must be a PointCloud, a voxel map or a "
                        f"ShardedVoxelMapTarget, got {type(target).__name__}")
    if target_tree is not None and not isinstance(target_tree, (KdTree, ProjectiveSearch)):
        raise TypeError(f"target_tree must be None, a KdTree or a ProjectiveSearch, got "
                        f"{type(target_tree).__name__}")
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
    T0 = init_T if init_T is not None else torch.eye(4)
    dof_diag = None
    if dof_mask is not None:
        dof_diag = [dof_lambda * abs(float(m) - 1.0)
                    for m in torch.as_tensor(dof_mask, dtype=torch.float64).tolist()]
    count("registrations")
    with span("align.state"):
        state = lm_state(T0, optimizer, max_inner_iterations, init_lambda, lambda_factor,
                         gn_lambda, rotation_eps, translation_eps, dof_diag, dt, dev)

    cloud = isinstance(target, PointCloud)
    if (use_fused == "auto" and dt == torch.float32 and cloud and group is None
            and not isinstance(target_tree, ProjectiveSearch)):
        route = fused_route or auto_route(target.points)
        # A tree over this very target keeps its sort and boxes across aligns
        # (and from the covariance stage of preprocess_points).
        with span("align.prepare"):
            kept = (target_tree.pruned_target()
                    if isinstance(target_tree, KdTree)
                    and target_tree.points is target.points else None)
            tables = gicp_prepare(
                target.points, target.num_points, source.points, source.num_points,
                factor=registration_type,
                target_covs=target.covs if registration_type == GICP else None,
                source_covs=source.covs if registration_type == GICP else None,
                target_normals=target.normals if registration_type == PLANE_ICP else None,
                route=route, target=kept, source_rows=source_rows,
            )
            out = linearize_buffers(tables)

        def iterate():
            """K1 (or K6) at the record's pose, then the step kernel."""
            with span("lm.linearize"):
                sums, corr = gicp_linearize_sums(tables, state.T, max_dist_sq,
                                                 robust_kernel, robust_c, out)
            with span("lm.step"):
                gicp_lm_step(state, sums, corr, source.points, source.num_points,
                             robust_kernel, robust_c, solve_dtype)
    else:
        source_covs = source.covs if registration_type == GICP else None
        tree = target_tree
        if cloud and tree is None:
            with span("align.prepare"):
                tree = KdTree.build(target)

        # The step kernel reads float32 rows: float64 clouds take its plain
        # version, over rows packed the same way in float64.
        step = gicp_lm_step if dt == torch.float32 else gicp_lm_step_plain
        if group is not None:
            step = _sharded_step(group, gicp_error_multi if dt == torch.float32
                                 else gicp_error_multi_plain)

        def iterate():
            """The unfused search and factors, then the step on the packed
            corr rows."""
            count("lm_unfused_iterations")
            with span("lm.linearize"):
                with span("lm.search"):
                    corr, d2 = search_correspondences(
                        registration_type, target, tree, source.points,
                        source.num_points, source_covs, state.T, max_dist_sq)
                with span("lm.factors"):
                    H, b, _ = factors.linearize(corr, state.T, source.points,
                                                robust_kernel, robust_c)
                    sums = torch.cat([H.reshape(36), b, H.new_zeros(1),
                                      corr.mask.sum().reshape(1).to(H.dtype)]
                                     ).to(torch.float64)
                with span("lm.pack"):
                    rows = pack_corr_rows(corr, d2)
            if group is not None:
                dist.all_reduce(sums, group=group)
            with span("lm.step"):
                step(state, sums, rows, source.points, source.num_points,
                     robust_kernel, robust_c, solve_dtype)

    names = (("e", "gn_lambda") if optimizer == "gn" else ("e", "new_e", "lambda")) \
        + ("dr", "dt")
    for i in range(max_iterations):
        count("lm_iterations")
        with span("lm.iter"):
            iterate()
            if verbose:  # the iteration's one host read carries the line's values
                shown = ((state.e, state.params[1].to(dt)) if optimizer == "gn"
                         else (state.errs[0], state.e, state.lam))
                with host_read("stop"):
                    vals = torch.stack([v.to(torch.float64) for v in (
                        state.stop, *shown, *step_norms(state))]).tolist()
                print(f"iter={i} " + " ".join(f"{n}={v}" for n, v in zip(names, vals[1:])))
                stop = vals[0]
            else:
                with host_read("stop"):  # the one host read of the iteration
                    stop = bool(state.stop)
        if stop:
            break

    return RegistrationResult(
        T_target_source=state.T,
        converged=state.converged,
        iterations=state.iterations,
        num_inliers=state.inliers,
        H=state.H,
        b=state.b,
        error=state.e,
    )


def _sharded_step(group, errors_of):
    """The point-sharded step: the plain step's solves and accept around the
    local rows' trial errors (``errors_of``: K2's errors-only mode on the
    card), all-reduced over ``group``."""

    def step(state, sums, corr, src, num_points, robust, robust_c, solve_dtype):
        def errors(poses):
            errs = errors_of(corr, src, poses, num_points, robust, robust_c)
            dist.all_reduce(errs, group=group)
            return errs

        return gicp_lm_step_plain(state, sums, corr, src, num_points, robust, robust_c,
                                  solve_dtype, errors=errors)

    return step


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
        if registration_type not in (ICP, PLANE_ICP, GICP, VGICP):
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

    def align(self, target, source: PointCloud, target_tree=None,
              init_T=None) -> RegistrationResult:
        """Register ``source`` to ``target``: a PointCloud or a voxel map
        ("vgicp" is the GICP factor against a ``GaussianVoxelMap``)."""
        return align_impl(
            target, source, target_tree, init_T,
            registration_type=GICP if self.registration_type == VGICP
            else self.registration_type,
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


def align_points(target, source: PointCloud, target_tree=None,
                 init_T=None, **kwargs) -> RegistrationResult:
    """Functional one-shot align over preprocessed clouds."""
    return Registration(**kwargs).align(target, source, target_tree, init_T)
