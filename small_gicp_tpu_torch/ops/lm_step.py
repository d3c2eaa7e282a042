"""The optimizer's step (K2 redesigned): the λ-trial solves, se3_exp, the
trial errors and the accept of one LM (or GN) iteration, in one launch.

Counterpart of the body of the JAX package's LM loop
(``small_gicp_tpu/models/registration.py:472-548``: ``_solve`` over the λ_j,
``se3_exp``, the einsum, ``gicp_error_multi_pallas`` and the accept), which
runs there inside one jitted ``while_loop``. Here the loop stays on the host
and its state lives on the device in one record (``LmState``): the pose
(which K1 reads in place), λ, the error, the step taken, the flags, H, b,
the inlier count, the iteration counters, the errors at the current pose
and at every trial, and each trial's δ and pose. The parameters of the
align (the power table f^0 … f^K, the DoF diagonal, gn_lambda, the eps
values) ride in the same allocation, made and copied once per align.

``gicp_lm_step(state, sums, corr, src, num_points, ...)`` takes K1's float64
sums [44] in place and its frozen corr rows [N,16] and updates the record:
on a CUDA tensor one launch of ``csrc/gicp_step.cu``, on a CPU tensor
``gicp_lm_step_plain``, which defines the arithmetic the kernel follows:

  * trial j < K solves (H + λ·f^j·I + dof)·δ_j = −b in the solve type S
    (the cloud's type, or float64) by the scalar Cholesky recurrence of the
    JAX package's ``_cholesky_solve6`` (pivot clamped at 1e-30; ``1/d``
    then a product for L, a quotient in the substitutions), each operation
    rounded on its own; H is K1's float64 sums cast to S, plus the DoF
    diagonal cast to S, plus λ_j cast to S on the diagonal; λ_j is λ·(f^j
    cast to the cloud type), f^j from repeated float64 products;
  * δ_j is cast to the cloud type, T_j = T·se3_exp(δ_j) (``utils/lie.py``);
  * the errors at T and every T_j (K2's arithmetic, float64 totals); the
    first j with err_j ≤ e0 is accepted: T, e, δ ← T_j, err_j, δ_j and
    λ ← λ_j / f; if none is, e = e0, δ = 0, λ ← λ·f^K and the loop stops;
    converged = accepted and ‖δ_rot‖ ≤ rot_eps and ‖δ_t‖ ≤ trans_eps (each
    norm √((x² + y²) + z²) in the cloud type, compared in that type);
  * GN: one solve at gn_lambda, the error at T, T ← T·se3_exp(δ) always,
    converged by the same test, stop = converged.

The kernel's errors differ from the plain version's in summation order
only (float32 block sums), its poses by the device's ``sinf`` and product
order (last bits); the accept of the two can differ only where a trial's
error lies within that rounding of e0.

``_gicp_error_multi_step`` is K2's public function ``gicp_error_multi`` on
the card: the same kernel in its errors-only mode, [K1] float64 errors at
given poses, the sums finished in the launch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from small_gicp_tpu_torch import _build
from small_gicp_tpu_torch.ops.gicp_fused_cuda import (
    MAX_POSES,
    _robust_code,
    _stream,
    gicp_error_multi_plain,
)
from small_gicp_tpu_torch.utils.lie import se3_exp

OPTIMIZERS = ("lm", "gn")
MAX_TRIALS = MAX_POSES - 1
# Source rows a block of the kernel (csrc/gicp_step.cu kStepBlockRows).
STEP_BLOCK_ROWS = 256
# Values of the parameter table before the powers f^0 … f^K.
_PAR_POW = 10
_TRIAL_ROW = 18  # δ 6 | R 9 | t 3
_PIVOT_EPS = 1e-30
# csrc/gicp_step.cu's sgt_step_geometry: rows a block, most poses, the float32
# record's offsets (T H b delta lam inliers e iterations count j converged
# accepted stop errs), the trial row's width and the power table's start.
_GEOMETRY = (STEP_BLOCK_ROWS, MAX_POSES, 0, 64, 208, 232, 256, 260, 264, 272, 276,
             280, 284, 285, 286, 288, _TRIAL_ROW, _PAR_POW)


def _layout(dt: torch.dtype, trials: int) -> Tuple[Dict[str, tuple], int]:
    """{field: (byte offset, dtype, shape)} of the record for clouds of type
    ``dt`` and ``trials`` trials, and its size in bytes (the parameters
    follow at that offset). float32 gives csrc/gicp_step.cu's offsets."""
    s = torch.empty((), dtype=dt).element_size()
    e = -(-(65 * s + 4) // 8) * 8
    errs = e + 24
    rows = errs + 8 * (trials + 1)
    size = -(-(rows + _TRIAL_ROW * s * trials) // 8) * 8
    return {
        "T": (0, dt, (4, 4)), "H": (16 * s, dt, (6, 6)), "b": (52 * s, dt, (6,)),
        "delta": (58 * s, dt, (6,)), "lam": (64 * s, dt, ()),
        "inliers": (65 * s, torch.int32, ()), "e": (e, torch.float64, ()),
        "iterations": (e + 8, torch.int32, ()), "count": (e + 12, torch.int32, ()),
        "j": (e + 16, torch.int32, ()), "converged": (e + 20, torch.bool, ()),
        "accepted": (e + 21, torch.bool, ()), "stop": (e + 22, torch.bool, ()),
        "errs": (errs, torch.float64, (trials + 1,)),
        "trials": (rows, dt, (trials, _TRIAL_ROW)),
    }, size


@dataclass
class LmState:
    """The optimizer's state on the device: ``raw`` holds the record and then
    the parameters; the other tensors are views of it. ``T`` [4,4] is the
    pose K1 reads; ``iterations`` the index of the last executed iteration,
    ``count`` the iterations executed; ``errs`` [trials + 1] the errors at
    the pose the last step started from and at each trial (GN: errs[0]);
    ``trials`` [trials, 18] each trial's δ | R row-major | t."""

    raw: torch.Tensor  # uint8
    optimizer: str
    num_trials: int
    T: torch.Tensor
    H: torch.Tensor
    b: torch.Tensor
    delta: torch.Tensor
    lam: torch.Tensor
    inliers: torch.Tensor
    e: torch.Tensor
    iterations: torch.Tensor
    count: torch.Tensor
    j: torch.Tensor
    converged: torch.Tensor
    accepted: torch.Tensor
    stop: torch.Tensor
    errs: torch.Tensor
    trials: torch.Tensor
    params: torch.Tensor  # float64: f, gn_lambda, rot_eps, trans_eps, dof 6, f^0 … f^K


def _views(raw: torch.Tensor, dt: torch.dtype, trials: int):
    fields, size = _layout(dt, trials)
    out = {}
    for name, (off, dtype, shape) in fields.items():
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        out[name] = raw[off:off + n].view(dtype).view(shape)
    out["params"] = raw[size:].view(torch.float64)
    return out


def lm_state(init_T, optimizer: str = "lm", max_inner_iterations: int = 10,
             init_lambda: float = 1e-3, lambda_factor: float = 10.0,
             gn_lambda: float = 1e-6, rotation_eps: float = 0.1 * math.pi / 180.0,
             translation_eps: float = 1e-3, dof_diag: Optional[Sequence[float]] = None,
             dtype: torch.dtype = torch.float32, device=None) -> LmState:
    """A new record at pose ``init_T`` (λ = init_lambda, counters 0), built
    on the host and copied to ``device`` in one piece. ``dof_diag``: the
    DoF prior's diagonal λ_dof·|mask − 1| (float64 values), or None.
    GN keeps one trial (its solve at gn_lambda). Any K ≥ 0 (LM with K = 0
    rejects every step); the kernel takes at most MAX_TRIALS."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r} (use 'gn' or 'lm')")
    trials = int(max_inner_iterations) if optimizer == "lm" else 1
    if trials < 0:
        raise ValueError(f"max_inner_iterations must be at least 0, got {trials}")
    _, size = _layout(dtype, trials)
    powers = [1.0]
    for _ in range(trials):
        powers.append(powers[-1] * float(lambda_factor))
    dof = [0.0] * 6 if dof_diag is None else [float(v) for v in dof_diag]
    params = [float(lambda_factor), float(gn_lambda), float(rotation_eps),
              float(translation_eps), *dof, *powers]
    host = torch.zeros((size + 8 * len(params)) // 8, dtype=torch.float64)
    raw = host.view(torch.uint8)
    v = _views(raw, dtype, trials)
    # A pose already on the card is copied there, after the record: reading
    # it back to the host would wait for the card.
    on_card = isinstance(init_T, torch.Tensor) and init_T.device.type != "cpu"
    if not on_card:
        v["T"].copy_(torch.as_tensor(init_T, dtype=dtype).reshape(4, 4))
    v["lam"].fill_(init_lambda)
    v["params"].copy_(torch.tensor(params, dtype=torch.float64))
    if torch.device(device if device is not None else "cpu").type == "cuda":
        raw = host.pin_memory().to(device, non_blocking=True).view(torch.uint8)
    views = _views(raw, dtype, trials)
    if on_card:
        views["T"].copy_(init_T.reshape(4, 4))
    return LmState(raw=raw, optimizer=optimizer, num_trials=trials, **views)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """√((x² + y²) + z²) of v [..., 3], each operation rounded on its own."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def step_norms(state: LmState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(‖δ_rot‖, ‖δ_t‖) of the step taken, as the convergence test forms them."""
    return _norm3(state.delta[:3]), _norm3(state.delta[3:])


def solve6_trials(Hs: torch.Tensor, rhs: torch.Tensor,
                  damping: torch.Tensor) -> torch.Tensor:
    """(Hs + damping_t·I)·x_t = rhs for each damping value: Hs [6,6], rhs
    [6], damping [T], all of one type → [T,6]. The JAX package's scalar
    Cholesky recurrence on the lower triangle, batched over the trials."""
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = Hs[j, j] + damping
        for kk in range(j):
            s = s - L[j][kk] * L[j][kk]
        d = torch.sqrt(torch.clamp(s, min=_PIVOT_EPS))
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, 6):
            t = Hs[i, j]
            for kk in range(j):
                t = t - L[i][kk] * L[j][kk]
            L[i][j] = t * inv
    y = [None] * 6
    for i in range(6):
        s = rhs[i].expand(damping.shape)
        for kk in range(i):
            s = s - L[i][kk] * y[kk]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for kk in range(i + 1, 6):
            s = s - L[kk][i] * x[kk]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def gicp_lm_step_plain(state: LmState, sums: torch.Tensor, corr, src: torch.Tensor,
                       num_points: torch.Tensor, robust: Optional[str] = None,
                       robust_c: float = 1.0, solve_dtype: str = "same",
                       errors: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                       ) -> LmState:
    """Plain PyTorch version of the step kernel; updates ``state`` in place.
    ``errors(poses [K1,4,4]) → [K1] float64`` evaluates the poses (default:
    K2's arithmetic over the frozen corr rows, ``gicp_error_multi_plain``;
    ``chip_smoke.py`` passes K2's first form, the step kernel's yardstick)."""
    dt = state.T.dtype
    sdt = dt if solve_dtype == "same" else torch.float64
    p, trials = state.params, state.num_trials
    Hs = sums[:36].reshape(6, 6).to(sdt) + torch.diag(p[4:10].to(sdt))
    bs = sums[36:42].to(sdt)
    lm = state.optimizer == "lm"
    if lm:
        lambdas = state.lam * p[_PAR_POW:_PAR_POW + trials + 1].to(dt)  # [K+1]
        damping = lambdas[:trials].to(sdt)
    else:
        damping = p[1:2].to(sdt)
    deltas = solve6_trials(Hs, -bs, damping).to(dt)  # [trials, 6]
    T = state.T.clone()
    Ts = T @ se3_exp(deltas)  # [trials, 4, 4]
    poses = torch.cat([T[None], Ts]) if lm else T[None]
    if errors is None:
        errs = gicp_error_multi_plain(corr, src, poses, num_points, robust, robust_c)
    else:
        errs = errors(poses)
    errs = errs.to(torch.float64)
    if lm:
        # Each trial, then the current pose as a last entry that always
        # accepts: j is the first accepted trial, or K if none is.
        ok = torch.cat([errs[1:] <= errs[0], errs.new_ones(1, dtype=torch.bool)])
        j = torch.argmax(ok.to(torch.int32))
        accepted = j < trials
        T_new = torch.cat([Ts, T[None]])[j]
        e = torch.cat([errs[1:], errs[:1]])[j]
        delta = torch.cat([deltas, deltas.new_zeros(1, 6)])[j]
        lam = torch.where(accepted, lambdas[j] / p[0].to(dt), lambdas[trials])
        j = torch.where(accepted, j, -1)
    else:
        accepted = torch.ones((), dtype=torch.bool, device=T.device)
        j = torch.zeros((), dtype=torch.int64, device=T.device)
        T_new, e, delta, lam = Ts[0], errs[0], deltas[0], state.lam
    converged = accepted & (_norm3(delta[:3]) <= p[2].to(dt)) & (
        _norm3(delta[3:]) <= p[3].to(dt))
    state.errs[:errs.shape[0]] = errs
    state.trials[:, :6] = deltas
    state.trials[:, 6:15] = Ts[:, :3, :3].reshape(trials, 9)
    state.trials[:, 15:] = Ts[:, :3, 3]
    state.H.copy_(Hs)
    state.b.copy_(bs)
    state.T.copy_(T_new)
    state.delta.copy_(delta)
    state.lam.copy_(lam)
    state.inliers.copy_(sums[43].to(torch.int32))
    state.e.copy_(e)
    state.iterations.copy_(state.count)
    state.count.add_(1)
    state.j.copy_(j)
    state.converged.copy_(converged)
    state.accepted.copy_(accepted)
    state.stop.copy_(converged | ~accepted)
    return state


# ------------------------------------------------------------ the kernel ----

@dataclass
class _StepBuffers:
    """The block partials (float32) and the block ticket (int32 [1], zero
    between launches: the last block sets it back)."""

    partials: torch.Tensor
    ticket: torch.Tensor


_buffers: Dict[Tuple[int, int], _StepBuffers] = {}


def _step_workspace(dev: torch.device, floats: int) -> _StepBuffers:
    """The buffers of one device and stream, on which launches run in
    order, grown to ``floats`` partials; the ticket is set once."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    w = _buffers.get(key)
    if w is None:
        w = _buffers[key] = _StepBuffers(
            partials=torch.empty(0, dtype=torch.float32, device=dev),
            ticket=torch.zeros(1, dtype=torch.int32, device=dev))
    if w.partials.numel() < floats:
        w.partials = torch.empty(max(floats, 4096), dtype=torch.float32, device=dev)
    return w


def _library():
    return _build.library_with_geometry("gicp_step", "sgt_step_geometry", _GEOMETRY)


def _require_rows(corr, src, num_points):
    f32 = torch.float32
    _build.require(corr, "corr", f32, (None, 16))
    n = corr.shape[0]
    _build.require(src, "src", f32, (n, 4))
    _build.require(num_points, "num_points", torch.int32, ())
    return n


def _gicp_lm_step_cuda(state: LmState, sums, corr, src, num_points, robust, robust_c,
                       solve_dtype):
    if state.T.dtype != torch.float32:
        raise ValueError("the step kernel runs float32 clouds")
    if state.num_trials > MAX_TRIALS:
        raise ValueError(f"the step kernel takes at most {MAX_TRIALS} trials "
                         f"(max_inner_iterations), got {state.num_trials}")
    _build.require(state.raw, "state", torch.uint8, (None,))
    _build.require(sums, "sums", torch.float64, (44,))
    n = _require_rows(corr, src, num_points)
    dev = corr.device
    lm = state.optimizer == "lm"
    k1 = state.num_trials + 1 if lm else 1
    ws = _step_workspace(dev, max(1, -(-n // STEP_BLOCK_ROWS)) * k1)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.sgt_gicp_step(
            sums.data_ptr(), corr.data_ptr(), src.data_ptr(), num_points.data_ptr(), n,
            1 if lm else 2, state.num_trials, int(solve_dtype == "float64"),
            state.params.data_ptr(), float(robust_c), _robust_code(robust),
            state.raw.data_ptr(), ws.partials.data_ptr(), ws.ticket.data_ptr(), _stream())
    _build.check(rc, "gicp_lm_step")
    gicp_lm_step.launches += 1
    return state


def gicp_lm_step(state: LmState, sums: torch.Tensor, corr: torch.Tensor,
                 src: torch.Tensor, num_points: torch.Tensor,
                 robust: Optional[str] = None, robust_c: float = 1.0,
                 solve_dtype: str = "same") -> LmState:
    """One LM or GN iteration after a linearization: K1's ``sums`` [44]
    float64 and frozen ``corr`` [N,16], the source points ``src`` [N,4] and
    their count; updates ``state`` in place (see the module's note). The
    kernel of ``csrc/gicp_step.cu`` on CUDA tensors, the plain version on
    CPU ones."""
    if solve_dtype not in ("same", "float64"):
        raise ValueError(f"solve_dtype must be 'same' or 'float64', got {solve_dtype!r}")
    if corr.device.type == "cpu":
        _robust_code(robust)
        return gicp_lm_step_plain(state, sums, corr, src, num_points, robust, robust_c,
                                  solve_dtype)
    return _gicp_lm_step_cuda(state, sums, corr, src, num_points, robust, robust_c,
                              solve_dtype)


gicp_lm_step.launches = 0


def _gicp_error_multi_step(corr, src, Ts, num_points, robust, robust_c) -> torch.Tensor:
    """K2 on the card: the step kernel's errors-only mode at the poses Ts
    [K1,4,4] (read in place when float32 and contiguous on the card) →
    [K1] float64. Counted on ``gicp_error_multi``."""
    from small_gicp_tpu_torch.ops.gicp_fused_cuda import gicp_error_multi

    n = _require_rows(corr, src, num_points)
    dev = corr.device
    k1 = Ts.shape[0]
    poses = Ts if (Ts.is_cuda and Ts.dtype == torch.float32 and Ts.is_contiguous()) \
        else Ts.to(device=dev, dtype=torch.float32).contiguous()
    _build.require(poses, "Ts", torch.float32, (k1, 4, 4))
    errs = torch.empty(k1, dtype=torch.float64, device=dev)
    ws = _step_workspace(dev, max(1, -(-n // STEP_BLOCK_ROWS)) * k1)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.sgt_gicp_step_errors(
            corr.data_ptr(), src.data_ptr(), num_points.data_ptr(), n, poses.data_ptr(),
            k1, float(robust_c), _robust_code(robust), ws.partials.data_ptr(),
            ws.ticket.data_ptr(), errs.data_ptr(), _stream())
    _build.check(rc, "gicp_error_multi")
    gicp_error_multi.launches += 1
    return errs
