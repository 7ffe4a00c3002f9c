"""Batched limited-memory BFGS with a batched-fan Armijo line search.

One solver instance advances all B series at once on (B, P) parameter
blocks.  The loop runs on the host: each iteration is a fixed sequence of
batched torch ops (the objective and the line-search fan are the K3 and
K4 kernels on the card), and per-series convergence is a (B,) mask that
freezes finished series (their updates are masked out) rather than
exiting early.  The loop ends when every series has converged or the
iteration cap is hit.

  * The two-loop recursion runs over ``history`` (default 10) ring slots;
    each step is a (B,) dot product over P plus an axpy.
  * The line search is a *batched fan*: the geometric ladder of candidate
    steps is known up front, so all K trials are scored in ONE call — the
    closed-form fan (K4) for linear growth, else one objective call on a
    (K+1, B, P) stack — and each series takes its largest
    Armijo-accepted step.  The accepted point is the one sequential
    backtracking would find.
  * Safeguards: non-finite trial losses are rejections; if no rung
    passes, a tiny preconditioned-gradient step is the fallback; curvature
    pairs with non-positive ``s.y`` are dropped (rho = 0).
  * ``status`` says WHY a series stopped: gradient tolerance, relative
    decrease tolerance (with patience), the float32 noise floor, or a
    failed search.

The objective callable maps (B, P) params -> ((B,) losses, (B, P) grads).
Every op is row-local, so a row's trajectory does not depend on the other
rows of the batch (``take_state`` and the compacting scheduler rely on
it).  The host loop reads the converged mask every ``SYNC_EVERY``
iterations; a body in which no row is active changes no field of the
result, so the check's period never changes what a solve returns.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from tsspark_tpu_torch.config import SolverConfig

# Per-series termination reasons (LbfgsState.status / LbfgsResult.status).
STATUS_RUNNING = 0   # still iterating (or hit the iteration cap while moving)
STATUS_GTOL = 1      # gradient inf-norm below gtol
STATUS_FTOL = 2      # relative objective decrease below tol
STATUS_FLOOR = 3     # stationary at the float32 noise floor (see SolverConfig)
STATUS_STALLED = 4   # no acceptable step anywhere (ladder + fallback failed)

#: Iterations between two reads of the converged mask (each read waits
#: for the device).
SYNC_EVERY = 4


class LbfgsState(NamedTuple):
    theta: torch.Tensor      # (B, P)
    f: torch.Tensor          # (B,)
    grad: torch.Tensor       # (B, P)
    s_hist: torch.Tensor     # (M, B, P) parameter displacements
    y_hist: torch.Tensor     # (M, B, P) gradient displacements
    rho: torch.Tensor        # (M, B) 1 / (s.y); 0 marks an invalid/empty slot
    iteration: int           # iterations run so far (host int)
    converged: torch.Tensor  # (B,) bool
    n_iters: torch.Tensor    # (B,) int32 — iterations each series actually ran
    prev_step: torch.Tensor  # (B,) last accepted line-search step
    floor_count: torch.Tensor  # (B,) int32 consecutive noise-floor iterations
    ftol_count: torch.Tensor   # (B,) int32 consecutive sub-ftol iterations
    status: torch.Tensor     # (B,) int32 STATUS_* termination reason
    precond: torch.Tensor    # (B, P) inverse-curvature diag (initial metric)


class LbfgsResult(NamedTuple):
    theta: torch.Tensor
    f: torch.Tensor
    grad_norm: torch.Tensor
    converged: torch.Tensor
    n_iters: torch.Tensor
    status: torch.Tensor


class SolveTiming:
    """Host seconds spent issuing iteration bodies, and their count: the
    host cost of one iteration of the torch-op body (waits for the device
    at the convergence checks excluded)."""

    def __init__(self) -> None:
        self.body_s = 0.0
        self.iters = 0

    def reset(self) -> None:
        self.body_s = 0.0
        self.iters = 0


#: Accumulates over every solve in the process; reset before reading.
timing = SolveTiming()


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched inner product over the parameter axis: (..., B, P) -> (..., B)."""
    return (a * b).sum(dim=-1)


def _two_loop_direction(state: LbfgsState, history: int) -> torch.Tensor:
    """Batched two-loop recursion: approximate -H^{-1} g for every series.

    History slots are ring-indexed newest-first relative to the iteration
    counter; empty/invalid slots carry rho == 0 and contribute nothing.
    """
    q = state.grad
    m = history
    newest = (state.iteration - 1) % m
    order = [(newest - i) % m for i in range(m)]  # newest ... oldest

    alphas = []
    for idx in order:
        s_i = state.s_hist[idx]
        y_i = state.y_hist[idx]
        r_i = state.rho[idx]  # (B,)
        alpha = r_i * _dot(s_i, q)
        q = q - torch.where(r_i[:, None] != 0, alpha[:, None] * y_i, 0.0)
        alphas.append((idx, alpha))

    # Initial metric H0 = gamma * D, D = diag inverse-curvature
    # preconditioner (ones when disabled), gamma = s.y / (y.D y) of the
    # newest valid pair; with empty history the direction is -D g.
    d2 = state.precond
    s_n, y_n, r_n = state.s_hist[newest], state.y_hist[newest], state.rho[newest]
    yy = _dot(y_n * d2, y_n)
    gamma = torch.where((r_n != 0) & (yy > 0),
                        _dot(s_n, y_n) / torch.clamp(yy, min=1e-30), 1.0)
    r = q * gamma[:, None] * d2

    for idx, alpha in reversed(alphas):
        s_i = state.s_hist[idx]
        y_i = state.y_hist[idx]
        r_i = state.rho[idx]
        beta = r_i * _dot(y_i, r)
        r = r + torch.where(r_i[:, None] != 0, (alpha - beta)[:, None] * s_i,
                            0.0)
    return -r


def init_state(
    fun: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    theta0: torch.Tensor,
    config: SolverConfig = SolverConfig(),
    precond: Optional[torch.Tensor] = None,
) -> LbfgsState:
    """Fresh solver state at theta0 (one objective evaluation).

    ``precond``: optional (B, P) inverse-curvature diagonal used as the
    L-BFGS initial metric (see _two_loop_direction); None disables it.
    """
    b, p = theta0.shape
    m = config.history
    f0, g0 = fun(theta0)
    if precond is None:
        precond = torch.ones_like(theta0)
    i32 = dict(dtype=torch.int32, device=theta0.device)
    return LbfgsState(
        theta=theta0,
        f=f0,
        grad=g0,
        s_hist=theta0.new_zeros((m, b, p)),
        y_hist=theta0.new_zeros((m, b, p)),
        rho=theta0.new_zeros((m, b)),
        iteration=0,
        converged=torch.zeros((b,), dtype=torch.bool, device=theta0.device),
        n_iters=torch.zeros((b,), **i32),
        prev_step=torch.full((b,), config.init_step, dtype=theta0.dtype,
                             device=theta0.device),
        floor_count=torch.zeros((b,), **i32),
        ftol_count=torch.zeros((b,), **i32),
        status=torch.zeros((b,), **i32),
        precond=precond,
    )


def to_result(state: LbfgsState) -> LbfgsResult:
    return LbfgsResult(
        theta=state.theta,
        f=state.f,
        grad_norm=state.grad.abs().amax(dim=-1),
        converged=state.converged,
        n_iters=state.n_iters,
        status=state.status,
    )


def _body(fun, fun_value, fan_value, state: LbfgsState,
          config: SolverConfig) -> LbfgsState:
    """One iteration for every series (the JAX package's while-loop body)."""
    b = state.theta.shape[0]
    m = config.history
    direction = _two_loop_direction(state, m)
    # Descent safeguard: a non-descent two-loop direction (stale or
    # indefinite history) falls back to preconditioned steepest descent.
    pgrad = state.precond * state.grad
    dg = _dot(direction, state.grad)
    bad = dg >= 0
    direction = torch.where(bad[:, None], -pgrad, direction)
    dg = torch.where(bad, -_dot(pgrad, state.grad), dg)

    # --- batched-fan Armijo line search -----------------------------------
    k_steps = config.ls_max_steps
    # Seed from the last accepted step (grown 4x, capped at init_step).
    step0 = (
        torch.clamp(state.prev_step * 4.0, max=config.init_step)
        if config.ls_seed_prev
        else torch.full_like(state.prev_step, config.init_step)
    )
    shrinks = config.ls_shrink ** torch.arange(
        k_steps, dtype=state.f.dtype, device=state.f.device)
    ladder = step0[None, :] * shrinks[:, None]  # (K, B)

    gnorm = torch.linalg.vector_norm(pgrad, dim=-1)
    tiny = 1e-3 / torch.clamp(gnorm, min=1.0)
    fb_theta = state.theta - tiny[:, None] * pgrad

    if fan_value is not None:
        # Closed-form ladder: no (K, B, P) trial stack.  The fallback row
        # is one direct evaluation, always made: it is used only where no
        # rung was accepted, so evaluating it everywhere changes nothing.
        f_trials = fan_value(state.theta, direction, ladder)  # (K, B)
        fb_f = fun_value(fb_theta)
    else:
        trials = torch.cat([
            state.theta[None] + ladder[:, :, None] * direction[None],
            fb_theta[None],
        ], dim=0)  # (K+1, B, P)
        f_all = fun_value(trials)  # (K+1, B)
        f_trials, fb_f = f_all[:k_steps], f_all[k_steps]

    ok = torch.isfinite(f_trials) & (
        f_trials <= state.f[None] + config.ls_armijo_c1 * ladder * dg[None]
    )  # (K, B)
    accepted = ok.any(dim=0)
    # First True = largest accepted step (argmax of an integer cast: the
    # first maximal index).
    first = torch.argmax(ok.to(torch.int32), dim=0)[None]
    step_out = ladder.gather(0, first)[0]
    new_theta = torch.where(accepted[:, None],
                            state.theta + step_out[:, None] * direction,
                            state.theta)
    new_f = torch.where(accepted, f_trials.gather(0, first)[0], state.f)

    # Ladder exhausted: tiny gradient step.
    use_fb = ~accepted & torch.isfinite(fb_f) & (fb_f < state.f)
    new_theta = torch.where(use_fb[:, None], fb_theta, new_theta)
    new_f = torch.where(use_fb, fb_f, new_f)
    moved = accepted | use_fb

    # Freeze converged series.
    active = ~state.converged
    new_theta = torch.where(active[:, None], new_theta, state.theta)
    new_f = torch.where(active, new_f, state.f)

    _, new_grad = fun(new_theta)

    # --- history update ----------------------------------------------------
    s_vec = new_theta - state.theta
    y_vec = new_grad - state.grad
    sy = _dot(s_vec, y_vec)
    valid = (sy > 1e-12) & moved & active
    rho_new = torch.where(valid, 1.0 / torch.clamp(sy, min=1e-30), 0.0)
    slot = state.iteration % m
    # In place: run_segment owns these (it copies the caller's ring once).
    state.s_hist[slot] = torch.where(valid[:, None], s_vec, 0.0)
    state.y_hist[slot] = torch.where(valid[:, None], y_vec, 0.0)
    state.rho[slot] = rho_new

    # --- convergence ---------------------------------------------------------
    f_decrease = (state.f - new_f) / torch.clamp(state.f.abs(), min=1.0)
    g_inf = new_grad.abs().amax(dim=-1)
    # Float32 noise floor: decreases below a few ulps of the objective for
    # several consecutive iterations mean the series is stationary in this
    # precision.
    eps = torch.finfo(state.f.dtype).eps
    at_floor = moved & (f_decrease <= config.floor_ulps * eps)
    floor_count = torch.where(
        active, torch.where(at_floor, state.floor_count + 1, 0),
        state.floor_count).to(torch.int32)
    hit_gtol = g_inf < config.gtol
    # ftol needs PATIENCE: only ftol_patience CONSECUTIVE sub-tol
    # iterations end the solve.
    sub_ftol = moved & (f_decrease < config.tol)
    ftol_count = torch.where(
        active, torch.where(sub_ftol, state.ftol_count + 1, 0),
        state.ftol_count).to(torch.int32)
    hit_ftol = ftol_count >= config.ftol_patience
    hit_floor = floor_count >= config.floor_patience
    newly = active & (hit_gtol | hit_ftol | hit_floor | ~moved)
    status_new = torch.where(
        hit_gtol, STATUS_GTOL,
        torch.where(hit_ftol, STATUS_FTOL,
                    torch.where(hit_floor, STATUS_FLOOR, STATUS_STALLED)),
    ).to(torch.int32)
    status = torch.where(active & newly, status_new, state.status)

    prev_step = torch.where(accepted & active,
                            torch.clamp(step_out, min=2.0 ** -16),
                            state.prev_step)

    return LbfgsState(
        theta=new_theta,
        f=new_f,
        grad=torch.where(active[:, None], new_grad, state.grad),
        s_hist=state.s_hist,
        y_hist=state.y_hist,
        rho=state.rho,
        iteration=state.iteration + 1,
        converged=state.converged | newly,
        n_iters=state.n_iters + active.to(torch.int32),
        prev_step=prev_step,
        floor_count=floor_count,
        ftol_count=ftol_count,
        status=status,
        precond=state.precond,
    )


def run_segment(
    fun: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    state: LbfgsState,
    config: SolverConfig,
    num_iters: Optional[int] = None,
    fun_value: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    fan_value=None,
) -> LbfgsState:
    """Advance the solver by up to ``num_iters`` iterations (bounded by
    ``config.max_iters`` overall).

    Resumable: feeding the returned state back continues the EXACT same
    trajectory as one long run — history ring, per-series convergence
    masks and line-search step memory all carry across segments.

    ``fun_value``: value-only objective for line-search trials, taking
    (B, P) or a stack (N, B, P) -> (B,) or (N, B).  ``fan_value``:
    optional ``(theta, direction, ladder (K, B)) -> (K, B)`` closed-form
    ladder losses (linear growth: ``loss.fan_value_closed_form``).
    The loop never runs past ``config.max_iters``; it reads the converged
    mask at entry and every ``SYNC_EVERY`` iterations.
    """
    if fun_value is None:
        def fun_value(th):
            if th.ndim == 2:
                return fun(th)[0]
            return torch.stack([fun(t)[0] for t in th])
    stop_at = min(state.iteration
                  + (config.max_iters if num_iters is None else num_iters),
                  config.max_iters)
    if state.iteration >= stop_at or bool(state.converged.all()):
        return state
    # The body updates the history ring in place; the caller's stays put.
    state = state._replace(s_hist=state.s_hist.clone(),
                           y_hist=state.y_hist.clone(),
                           rho=state.rho.clone())
    while state.iteration < stop_at:
        t0 = time.perf_counter()
        state = _body(fun, fun_value, fan_value, state, config)
        timing.body_s += time.perf_counter() - t0
        timing.iters += 1
        if (state.iteration % SYNC_EVERY == 0
                and bool(state.converged.all())):
            break
    return state


def take_state(state: LbfgsState, idx) -> LbfgsState:
    """Gather a row subset of a solver state: the compaction primitive.

    ``idx`` indexes the series axis — axis 0 for the (B, ...) leaves,
    axis 1 for the (M, B, P)/(M, B) history ring; the shared iteration
    counter is carried as-is.  Every per-series quantity is row-local, so
    a gathered state continues each selected series' trajectory bitwise
    identically to the full-width solve.
    """
    idx = torch.as_tensor(idx, device=state.theta.device)
    t0 = lambda a: a.index_select(0, idx)  # noqa: E731
    t1 = lambda a: a.index_select(1, idx)  # noqa: E731
    return LbfgsState(
        theta=t0(state.theta),
        f=t0(state.f),
        grad=t0(state.grad),
        s_hist=t1(state.s_hist),
        y_hist=t1(state.y_hist),
        rho=t1(state.rho),
        iteration=state.iteration,
        converged=t0(state.converged),
        n_iters=t0(state.n_iters),
        prev_step=t0(state.prev_step),
        floor_count=t0(state.floor_count),
        ftol_count=t0(state.ftol_count),
        status=t0(state.status),
        precond=t0(state.precond),
    )


def minimize(
    fun: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    theta0: torch.Tensor,
    config: SolverConfig = SolverConfig(),
    fun_value: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    precond: Optional[torch.Tensor] = None,
    fan_value=None,
) -> LbfgsResult:
    """Minimize a batch of independent objectives with shared compute.

    Args:
      fun: (B, P) -> ((B,) per-series losses, (B, P) per-series grads).
      theta0: (B, P) initial parameters.
      fun_value: optional value-only objective for line-search trials
        (defaults to ``fun(th)[0]``, which wastes the gradient).
      precond: optional (B, P) inverse-curvature diagonal (initial metric).
      fan_value: optional closed-form ladder evaluator (see run_segment).

    Returns:
      LbfgsResult with per-series optimum, loss, grad inf-norm, convergence
      flag and iteration count.
    """
    return to_result(
        run_segment(
            fun, init_state(fun, theta0, config, precond), config,
            fun_value=fun_value, fan_value=fan_value,
        )
    )
