#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--seed N]

Every phase runs, each printing one JSON line; any failure raises and
the script exits non-zero without printing the final line:

1. device  — card name, ``nvidia-smi`` name and power limit, kernel
   build time (every CUDA source built from ``tsspark_tpu_torch/csrc``).
2. forward — kernel K1 against its plain PyTorch version on the card
   (B=2048, T=1969, 25 changepoints, 26 Fourier columns; shared and
   per-series features, 3 regressors; linear, flat and logistic growth).
3. bands   — kernel K2 against its plain version: first on given draws
   (B=1024, T=32, S=256, and S of 1,000 to 65,536 on a few rows, past
   one block into the device-memory scratch path; equal to float32
   tolerance), then on its own Philox draws against the plain version's
   generator (Monte-Carlo bounds on the yhat bands, where the normal
   draws dominate, and on the trend bands of a horizon where simulated
   changepoints dominate), and lo <= hi everywhere; then its own draws at
   S=65,536 on 1,024 rows x 32 steps (finite, ordered, the yhat bands
   against the plain version on 16 rows on the CPU, rows bitwise
   invariant).  Then K2's logistic branch (its offset recursion carried
   along the steps) against the plain scan: on given draws at config
   4's forecast shape (1,024 rows x 1,200 steps, S=256), there again
   with rates near 0 (``rates_near_zero``: the offset recursion's
   ill-conditioned case), and at S=65,536 on a few rows, and on its
   Philox draws against the plain version's generator (Monte-Carlo
   bounds on the yhat and the trend bands).
4. loss    — kernel K3 against its plain version (B=1024, T=1746, config
   3's widths, and config 4's): value and gradient modes, linear, flat
   and logistic growth (rates clear of 0, ``logistic_theta``, and on
   config 4 also near 0, ``rates_near_zero``), additive and
   multiplicative features, shared and per-series seasonal matrices,
   with and without regressors, a stack of trial points, and a 21-trial
   stack (the trial-stack layout) whose every trial holds the bits of
   its launch alone; near 0 also K3's and the plain float32 gradient's
   distances from the plain version in float64.
5. fan     — kernel K4 against its plain version on the same cases
   (linear growth, a 20-rung ladder).
6. serve   — the serving path at full width: ``m5_like(30490, 1941)``
   prepared under the default ``ProphetConfig`` (26 Fourier columns, 25
   changepoints, 256 samples), parameters drawn from ``--seed``,
   published into a parameter registry and served by a
   ``PredictionEngine`` on the card: four requests (all series
   deterministic, 4,096 sampled, all sampled, a cached repeat) and one
   in-sample + 28-day ``backend.predict`` over the shared calendar.
   Kernel launch counts are set to 0 just before and read just after.
   Then a profile of requests (a) and (c) on a cacheless engine: device
   busy time from ``torch.profiler``, host time per stage from the
   engine's and the backend's own stage clocks.
7. fit     — the fit path at full width: eval config 3
   (``eval/configs.py``: ``m5_like(30490, 1941)`` with its holiday,
   price and promo regressors, yearly order 8 + weekly order 3, 25
   changepoints, ``SolverConfig(max_iters=120)``) fitted on the first
   1,746 days of every series through ``CudaBackend.fit`` on the card,
   then forecast over all 1,941 days through K1 and scored (sMAPE on
   train and holdout).  Launch counts (K3 per mode) set to 0 just
   before, read just after.  Stage split, iterations, status counts, host time per solver
   iteration, peak memory, and the device-idle share of one chunk's solve
   under ``torch.profiler``.  Then parity on a 128-series subset: sMAPE
   against the port's scipy oracle (``backends/cpu.py``), and the loss
   against that oracle and the port's own plain fit on the CPU, on
   average and per series (``loss_parity``).
8. mcmc    — the full-posterior path on config 3's batch (phase fit's)
   at full width: ``ProphetModel.fit_mcmc`` with ``McmcConfig()`` (the
   MAP fit, then 300 warmup and 300 kept transitions of 24 leapfrog
   steps, one chain a series, K3 under every step), then
   ``predict_mcmc`` over all 1,941 days (K6, a launch per 512 rows).
   Launch counts set to 0 just before, read just after; stage split,
   wall a leapfrog, acceptance, divergences, split-R-hat and ESS, sMAPE
   of the posterior mean, the band's holdout coverage, peak memory.
   Then K3 and its plain version give a non-finite loss at the same
   points far from the MAP; the sampler on 64 series against the same
   sampler driven by the plain loss (other seeds; z rule, ``Z_LIMIT``);
   K6 against its plain version on given draws (small shapes of linear,
   flat and logistic growth, both thread caps, one draw, no feature and
   more than 32; the path's first 512-row chunk) and its rows bitwise
   invariant; eight full-width transitions under the
   profiler (the card's idle share).
9. fit_logistic — logistic growth's path: eval config 4 at 8,192
   series (``config4_wiki_logistic(scale=1024)``'s batch: 1,200 days,
   capacity, weekly multiplicative order 3, 15 changepoints,
   ``SolverConfig(max_iters=200)``) fitted on its first 1,080 days
   through ``CudaBackend.fit`` (K3's logistic branch, its line search a
   stacked value pass through K3's trial-stack layout, whose own launch
   count must be non-zero), then ``predict(..., cap=, num_samples=256)``
   over all 1,200 days (K1, K2's logistic branch).  Launch counts set to
   0 just before, read just after; stage split, status counts, sMAPE on
   train and holdout, bands ordered; loss parity on 64 series against
   the scipy oracle and the plain CPU fit (``LIMITS4``).
10. stream5 — continuous refit, eval config 5 at its published scale
   (``eval/configs.py`` ``config5_run``: 50 daily series x 730 days, a
   510-day base batch and three 73-day micro-batches, weekly order 3,
   10 changepoints, ``SolverConfig(max_iters=60)``) through
   ``StreamingForecaster`` on the card: the runner's throwaway pass,
   the warm run, the cold run and a replay of the last micro-batch; the
   runner's whole dict.  Held against the port's plain CPU run of the
   same schedule: equal counts, each series' forecast sMAPE within
   ``STREAM_SMAPE_TOL``, which a planted fault fails; the replay
   idempotent.  K3 (both modes) and K4 on its 50-series chunk by
   GAP_RULE, off the optimum (``hold_stream_kernels``: one dropped cell
   must fail there), and K1 on its 50 x 14 forecast chunk, against their
   plain versions.  The JAX package's recorded CPU reading beside it.
11. stream_fleet — the same generator, model and schedule at the M5
   fleet's 30,490 series: the warm run, a replay of its last
   micro-batch, the cold run; per micro-batch its wall, the driver's and
   the backend's stages, warm and cold starts and K3/K4 launches (counts
   set to 0 just before each, read just after); the forecasts' sMAPE
   (K1), one 256-sample forecast (K2), K3 (both modes), K4, K1 and K2
   against their plain versions at the path's shapes (K3 and K4 as in
   stream5, on the fleet's 8,192-row chunk), one warm chunk's solve
   under the profiler; the 64-series subset's forecasts against the same
   series streamed on the CPU plain path, and the replay's against the
   warm run's, per series in units of the noise (``FLEET_NOISE_TOL``,
   which a planted fault fails).
12. uncertainty — the uncertainty tier at the M5 fleet's width (the JAX
   package's calibration recipe): serve's ``m5_like(30490, 1941)`` batch
   under ``ProphetConfig()`` with the last 28 days withheld, the MAP fit
   (``CudaBackend.fit``, ``SolverConfig(max_iters=25)``), ``publish``,
   ``fit_advi`` at ``AdviConfig()`` (200 steps: K3's gradient on the
   121,960-row draw stack in its draw-stack layout, required on every
   step, and K7), ``save_posterior``, the ADVI-mode
   quantile plane (``qplane.maybe_publish``), ``evaluate_version`` on the
   held-out days, 200 reads through ``PredictionEngine.quantiles``, 512
   MAP-mode reads of a version without a posterior (K1), and
   ``gold.audit_version`` (8 rows, ``McmcConfig()``).  Launch counts set
   to 0 just before, read just after.  Then the path's ADVI loop replayed
   step by step (the same bits): K3 on the first and last steps' whole
   draw stacks, each draw the bits of its rows' row-layout launch alone,
   and on their first 512 series x 4 draws by GAP_RULE against the plain
   version (a dropped cell must fail), K7 bitwise against its plain
   version at both steps; the plane bitwise
   against ``compute_rows`` on 512 rows and ordered and finite over all;
   the card's ADVI against the plain CPU path on 64 series with the same
   MAP theta and draws (``ADVI_PARITY``, which two planted faults fail);
   walls, ms a step (K3, K7, the rest), the idle share of five steps,
   coverage per bucket, read latency, the audit's qdiv, R-hat and ESS.
13. kernels — each kernel at its main path's shapes, on the main path's
   inputs (K3 and K4 at 8192x1746 on config 3's first chunk; K3's
   logistic branch at 8192x1080; K3's trial-stack layout on config 4's
   21 x 8192 line-search stack and on one of flat growth over config 3's
   chunk, each trial the bits of its launch alone; K1's and
   K2's (S=256) on the forecast's 512-row chunks of 1,200 steps and over
   all 8,192 rows, on config 4's), held against its plain version, and
   its time against its bound, its plain version and (where one exists)
   one PyTorch call; K3 (both modes, both growths) and K4 give a row the
   same bits alone, permuted and in a trial stack; K1 (all three shapes) and
   K2 (its own Philox draws, each row keeping its Philox coordinate, both
   growths) alone and permuted; K6 from phase mcmc.  K1-K4 gain their
   launches on the two streaming paths; K3 the ADVI draw stack's time,
   bound and gaps, and K7's entry joins from phase uncertainty.

The CPU parity fits of phases fit and fit_logistic (the scipy oracle and
the port's plain fit on their subsets) and the CPU streaming runs of
phases stream5 and stream_fleet run in two worker processes
(``ParityFits``), started with the data before phase forward, beside the
card's phases; each phase waits for its own.  Phase uncertainty hands the
pool its CPU ADVI fit once its MAP fit is done.

The last lines: the run's wall time, the kernels JSON object,
``nvidia-smi``'s ``name, power.limit`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory
# bandwidth, and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Its 132 multiprocessors at the 1.98 GHz boost clock of that float32 peak
# (132 x 128 lanes x 2 x 1.98e9), at the CUDA programming guide's rates a
# multiprocessor for compute capability 9.0: 64 32-bit integer multiplies
# and 16 special-function operations (log2, rsqrt, sin, cos) a clock.
PEAK_INT32_MUL_PER_S = 132 * 64 * 1.98e9
PEAK_SFU_PER_S = 132 * 16 * 1.98e9

FULL_SERIES = 30490
FULL_DAYS = 1941
HORIZON = 28


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` in ms, the host's launch cost left out:
    the card first sleeps (~30 ms of its clock) while the host enqueues
    ``iters`` calls between two events, which then bracket the calls run
    back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def random_theta(rng, b: int, config) -> np.ndarray:
    """Parameters at fitted-like magnitudes, in scaled units."""
    theta = np.empty((b, config.num_params), np.float32)
    ncp = config.n_changepoints
    theta[:, 0] = rng.normal(0.3, 0.3, b)
    theta[:, 1] = rng.uniform(0.2, 0.6, b)
    theta[:, 2] = np.log(rng.uniform(0.03, 0.1, b))
    theta[:, 3:3 + ncp] = rng.laplace(0.0, 0.05, (b, ncp))
    theta[:, 3 + ncp:] = rng.normal(0.0, 0.05, (b, config.num_features))
    return theta


def logistic_theta(rng, b: int, config) -> np.ndarray:
    """``random_theta`` with k in [1, 2], so every rate k_j = k + delta_0
    + ... + delta_j is clear of 0: a growing logistic trend, as fitted
    series have.  ``rates_near_zero`` holds the other case."""
    theta = random_theta(rng, b, config)
    theta[:, 0] = rng.uniform(1.0, 2.0, b)
    return theta


def rates_near_zero(rng, b: int, config) -> np.ndarray:
    """``random_theta`` with k ~ N(0, 0.05), so the rates k_j cross 0 on
    most rows, where the logistic offset recursion is ill-conditioned in
    float32 (ROADMAP, Queue 3); row 0 has k and every delta 0."""
    theta = random_theta(rng, b, config)
    theta[:, 0] = rng.normal(0.0, 0.05, b)
    theta[0, 0] = 0.0
    theta[0, 3:3 + config.n_changepoints] = 0.0
    return theta


def synthetic_data(rng, config, b: int, t_len: int, per_series: bool,
                   device):
    """FitData at a given shape: t over [0, 1.2], sorted changepoints in
    [0, 0.8], Fourier-like features, capacity above the trend."""
    import torch

    from tsspark_tpu_torch.models.prophet.design import FitData

    f32 = np.float32
    t = np.broadcast_to(np.linspace(0.0, 1.2, t_len, dtype=f32),
                        (b, t_len))
    s = np.sort(rng.uniform(0.0, 0.8, (b, config.n_changepoints)),
                axis=1).astype(f32)
    fs = config.num_seasonal_features
    xs_shape = (b, t_len, fs) if per_series else (t_len, fs)
    xs = rng.uniform(-1.0, 1.0, xs_shape).astype(f32)
    xr = rng.normal(0.0, 1.0, (b, t_len, config.num_regressors)).astype(f32)
    cap = rng.uniform(1.5, 3.0, (b, 1)).astype(f32) * np.ones((1, t_len), f32)
    mm = np.asarray([1.0 if m else 0.0 for m in config.feature_modes()], f32)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    zeros = torch.zeros((b, t_len), device=device)
    return FitData(
        t=dev(t), y=zeros, mask=zeros, s=dev(s), cap=dev(cap),
        X_season=dev(xs), X_reg=dev(xr),
        prior_scales=dev(np.ones(config.num_features, f32)),
        mult_mask=dev(mm),
    )


def trend_ops(config) -> tuple:
    """Float32 operations of the trend, (a cell, a row).  t rises along a
    row, so a cell takes its segment's line (linear: one multiply-add) or
    its rate and offset (logistic: rate (t - off), the sigmoid's
    exponential, add and reciprocal, the capacity) in O(1); the prefix
    sums over the changepoints (linear) or the offset recursion
    (logistic, ~8 a step) are taken once a row.  Flat growth's trend is
    m: none."""
    ncp = config.n_changepoints
    return {"flat": (0, 0), "linear": (2, 3 * ncp),
            "logistic": (6, 8 * ncp)}[config.growth]


def forward_bound_ms(b, t_len, config, per_series, rescale) -> dict:
    """Least time for one forward launch: each input read once, each
    output written once, against the float32 operation count."""
    ncp, fs, r = (config.n_changepoints, config.num_seasonal_features,
                  config.num_regressors)
    f = fs + r
    floats = b * config.num_params + b * t_len + b * ncp + f \
        + (b if per_series else 1) * t_len * fs + b * t_len * r \
        + 4 * b * t_len
    if config.growth == "logistic":
        floats += b * t_len
    if rescale:
        floats += 2 * b
    trend_cell, trend_row = trend_ops(config)
    ops_cell = 4 * f + 3 + (5 if rescale else 0) + trend_cell
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    t_ops = b * (t_len * ops_cell + trend_row) / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bands_bound_ms(b, t_len, s, config, given_draws=False) -> dict:
    """Least time for one bands launch: bytes of the (B, T) inputs and
    outputs (and of the (S, B, T) draws when given), against the float32
    operations the function needs at each cell: ~20 per sample for the
    simulation (variate generation not counted; logistic growth ~30: the
    offset recursion's step and the sigmoid) and a selection of the
    two order statistics of each column, O(S) — counted as 2 per sample
    per column.  The kernel's bitonic sort is its design's cost, not the
    function's, and is not counted."""
    logistic = config.growth == "logistic"
    floats = 8 * b * t_len + b * config.num_params + 2 * b
    if logistic:
        floats += b * t_len + b * config.n_changepoints  # cap, s
    if given_draws:
        floats += 3 * s * b * t_len
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    sim = 30 if logistic else 20
    t_ops = b * t_len * s * (sim + 2 * 2) / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bands_variates_bound_ms(b, t_len, s, config) -> dict:
    """``bands_bound_ms`` with the variates K2 must draw counted too: one
    Philox4x32-10 draw a sample-cell, 10 rounds of two 32x32-bit products
    each taken as a low and a high multiply (40 integer multiplies), at
    the integer multiply rate; and four transcendentals a sample-cell (the
    Laplace draw's log, Box-Muller's log, square root and cosine) at the
    special-function rate (five under logistic growth: the sigmoid's
    exponential).  The units run side by side, so the least time is the
    largest of the bytes, float32, integer and special-function times."""
    base = bands_bound_ms(b, t_len, s, config)
    cells = b * t_len * s
    sfu = 5 if config.growth == "logistic" else 4
    times = {
        "bytes_or_float32": base["bound_ms"],
        "integer_multiplies": cells * 40 / PEAK_INT32_MUL_PER_S * 1e3,
        "transcendentals": cells * sfu / PEAK_SFU_PER_S * 1e3,
    }
    by = max(times, key=times.get)
    return {"bound_with_variates_ms": times[by],
            "bound_with_variates_by": by,
            "bound_with_variates_parts_ms": times}


def loss_bound_ms(n_rows, b, t_len, config, grad) -> dict:
    """Least time for one K3 launch: t, y, mask (and cap under logistic
    growth) and the regressor columns of every cell, the shared seasonal
    matrix, changepoints and parameters read once, f (and g) written once;
    against the float32 operations of the loss (``trend_ops``, features,
    residual, sums; the priors once a row) and, in gradient mode, of the
    2 + n_cp + F gradient sums: the changepoints' as suffix sums of the
    trend's own (linear: sum u, sum u t; logistic: the sigmoid's slope
    and two sums a cell), taken once a row at the boundaries (logistic:
    then the recursion's pull-back).  A stack of trial rows (n_rows =
    N * b) reads the data once."""
    ncp, fs, r = (config.n_changepoints, config.num_seasonal_features,
                  config.num_regressors)
    f, p = fs + r, config.num_params
    logistic = config.growth == "logistic"
    floats = (3 + r + logistic) * b * t_len + t_len * fs + b * ncp + 2 * f \
        + n_rows * p + n_rows * (1 + (p if grad else 0))
    trend_cell, trend_row = trend_ops(config)
    ops_cell = trend_cell + 4 * f + 3 + 4
    ops_row = trend_row + 5 * ncp + 3 * f
    if grad:
        ops_cell += 5 + 3 + 5 * f + (8 if logistic else 0)
        ops_row += {"flat": 0, "linear": 3, "logistic": 15}[
            config.growth] * ncp
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    t_ops = n_rows * (t_len * ops_cell + ops_row) / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fan_bound_ms(b, t_len, k_steps, config) -> dict:
    """Least time for one K4 launch: the row data as K3 reads it, theta,
    the direction and the (K, B) ladder read once, (K, B) written once;
    against the float32 operations of two forward passes (``trend_ops``)
    and the six sums per cell, and O(n_cp) per rung."""
    ncp, fs, r = (config.n_changepoints, config.num_seasonal_features,
                  config.num_regressors)
    f, p = fs + r, config.num_params
    floats = (3 + r) * b * t_len + t_len * fs + b * ncp + 2 * f \
        + 2 * b * p + 2 * k_steps * b
    trend_cell, trend_row = trend_ops(config)
    ops_cell = 2 * trend_cell + 2 * 4 * f + 26
    ops = b * (t_len * ops_cell + 2 * trend_row) \
        + k_steps * b * (30 + 4 * ncp)
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _xmax(data):
    """(B, T) largest |feature| of each cell (shared or per-series)."""
    import torch

    xs = data.X_season.abs()
    xs = xs.amax(-1) if xs.shape[-1] else xs.new_zeros(xs.shape[:-1])
    xs = xs if xs.ndim == 2 else xs[None].expand(data.t.shape)
    if data.X_reg.shape[-1]:
        xs = torch.maximum(xs, data.X_reg.abs().amax(-1))
    return xs


def _pullback_gain(p, s):
    """(B,) first-order gain of logistic growth's pull-back through the
    offset recursion (kernels/loss.py ``_logistic_pullback``): it adds
    sum_j ggamma_j dgamma_j/d(k, m, delta) to the gradient, so an error e
    in each of its sums ggamma_j moves the gradient by at most
    e * sum_j,i |dgamma_j/dtheta_i|, taken by float64 autograd of the
    plain recursion (``trend._logistic_gamma``)."""
    import torch

    from tsspark_tpu_torch.models.prophet import trend as tr

    k, m, delta = (x.detach().double().requires_grad_()
                   for x in (p.k, p.m, p.delta))
    gamma = tr._logistic_gamma(k, m, delta, s.double())
    gain = torch.zeros_like(k)
    for j in range(gamma.shape[-1]):
        gk, gm, gd = torch.autograd.grad(gamma[:, j].sum(), (k, m, delta),
                                         retain_graph=True)
        gain = gain + gk.abs() + gm.abs() + gd.abs().sum(-1)
    return gain.to(p.k.dtype)


def loss_scales(theta, data, config):
    """Per row, the sums of |terms| that K3's sums add: (f scale, g scale).
    A float32 sum of T terms in any order is within T * eps of its
    |terms| sum, so T * eps * scale bounds a kernel-vs-plain gap.  Under
    logistic growth the gradient adds the sums of |v (t - off)| and
    |v rate| (v = df/dx), carried through the offset recursion's
    pull-back at its first-order gain."""
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels.loss import SIGMA_FLOOR

    yhat, g, _, mult = fk.forward_plain(theta, data, config)
    sigma = SIGMA_FLOOR + (theta[:, 2]).exp()
    r = (data.y - yhat) * data.mask
    ssr = (r * r).sum(-1) / (sigma * sigma)
    w = (r * data.mask).abs() / (sigma * sigma)[:, None]
    n_log = (data.mask.sum(-1) * sigma.log()).abs()
    f_scale = 1.0 + 0.5 * ssr + n_log
    g_scale = 1.0 + ssr + n_log \
        + (w * (1.0 + mult.abs()) * (1.0 + data.t.abs())).sum(-1) \
        + (w * (1.0 + g.abs()) * _xmax(data)).sum(-1)
    if config.growth == "logistic":
        from tsspark_tpu_torch.models.prophet import trend as tr
        from tsspark_tpu_torch.models.prophet.params import unpack

        p = unpack(theta, config)
        rate = p.k[:, None] + tr.step_weighted_sum(p.delta, data.t, data.s)
        gamma = tr._logistic_gamma(p.k, p.m, p.delta, data.s)
        off = p.m[:, None] + tr.step_weighted_sum(gamma, data.t, data.s)
        sig = (rate * (data.t - off)).sigmoid()
        v = w * (1.0 + mult.abs()) * data.cap.abs() * sig * (1.0 - sig)
        terms = (v * ((data.t - off).abs() + rate.abs())).sum(-1)
        g_scale = g_scale + terms * (
            1.0 + _pullback_gain(p, data.s))
    return f_scale, g_scale


def fan_scale(theta, direction, ladder, data, config):
    """(K, B) sums of |terms| of the fan's expanded loss at each rung (see
    ``loss_scales``), from the plain version's own per-cell terms."""
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels.loss import SIGMA_FLOOR

    r0, c1, c2, p0, pd = fan_k.ray_terms(theta, direction, data, config)
    s = ladder.abs()
    sums = [(a * b).abs().sum(-1)[None] for a, b in (
        (r0, r0), (r0, c1), (r0, c2), (c1, c1), (c1, c2), (c2, c2))]
    poly = sums[0] + 2 * s * sums[1] + s * s * (sums[3] + 2 * sums[2]) \
        + 2 * s ** 3 * sums[4] + s ** 4 * sums[5]
    sigma = SIGMA_FLOOR + (p0.log_sigma[None]
                           + ladder * pd.log_sigma[None]).exp()
    n_log = (data.mask.sum(-1)[None] * sigma.log()).abs()
    return 1.0 + 0.5 * poly / (sigma * sigma) + n_log


# K3 and K4 against their plain versions: T * eps * sum|terms| is the
# worst-case float32 error of a T-term sum taken in another order; the two
# stay within 0.2% of it on the card (PERF.md), so 5% leaves margin and
# still catches one wrong cell of a row.
GAP_TOL = 0.05
GAP_RULE = f"|k-p| <= {GAP_TOL} * T*eps*sum|terms| per row"


def _gap(got, want, scale, t_len) -> float:
    """max |k - p| / (T * eps * scale): 1 is the float32 worst case."""
    eps = float(np.finfo(np.float32).eps)
    if got.ndim > scale.ndim:
        scale = scale[..., None]
    return float(((got - want).abs() / (t_len * eps * scale)).max())


def loss_gaps(theta, data, config, pairs) -> dict:
    """K3 against its plain version by ``GAP_RULE``, on ``theta``'s rows
    of ``data``: ``pairs`` maps a name to (kernel output, plain output)
    on one device.  A (B, P) output is a gradient, held to the rows'
    gradient scale; a (n B,) output is a loss, or a stack of n trials on
    those rows, held to the rows' loss scale repeated n times.  Returns
    {name: gap}; K3 is right where every gap is at most ``GAP_TOL``
    (``within_gap_rule``)."""
    f_scale, g_scale = loss_scales(theta, data, config)
    t_len = data.t.shape[-1]
    out = {}
    for name, (got, want) in pairs.items():
        scale = g_scale if got.ndim == 2 else f_scale.repeat(
            got.shape[0] // f_scale.shape[0])
        out[name] = _gap(got, want, scale.to(got.device), t_len)
    return out


def within_gap_rule(gaps: dict) -> bool:
    return max(gaps.values()) <= GAP_TOL


def rel_err(a, b) -> float:
    """max |a - b| / (1 + |b|)."""
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def phase_forward(rng, device) -> dict:
    import dataclasses

    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.kernels import forward as fk

    import torch

    tol = 2e-5  # float32: 25 hinge + 26 feature terms, FMA contraction
    base = ProphetConfig()
    cases = [
        ("linear/shared", base, False),
        ("linear/per-series", base, True),
        ("flat/shared", dataclasses.replace(base, growth="flat"), False),
        ("logistic/per-series",
         dataclasses.replace(base, growth="logistic"), True),
    ]
    with_reg = base
    for name in ("promo", "price", "holiday"):
        with_reg = with_reg.with_regressor(name)
    cases.append(("linear/3-regressors", with_reg, False))
    results = []
    for name, cfg, per_series in cases:
        b, t_len = 2048, 1969
        data = synthetic_data(rng, cfg, b, t_len, per_series, device)
        theta = torch.from_numpy(random_theta(rng, b, cfg)).to(device)
        scale = torch.from_numpy(
            rng.uniform(1.0, 50.0, b).astype(np.float32)).to(device)
        floor = torch.zeros(b, device=device)
        for rescale in (False, True):
            kw = dict(y_scale=scale, floor=floor) if rescale else {}
            got = fk.forward(theta, data, cfg, **kw)
            want = fk.forward_plain(theta, data, cfg, **kw)
            torch.cuda.synchronize()
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            abs_errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            for g in got:
                require(bool(torch.isfinite(g).all()), f"{name} finite")
            require(max(errs) <= tol, f"forward {name} rescale={rescale}: "
                    f"{max(errs)} > {tol}")
            results.append({"case": name, "rescale": rescale,
                            "max_rel_err": max(errs),
                            "max_abs_err": max(abs_errs)})
        ms = cuda_ms(lambda: fk.forward(theta, data, cfg))
        plain_ms = cuda_ms(lambda: fk.forward_plain(theta, data, cfg),
                           iters=3, warmup=1)
        results[-1].update(ms=ms, plain_ms=plain_ms)
    worst = max(r["max_abs_err"] for r in results if not r["rescale"])
    out = {"phase": "forward", "tolerance": f"|k-p|/(1+|p|) <= {tol}",
           "cases": results, "max_abs_err_scaled": worst}
    emit(out)
    return out


def _band_err(got, want, scale) -> float:
    """max over keys and cells of |k - p| / (y_scale + |p|)."""
    return max(float(((got[k] - want[k]).abs()
                      / (scale[:, None] + want[k].abs())).max())
               for k in want)


def _mc_compare(own, ref, lo_key, hi_key, unit) -> dict:
    """Two Monte-Carlo estimates of the same (lo, hi) band, cell by cell,
    in ``unit`` (the spread of what is sampled): the median signed and
    absolute differences, and the median ratio of the band widths."""
    out = {}
    for k in (lo_key, hi_key):
        d = (own[k] - ref[k]) / unit
        out[k] = {"median": float(d.median()),
                  "median_abs": float(d.abs().median())}
    width = own[hi_key] - own[lo_key]
    out["width_ratio_median"] = float(
        (width / (ref[hi_key] - ref[lo_key])).median())
    return out


def _require_mc(mc, lo_key, hi_key, what) -> None:
    for k in (lo_key, hi_key):
        require(abs(mc[k]["median"]) <= 0.05, f"{what} MC bias {k}")
        require(mc[k]["median_abs"] <= 0.3, f"{what} MC spread {k}")
    require(abs(mc["width_ratio_median"] - 1.0) <= 0.03,
            f"{what} MC band width ratio {mc['width_ratio_median']}")


def phase_bands(rng, device) -> dict:
    import torch

    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk

    cfg = ProphetConfig()
    tol = 1e-5

    def inputs(b, t_np, c=cfg, theta_fn=random_theta):
        t_len = t_np.shape[0]
        data = synthetic_data(rng, c, b, t_len, True, device)
        data = data._replace(t=torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(t_np.astype(np.float32), (b, t_len)))).to(device))
        theta = torch.from_numpy(theta_fn(rng, b, c)).to(device)
        scale = torch.from_numpy(
            rng.uniform(1.0, 50.0, b).astype(np.float32)).to(device)
        floor = torch.zeros(b, device=device)
        _, det, add, mult = fk.forward(theta, data, c)
        return theta, data, det, add, mult, scale, floor

    def on_cpu(args):
        theta, data, *rest = args
        return (theta.cpu(), data._replace(
            **{f: getattr(data, f).cpu() for f in data._fields}),
            *(x.cpu() for x in rest))

    # Engine-like grid: the horizon steps just past the history.
    b, t_len, s = 1024, 32, 256
    eng_t = 1.0 + np.arange(1, t_len + 1) / 1940.0
    args = inputs(b, eng_t)
    theta, data, det, add, mult, scale, floor = args
    gen = torch.Generator(device=device).manual_seed(7)
    draws = bk.sample_draws((s, b, t_len), gen, device)
    got = bk.bands(*args, cfg, s, draws=draws)
    want = bk.bands_plain(*args, cfg, draws)
    torch.cuda.synchronize()
    given = {k: float(((got[k] - want[k]).abs()
                       / (scale[:, None] + want[k].abs())).max())
             for k in want}
    require(max(given.values()) <= tol, f"bands given-draws: {given}")
    # Sample counts past one thread per sample (several per thread), past
    # one block (the device-memory scratch path) and past the 16,384 one
    # block held before, on a few rows.
    wide = {}
    for n_s in (1000, 3000, 16384, 16385, 65536):
        wargs = inputs(16, eng_t[:8])
        wdraws = bk.sample_draws((n_s, 16, 8), gen, device)
        e = _band_err(bk.bands(*wargs, cfg, n_s, draws=wdraws),
                      bk.bands_plain(*wargs, cfg, wdraws), wargs[5])
        wide[n_s] = e
        require(e <= tol, f"bands given-draws S={n_s}: {e} > {tol}")
    # Own Philox draws against the plain version's generator: two
    # Monte-Carlo estimates of the same quantiles.  In units of the
    # spread of what is sampled, the standard error of one 10% / 90%
    # quantile estimate at S=256 is ~0.11 and of a difference of two
    # ~0.15; the median signed difference over cells must be near 0, the
    # median absolute one near 0.1, and the median ratio of band widths
    # near 1 (its standard error over 1,024 rows is ~0.004).
    #   yhat bands on the engine grid: the normal draws dominate, unit
    #   sigma * y_scale.
    own = bk.bands(*args, cfg, s, seed=11)
    ref = {k: v.to(device) for k, v in
           bk.bands(*on_cpu(args), cfg, s, seed=11).items()}
    sigma = torch.exp(theta[:, 2])[:, None] * scale[:, None]
    mc_yhat = _mc_compare(own, ref, "yhat_lower", "yhat_upper", sigma)
    _require_mc(mc_yhat, "yhat_lower", "yhat_upper", "bands yhat")
    for lo, hi in (("yhat_lower", "yhat_upper"),
                   ("trend_lower", "trend_upper")):
        require(bool((own[lo] <= own[hi]).all()), f"{lo} <= {hi}")
        require(bool(torch.isfinite(own[lo]).all()), f"{lo} finite")
    #   trend bands on a horizon of 64 steps of 0.01 (cp_prob ~0.25):
    #   only the Bernoulli and Laplace draws move them.  Unit: the sd of
    #   the simulated trend, sqrt(2 p lam^2 sum_j (t - t_j)^2) * y_scale,
    #   over the later 32 steps (8 or more changepoints expected).
    cp_t = 1.0 + 0.01 * np.arange(1, 65)
    cargs = inputs(b, cp_t)
    own_c = bk.bands(*cargs, cfg, s, seed=12)
    ref_c = {k: v.to(device) for k, v in
             bk.bands(*on_cpu(cargs), cfg, s, seed=12).items()}
    c_theta, c_scale = cargs[0], cargs[5]
    lam = c_theta[:, 3:3 + cfg.n_changepoints].abs().mean(-1)
    tt = torch.from_numpy(cp_t.astype(np.float32)).to(device)
    dt = torch.diff(tt, prepend=tt[:1])
    p_cp = min(max(cfg.n_changepoints * float(dt.mean()), 0.0), 1.0)
    lag2 = torch.clamp(tt[:, None] - tt[None, :], min=0.0) ** 2
    sd = torch.sqrt(2.0 * p_cp * lam[:, None] ** 2 * lag2.sum(-1)[None])
    half = slice(32, None)
    late = lambda d: {k: v[:, half] for k, v in d.items()}  # noqa: E731
    mc_trend = _mc_compare(late(own_c), late(ref_c), "trend_lower",
                           "trend_upper", (sd * c_scale[:, None])[:, half])
    _require_mc(mc_trend, "trend_lower", "trend_upper", "bands trend")
    require(bool((own_c["trend_lower"] <= own_c["trend_upper"]).all()),
            "trend_lower <= trend_upper (changepoint horizon)")
    big = big_sample_run(inputs, on_cpu, cfg, eng_t, device)
    ms = cuda_ms(lambda: bk.bands(*args, cfg, s, seed=3))
    plain_ms = cuda_ms(lambda: bk.bands_plain(*args, cfg, draws),
                       iters=3, warmup=1)
    sim = bk.bands_plain(*args, cfg, draws,
                         return_samples=True)["yhat_samples"]
    qs = torch.tensor([float(q) for q in bk.quantile_points(0.8)],
                      device=device)
    quantile_ms = cuda_ms(lambda: torch.quantile(sim, qs, dim=0))
    del sim
    logistic = bands_logistic(inputs, on_cpu, eng_t, device)
    out = {"phase": "bands", "shape": [b, t_len, s],
           "given_draws_err": given, "given_draws_err_wide_S": wide,
           "tolerance": f"|k-p|/(y_scale+|p|) <= {tol}",
           "monte_carlo_yhat": mc_yhat,
           "monte_carlo_trend": {"cp_prob": p_cp, **mc_trend},
           "philox_65536": big,
           "ms": ms, "plain_ms": plain_ms,
           "torch_quantile_ms": quantile_ms, "logistic": logistic}
    emit(out)
    return out


def fit_grid(days: int, split: int) -> np.ndarray:
    """Scaled times of a fit's calendar forecast whole: the first
    ``split`` days span [0, 1], the rest step on past 1."""
    return np.concatenate([np.linspace(0.0, 1.0, split),
                           1.0 + np.arange(1, days - split + 1)
                           / (split - 1.0)])


def bands_logistic(inputs, on_cpu, eng_t, device) -> dict:
    """K2's logistic branch against its plain version (the scan of
    ``predict._logistic_paths``): on given draws at config 4's forecast
    shape (1,024 rows x 1,200 steps, 120 of them future, S = 256) and at
    S = 65,536 on a few rows (the scratch path), and at the first shape
    with rates near 0 (``rates_near_zero``), within 1e-5; then its
    own Philox draws against the plain version's generator, Monte-Carlo
    bounds as for linear growth: the yhat bands on the engine grid (unit
    sigma * y_scale) and the trend bands over the later half of a 64-step
    changepoint horizon (unit: the plain version's band width over
    2.5631, the width of a normal's 10%-90% band in its sd)."""
    import dataclasses

    import torch

    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.kernels import bands as bk

    cfg = dataclasses.replace(ProphetConfig(), growth="logistic")
    tol = 1e-5
    gen = torch.Generator(device=device).manual_seed(17)
    b, s = 1024, 256
    args = inputs(b, fit_grid(C4_DAYS, 1080), cfg, logistic_theta)
    draws = bk.sample_draws((s, b, C4_DAYS), gen, device)
    given = _band_err(bk.bands(*args, cfg, s, draws=draws),
                      bk.bands_plain(*args, cfg, draws), args[5])
    require(given <= tol, f"bands logistic given-draws: {given} > {tol}")
    del draws
    wargs = inputs(4, fit_grid(1100, 1080)[-40:], cfg, logistic_theta)
    wdraws = bk.sample_draws((65536, 4, 40), gen, device)
    wide = _band_err(bk.bands(*wargs, cfg, 65536, draws=wdraws),
                     bk.bands_plain(*wargs, cfg, wdraws), wargs[5])
    require(wide <= tol, f"bands logistic given-draws S=65536: {wide}")
    del wdraws
    zargs = inputs(b, fit_grid(C4_DAYS, 1080), cfg, rates_near_zero)
    zdraws = bk.sample_draws((s, b, C4_DAYS), gen, device)
    near_zero = _band_err(bk.bands(*zargs, cfg, s, draws=zdraws),
                          bk.bands_plain(*zargs, cfg, zdraws), zargs[5])
    require(near_zero <= tol,
            f"bands logistic given-draws, rates near 0: {near_zero}")
    del zdraws
    eargs = inputs(b, eng_t, cfg, logistic_theta)
    own = bk.bands(*eargs, cfg, s, seed=11)
    ref = {k: v.to(device) for k, v in
           bk.bands(*on_cpu(eargs), cfg, s, seed=11).items()}
    sigma = torch.exp(eargs[0][:, 2])[:, None] * eargs[5][:, None]
    mc_yhat = _mc_compare(own, ref, "yhat_lower", "yhat_upper", sigma)
    _require_mc(mc_yhat, "yhat_lower", "yhat_upper", "bands logistic yhat")
    cargs = inputs(b, 1.0 + 0.01 * np.arange(1, 65), cfg, logistic_theta)
    own_c = bk.bands(*cargs, cfg, s, seed=12)
    ref_c = {k: v.to(device) for k, v in
             bk.bands(*on_cpu(cargs), cfg, s, seed=12).items()}
    late = lambda d: {k: v[:, 32:] for k, v in d.items()}  # noqa: E731
    unit = (ref_c["trend_upper"] - ref_c["trend_lower"])[:, 32:] / 2.5631
    mc_trend = _mc_compare(late(own_c), late(ref_c), "trend_lower",
                           "trend_upper", unit)
    _require_mc(mc_trend, "trend_lower", "trend_upper",
                "bands logistic trend")
    for d in (own, own_c):
        require(bool((d["yhat_lower"] <= d["yhat_upper"]).all()),
                "logistic yhat_lower <= yhat_upper")
        require(ordered(d["trend_lower"], d["trend_upper"], True),
                "logistic trend_lower <= trend_upper")
        require(all(bool(torch.isfinite(v).all()) for v in d.values()),
                "logistic bands finite")
    return {"shape": [b, C4_DAYS, s], "given_draws_err": given,
            "given_draws_err_S65536": wide,
            "given_draws_err_rates_near_0": near_zero,
            "tolerance": f"|k-p|/(y_scale+|p|) <= {tol}",
            "monte_carlo_yhat": mc_yhat, "monte_carlo_trend": mc_trend}


# Where most trend paths tie (no simulated changepoint yet), both trend
# quantiles are that one value, each rounded by its own float32 weights
# (q * (S - 1) is not exact for every S): they may part by an ulp.
TIE_ULPS = 4


def ordered(lo, hi, ties: bool) -> bool:
    """lo <= hi, or within TIE_ULPS of it where a column may tie."""
    import torch

    if not ties:
        return bool((lo <= hi).all())
    eps = float(np.finfo(np.float32).eps)
    return bool((lo <= hi + TIE_ULPS * eps * hi.abs()).all())


def _band_rows(args, idx):
    """K2's inputs (theta, data, det, add, mult, scale, floor) of rows
    ``idx``."""
    theta, data, *rest = args
    return (theta[idx].contiguous(), _rows(data, idx),
            *(x[idx].contiguous() for x in rest))


def band_row_invariance(args, cfg, s, device) -> dict:
    """K2 with its own Philox draws gives a row the same bits wherever it
    sits, the row keeping its Philox coordinate (``rows``): a slice of the
    batch launched alone, and the batch permuted."""
    import torch

    from tsspark_tpu_torch.kernels import bands as bk

    b = args[0].shape[0]
    full = bk.bands(*args, cfg, s, seed=21)
    lo, hi = b // 8, b // 8 + max(1, b // 16)
    ids = torch.arange(b, dtype=torch.int32, device=device)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(1))
    perm = perm.to(device)
    for name, idx in (("slice", slice(lo, hi)), ("permuted", perm)):
        got = bk.bands(*_band_rows(args, idx), cfg, s, seed=21,
                       rows=ids[idx].contiguous())
        require(all(torch.equal(got[k], full[k][idx]) for k in full),
                f"bands S={s}: a {name} batch differs")
    torch.cuda.synchronize()
    return {"bitwise": True, "rows": [lo, hi], "permuted": b, "S": s}


def big_sample_run(inputs, on_cpu, cfg, eng_t, device) -> dict:
    """K2 with its own draws at 65,536 samples (the scratch path) on
    1,024 rows of the engine grid: finite, ordered bands; the yhat bands
    against the plain version's generator on 16 rows on the CPU (at this
    S a quantile's standard error is ~0.007 of the noise's sd); rows
    bitwise invariant."""
    import torch

    from tsspark_tpu_torch.kernels import bands as bk

    s, b, sub = 65536, 1024, 16
    args = inputs(b, eng_t)
    t0 = time.perf_counter()
    own = bk.bands(*args, cfg, s, seed=13)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for lo, hi in (("yhat_lower", "yhat_upper"),
                   ("trend_lower", "trend_upper")):
        require(bool(torch.isfinite(own[lo]).all()
                     & torch.isfinite(own[hi]).all()), f"S={s} {lo} finite")
        require(ordered(own[lo], own[hi], lo.startswith("trend")),
                f"S={s} {lo} <= {hi}")
    part = _band_rows(args, slice(0, sub))
    ref = {k: v.to(device) for k, v in
           bk.bands(*on_cpu(part), cfg, s, seed=13).items()}
    theta, scale = part[0], part[5]
    sigma = torch.exp(theta[:, 2])[:, None] * scale[:, None]
    mc = _mc_compare({k: v[:sub] for k, v in own.items()}, ref,
                     "yhat_lower", "yhat_upper", sigma)
    _require_mc(mc, "yhat_lower", "yhat_upper", f"bands S={s} yhat")
    return {"shape": [b, len(eng_t), s], "wall_s": wall,
            "monte_carlo_yhat_16_rows": mc,
            "row_invariance": band_row_invariance(
                _band_rows(args, slice(0, 128)), cfg, s, device)}


def synthetic_fit_data(rng, config, b, t_len, per_series, device):
    """A fit-shaped FitData: ``synthetic_data``'s grid and features, y
    from the model at random parameters plus noise, and an onset mask
    (leading unobserved days, as in M5) with scattered gaps."""
    import torch

    from tsspark_tpu_torch.kernels import forward as fk

    data = synthetic_data(rng, config, b, t_len, per_series, device)
    truth = torch.from_numpy(random_theta(rng, b, config)).to(device)
    yhat, *_ = fk.forward_plain(truth, data, config)
    onset = rng.integers(0, t_len // 3, b)
    mask = (np.arange(t_len)[None, :] >= onset[:, None]) \
        & (rng.uniform(size=(b, t_len)) > 0.02)
    mask_t = torch.from_numpy(mask.astype(np.float32)).to(device)
    noise = torch.from_numpy(
        rng.normal(0.0, 0.05, (b, t_len)).astype(np.float32)).to(device)
    return data._replace(y=((yhat + noise) * mask_t).contiguous(),
                         mask=mask_t)


def _model_cases(growths):
    import dataclasses

    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.eval.configs import CONFIG3

    mult = dataclasses.replace(
        CONFIG3, seasonalities=tuple(
            dataclasses.replace(sz, mode="multiplicative")
            for sz in CONFIG3.seasonalities),
        regressors=tuple(dataclasses.replace(rc, mode="multiplicative")
                         if rc.name == "price" else rc
                         for rc in CONFIG3.regressors))
    out = []
    for growth in growths:
        out += [
            (f"{growth}/additive/shared", dataclasses.replace(
                CONFIG3, growth=growth), False),
            (f"{growth}/multiplicative/shared", dataclasses.replace(
                mult, growth=growth), False),
            (f"{growth}/additive/per-series", dataclasses.replace(
                CONFIG3, growth=growth), True),
            (f"{growth}/no-regressors", dataclasses.replace(
                ProphetConfig(), growth=growth), False),
        ]
    return out


def f64_distance(theta, data, cfg, grads) -> dict:
    """Per row, max |g - g64| / (1 + max |g64|) of each named float32
    gradient in ``grads``, g64 the plain version's in float64: the median
    and the worst row."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    data64 = data._replace(**{f: getattr(data, f).double()
                              for f in data._fields})
    g64 = lk.loss_plain(theta.double(), data64, cfg)[1]
    scale = 1.0 + g64.abs().amax(-1)
    out = {}
    for name, g in grads.items():
        d = ((g.double() - g64).abs().amax(-1) / scale).cpu()
        out[name] = {"median": float(d.median()), "max": float(d.max()),
                     "max_abs": float((g.double() - g64).abs().max())}
    torch.cuda.synchronize()
    return out


def stack_past_its_plan(device, b=64, t_len=400) -> dict:
    """A 21-trial value stack whose trial-stack plan passes the card's
    shared memory (logistic, 300 changepoints, 64 seasonal columns) goes
    through K3's row layout: no stack launch, every trial its own
    launch's bits, within ``GAP_TOL`` of the plain version."""
    import torch

    from tsspark_tpu_torch.config import ProphetConfig, SeasonalityConfig
    from tsspark_tpu_torch.kernels import loss as lk

    rng = np.random.default_rng(7)
    cfg = ProphetConfig(growth="logistic", n_changepoints=300, seasonalities=(
        SeasonalityConfig("yearly", 365.25, 32),))
    data = synthetic_fit_data(rng, cfg, b, t_len, False, device)
    theta = logistic_theta(rng, b, cfg)
    # 300 steps: keep every rate clear of 0.
    theta[:, 3:3 + cfg.n_changepoints] *= 0.1
    theta = torch.from_numpy(theta).to(device)
    trials = [theta * (1.0 + 0.005 * n) for n in range(21)]
    stack = torch.cat(trials).contiguous()
    before = lk.stack_launches
    s_k, _ = lk.loss(stack, data, cfg, grad=False)
    require(lk.stack_launches == before,
            "loss: a stack past the trial-stack plan launched that layout")
    require(all(torch.equal(s_k[n * b:(n + 1) * b],
                            lk.loss(p.contiguous(), data, cfg, grad=False)[0])
                for n, p in enumerate(trials)),
            "loss: a stack past its plan differs from its trials alone")
    s_p, _ = lk.loss_plain(stack, data, cfg, grad=False)
    f_scale, _ = loss_scales(theta, data, cfg)
    gap = _gap(s_k, s_p, f_scale.repeat(21), t_len)
    require(gap <= GAP_TOL, f"loss: a stack past its plan, gap {gap}")
    return {"case": "logistic/ncp-300/fs-64/stack21-row-layout",
            "gap": {"stack": gap}, "stack21_bitwise": True}


def phase_loss(rng, device) -> dict:
    """K3 against its plain version on synthetic fit data; at rates near
    0, both against the plain version in float64 (ROADMAP Queue 3)."""
    import torch

    from tsspark_tpu_torch.eval.configs import CONFIG4
    from tsspark_tpu_torch.kernels import loss as lk

    b, t_len = 1024, 1746
    results = []
    cases = [(*c, logistic_theta if c[1].growth == "logistic" else
              random_theta) for c in _model_cases(("linear", "flat",
                                                   "logistic"))] + [
        ("logistic/config-4", CONFIG4, False, logistic_theta),
        ("logistic/config-4/rates-near-0", CONFIG4, False, rates_near_zero)]
    for name, cfg, per_series, theta_fn in cases:
        data = synthetic_fit_data(rng, cfg, b, t_len, per_series, device)
        theta = torch.from_numpy(theta_fn(rng, b, cfg)).to(device)
        f_k, g_k = lk.loss(theta, data, cfg)
        f_p, g_p = lk.loss_plain(theta, data, cfg)
        v_k, _ = lk.loss(theta, data, cfg, grad=False)
        # A stack of 3 trial points on the same data rows, and one of 21
        # (the line search's) whose every trial holds its row-layout bits.
        stack = torch.cat([theta, theta * 1.01, theta * 0.99]).contiguous()
        s_k, _ = lk.loss(stack, data, cfg, grad=False)
        s_p, _ = lk.loss_plain(stack, data, cfg, grad=False)
        trials = [theta * (1.0 + 0.005 * n) for n in range(21)]
        s21, _ = lk.loss(torch.cat(trials).contiguous(), data, cfg,
                         grad=False)
        require(all(torch.equal(s21[n * b:(n + 1) * b],
                                lk.loss(p.contiguous(), data, cfg,
                                        grad=False)[0])
                    for n, p in enumerate(trials)),
                f"loss {name}: a 21-trial stack differs from its trials "
                f"launched alone")
        torch.cuda.synchronize()
        gaps = loss_gaps(theta, data, cfg, {
            "f": (f_k, f_p), "g": (g_k, g_p), "value_mode": (v_k, f_p),
            "stack": (s_k, s_p)})
        require(bool(torch.isfinite(f_k).all() & torch.isfinite(g_k).all()),
                f"loss {name} finite")
        require(torch.equal(v_k, f_k), f"loss {name}: value mode == f")
        require(within_gap_rule(gaps), f"loss {name}: {gaps}")
        results.append({"case": name, "gap": gaps,
                        "max_abs_err_f": float((f_k - f_p).abs().max()),
                        "max_abs_err_g": float((g_k - g_p).abs().max()),
                        "stack21_bitwise": True})
        if theta_fn is rates_near_zero:
            # Which float32 gradient is nearer the float64 one.
            results[-1]["f64_distance"] = f64_distance(
                theta, data, cfg, {"k3": g_k, "plain_f32": g_p})
    results.append(stack_past_its_plan(device))
    out = {"phase": "loss", "shape": [b, t_len],
           "tolerance": GAP_RULE,
           "cases": results}
    emit(out)
    return out


def _ladder(b, device, k_steps=20):
    import torch

    return (0.5 ** torch.arange(k_steps, dtype=torch.float32,
                                device=device))[:, None].expand(
        k_steps, b).contiguous()


def phase_fan(rng, device) -> dict:
    """K4 against its plain version on synthetic fit data."""
    import torch

    from tsspark_tpu_torch.kernels import fan as fan_k

    b, t_len = 1024, 1746
    results = []
    for name, cfg, per_series in _model_cases(("linear",)):
        data = synthetic_fit_data(rng, cfg, b, t_len, per_series, device)
        theta = torch.from_numpy(random_theta(rng, b, cfg)).to(device)
        d = torch.from_numpy(rng.normal(0.0, 0.02, theta.shape).astype(
            np.float32)).to(device)
        ladder = _ladder(b, device)
        got = fan_k.fan(theta, d, ladder, data, cfg)
        want = fan_k.fan_plain(theta, d, ladder, data, cfg)
        torch.cuda.synchronize()
        gap = _gap(got, want, fan_scale(theta, d, ladder, data, cfg), t_len)
        require(bool(torch.isfinite(got).all()), f"fan {name} finite")
        require(gap <= GAP_TOL, f"fan {name}: gap {gap}")
        results.append({"case": name, "gap": gap,
                        "max_abs_err": float((got - want).abs().max())})
    out = {"phase": "fan", "shape": [20, b, t_len],
           "tolerance": GAP_RULE.replace("row", "rung"),
           "cases": results}
    emit(out)
    return out


def phase_serve(args, device) -> dict:
    import torch

    from tsspark_tpu_torch.carry import fitstate_from_numpy
    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.data.datasets import m5_like
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.design import prepare_fit_data
    from tsspark_tpu_torch.serve import (
        ForecastCache,
        ParamRegistry,
        PredictionEngine,
    )

    cfg = ProphetConfig()
    t0 = time.perf_counter()
    batch = m5_like(FULL_SERIES, FULL_DAYS, seed=2, with_regressors=False)
    _, meta = prepare_fit_data(batch.ds, batch.y, cfg)
    prep_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    n = FULL_SERIES
    arrays = {
        "theta": random_theta(rng, n, cfg),
        "loss": np.zeros(n, np.float32),
        "grad_norm": np.zeros(n, np.float32),
        "converged": np.ones(n, bool),
        "n_iters": np.zeros(n, np.int32),
        "status": np.zeros(n, np.int32),
        **meta._asdict(),
    }
    state = fitstate_from_numpy(arrays, "cpu")
    ids = batch.series_ids
    with tempfile.TemporaryDirectory() as root:
        reg = ParamRegistry(root, cfg)
        reg.publish(state, ids, step=np.ones(n))
        engine = PredictionEngine(ParamRegistry.open(root),
                                  cache=ForecastCache(4 * n), device=device)
        ds_full = np.concatenate(
            [batch.ds, batch.ds[-1] + np.arange(1, HORIZON + 1)])
        torch.cuda.reset_peak_memory_stats()
        # The main path: counts to 0 just before, read just after.
        fk.launches = 0
        bk.launches = 0
        reqs = [
            ("a: all series, deterministic", list(ids), 0),
            ("b: 4096 series, 256 samples", list(ids[:4096]), 256),
            ("c: all series, 256 samples", list(ids), 256),
            ("d: repeat of a", list(ids), 0),
        ]
        served = {}
        latency = {}
        for name, sids, n_s in reqs:
            t1 = time.perf_counter()
            res = engine.forecast(sids, HORIZON, num_samples=n_s, seed=0,
                                  timeout_s=600.0)
            torch.cuda.synchronize()
            latency[name] = time.perf_counter() - t1
            served[name] = res
        t1 = time.perf_counter()
        full = engine.backend.predict(reg.load().state, ds_full,
                                      num_samples=0)
        torch.cuda.synchronize()
        latency["in-sample+28 backend.predict"] = time.perf_counter() - t1
        launches = {"forward": fk.launches, "bands": bk.launches}
        peak = torch.cuda.max_memory_allocated()

        require(launches["forward"] > 0 and launches["bands"] > 0,
                f"kernels launched on the main path: {launches}")
        require(engine.stats.dispatches == 3,
                f"dispatches {engine.stats.dispatches} != 3")
        require(served["d: repeat of a"].from_cache == n, "d from cache")
        for name, res in served.items():
            for k, v in res.values.items():
                require(v.shape == (len(res.series_ids), HORIZON),
                        f"{name} {k} shape")
                require(bool(np.isfinite(v).all()), f"{name} {k} finite")
            if "yhat_lower" in res.values:
                require(bool((res.values["yhat_lower"]
                              <= res.values["yhat_upper"]).all()),
                        f"{name} lower <= upper")
        for k, v in full.items():
            require(v.shape == (n, FULL_DAYS + HORIZON), f"full {k} shape")
            require(bool(np.isfinite(v).all()), f"full {k} finite")
        require(np.array_equal(served["a: all series, deterministic"]
                               .values["yhat"],
                               served["d: repeat of a"].values["yhat"]),
                "cached repeat equals the first answer")
        # Agreement with a reference on a small input: the port's plain
        # path on the CPU for 64 series of request (a).
        from tsspark_tpu_torch.backends.registry import get_backend

        cpu = get_backend("cuda", cfg, device="cpu")
        snap = engine.refresh()
        idx, _ = snap.rows(ids[:64])
        sub, step = snap.take(idx)
        last = sub.meta.ds_start + sub.meta.ds_span
        grid = last[:, None] + step[:, None] * np.arange(1, HORIZON + 1)
        ref = cpu.predict(sub, grid, num_samples=0)
        got = served["a: all series, deterministic"].values
        scale = sub.meta.y_scale[:, None]
        ref_err = max(float(np.max(np.abs(got[k][:64] - ref[k])
                                   / (scale + np.abs(ref[k]))))
                      for k in ref)
        require(ref_err <= 1e-5, f"engine vs CPU reference: {ref_err}")
        out = {
            "phase": "serve", "series": n, "days": FULL_DAYS,
            "horizon": HORIZON, "prep_s": prep_s,
            "latency_s": latency, "launches": launches,
            "dispatches": engine.stats.dispatches,
            "from_cache_d": served["d: repeat of a"].from_cache,
            "peak_device_bytes": peak,
            "engine_vs_cpu_reference_err": ref_err,
        }
        emit(out)
        emit(phase_profile(root, list(ids), device))
        kernel_inputs = {
            "state": snap.state, "ds_full": ds_full, "cfg": cfg,
            "step": snap.step, "batch": batch,
        }
    return {"out": out, "inputs": kernel_inputs}


FIT_SUBSET = 128


def fit_subset() -> np.ndarray:
    """The parity subset: 128 series spread over config 3's 30,490."""
    return np.linspace(0, FULL_SERIES - 1, FIT_SUBSET).astype(np.int64)


# The CPU parity fits (the scipy oracle and the port's plain fit on each
# fit phase's subset) run in PARITY_WORKERS spawned processes of
# PARITY_THREADS threads each, submitted with the data before the first
# phase; the card's phases run meanwhile, and each fit phase collects its
# own.  (One after another they take ~385 s of an 8-core host.)
PARITY_WORKERS = 2
PARITY_THREADS = 2
_THREAD_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def parity_job(kind: str, config_no: int, ds_fit, y, sub: dict,
               ds_full=None, regs_full=None) -> dict:
    """One CPU parity fit of eval config ``config_no`` on a subset (``y``
    and the ``sub`` keywords): ``kind`` "oracle" is the scipy per-series
    fit (with its forecast's yhat over ``ds_full`` when given), "plain"
    the port's plain fit.  Runs in a ``ParityFits`` worker."""
    import torch

    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.eval import configs

    torch.set_num_threads(PARITY_THREADS)
    cfg, solver = {3: (configs.CONFIG3, configs.SOLVER3),
                   4: (configs.CONFIG4, configs.SOLVER4)}[config_no]
    t0 = time.perf_counter()
    bk = (get_backend("cpu", cfg, solver) if kind == "oracle"
          else get_backend("cuda", cfg, solver, device="cpu"))
    state = bk.fit(ds_fit, y, **sub)
    out = {"seconds": time.perf_counter() - t0,
           "loss": np.asarray(state.loss),
           "status": None if state.status is None
           else np.asarray(state.status),
           "n_iters": np.asarray(state.n_iters)}
    if ds_full is not None:
        out["yhat"] = np.asarray(bk.predict(state, ds_full,
                                            regressors=regs_full,
                                            num_samples=0)["yhat"])
    return out


class ParityFits:
    """The four CPU parity fits of phases fit and fit_logistic and the CPU
    streaming runs of phases stream5 and stream_fleet (``stream_job``:
    config 5's 50 series, plain and with each planted fault; the fleet's
    64-series subset, plain and rolled), in a pool of spawned processes beside the
    card's phases (see PARITY_WORKERS)."""

    def __init__(self, batch3, batch4, stream5_df, fleet_subset_df):
        import multiprocessing as mp
        import os

        from tsspark_tpu_torch.eval import configs

        saved = {k: os.environ.get(k) for k in _THREAD_ENV}
        os.environ.update({k: str(PARITY_THREADS) for k in _THREAD_ENV})
        try:
            self.pool = mp.get_context("spawn").Pool(PARITY_WORKERS)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        split3 = configs.split_point(FULL_DAYS)
        i3 = fit_subset()
        fit3 = (batch3.ds[:split3], np.nan_to_num(batch3.y[i3, :split3]),
                dict(mask=batch3.mask[i3, :split3],
                     regressors=batch3.regressors[i3, :split3]))
        split4 = configs.split_point(C4_DAYS)
        i4 = fit4_subset()
        fit4 = (batch4.ds[:split4], batch4.y[i4, :split4],
                dict(mask=batch4.mask[i4, :split4],
                     cap=batch4.cap[i4, :split4]))
        run = self.pool.apply_async
        self.jobs = {
            ("plain", 3): run(parity_job, ("plain", 3) + fit3),
            ("oracle", 3): run(parity_job, ("oracle", 3) + fit3
                               + (batch3.ds, batch3.regressors[i3])),
            ("plain", 4): run(parity_job, ("plain", 4) + fit4),
            ("oracle", 4): run(parity_job, ("oracle", 4) + fit4),
            ("plain", "stream5"): run(stream_job, ("plain", stream5_df)),
            ("plain", "fleet"): run(stream_job, ("plain", fleet_subset_df)),
            ("rolled", "fleet"): run(stream_job,
                                     ("rolled", fleet_subset_df)),
        }
        for k in STREAM_FAULTS:
            self.jobs[(k, "stream5")] = run(stream_job, (k, stream5_df))

    def get(self, kind: str, config_no: int) -> dict:
        return self.jobs[(kind, config_no)].get()

    def submit(self, fn, *args):
        """A job handed to the pool during the run (``.get()`` waits)."""
        return self.pool.apply_async(fn, args)

    def get_stream(self, kind: str, which: str) -> dict:
        return self.jobs[(kind, which)].get()

    def close(self, finished: bool) -> None:
        """Join the workers after a finished run, else stop them."""
        if finished:
            self.pool.close()
        else:
            self.pool.terminate()
        self.pool.join()


# Loss parity of a fit, per series, in nats.  Two correct float32
# lockstep solvers part after a few iterations and stop at the noise
# floor at different points: on the parity subset at 1,746 days, the JAX
# package and the port's plain fit, both on the CPU, differ by |mean| <=
# 0.011 and per series by up to 1.39 nats, both ways, over data seeds 2
# and 3; against the scipy oracle both batched solvers are 0.32-0.33 nats
# worse on average and up to 2.10 per series (tests/test_torch_fit.py,
# ``-m slow``).  The limits below leave margin over those readings, and
# the same test holds planted faults of the fit to failing them.  A
# gradient off by a few percent is not seen here (it moves the fit less
# than float32 does): the kernel checks at GAP_TOL hold K3 and K4 far
# tighter.
PLAIN_MEAN_TOL = 0.05   # |mean| against the plain fit: KEEP_BEST_MARGIN
PLAIN_SERIES_TOL = 2.0  # |gap| of any series against the plain fit
ORACLE_MEAN_TOL = 0.5   # mean excess over the scipy oracle
ORACLE_SERIES_TOL = 3.0  # excess of any series over the scipy oracle
LIMITS3 = (PLAIN_MEAN_TOL, PLAIN_SERIES_TOL, ORACLE_MEAN_TOL,
           ORACLE_SERIES_TOL)


def loss_parity(loss, plain_loss, oracle_loss, limits=LIMITS3):
    """(readings, failed checks) of a fit's per-series ``loss`` against a
    plain fit's and the scipy oracle's on the same series; ``limits``:
    (|mean| and per-series |gap| to the plain fit, mean and per-series
    excess over the oracle; None: not held), config 3's by default."""
    plain_mean, plain_series, oracle_mean, oracle_series = limits
    gap = np.asarray(loss, np.float64) - np.asarray(plain_loss, np.float64)
    over = np.asarray(loss, np.float64) - np.asarray(oracle_loss, np.float64)
    readings = {
        "loss_minus_plain_mean": float(gap.mean()),
        "loss_minus_plain_min": float(gap.min()),
        "loss_minus_plain_max": float(gap.max()),
        "loss_minus_plain_over_+0.05": int((gap > 0.05).sum()),
        "loss_minus_plain_under_-0.05": int((gap < -0.05).sum()),
        "loss_minus_oracle_mean": float(over.mean()),
        "loss_minus_oracle_max": float(over.max()),
    }
    failed = [what for what, bad in (
        (f"|mean gap to the plain fit| > {plain_mean}",
         abs(gap.mean()) > plain_mean),
        (f"a series' |gap to the plain fit| > {plain_series}",
         not np.all(np.abs(gap) <= plain_series)),
        (f"mean excess over the oracle > {oracle_mean}",
         oracle_mean is not None and not over.mean() <= oracle_mean),
        (f"a series' excess over the oracle > {oracle_series}",
         not np.all(over <= oracle_series)),
    ) if bad]
    return readings, failed


# Eval config 4 at 8,192 series: ``config4_wiki_logistic(scale=1024)``,
# one full chunk of ``CudaBackend``; its parity subset, spread over them:
# 64 series, where config 3 takes 128, because the scipy oracle and the
# plain fit of a logistic series take several times a linear one's (~6
# minutes for 128 on the card's host), and the run's time requires it.
C4_SERIES = 8192
C4_DAYS = 1200
FIT4_SUBSET = 64


def fit4_subset() -> np.ndarray:
    return np.linspace(0, C4_SERIES - 1, FIT4_SUBSET).astype(np.int64)


# Config 4's loss-parity limits, in nats.  Its losses are ~3e3 nats a
# series at 1,080 days, and after 200 iterations more than a quarter of
# the series are still moving, so two correct float32 lockstep solvers
# end them at points far apart.  Each limit lies between the largest
# reading of a sound fit (the JAX package against the port's plain fit
# on the CPU, data seeds 2 and 3, and the card's fit) and the smallest
# reading of a planted fault (stuck at its init; cut at 40 iterations),
# near their geometric mean (PERF.md's config-4 limits table;
# tests/test_torch_logistic.py ``-m slow`` prints them):
#   |mean gap to the plain fit|     sound <= 0.289, faults >= 11.8  -> 0.5
#   a series' |gap to the plain fit| sound <= 10.42, faults >= 48.5 -> 20
#   a series' excess over the oracle sound <= 26.6, faults >= 58.8  -> 40
# The mean excess over the oracle is not held (None): the oracle stalls
# above the batched fits on many logistic series, so sound fits read
# -3.8 to -18 and the 40-iteration cut -5.4; it could catch only a fit
# stuck at its init, which the other three catch.
LIMITS4 = (0.5, 20.0, None, 40.0)


def phase_fit(device, batch, gen_s, parity) -> dict:
    """Eval config 3 (``batch``, generated in ``gen_s``) fitted at full
    width through ``CudaBackend.fit``, scored, profiled, and held against
    the scipy oracle and the plain CPU fit on a subset (``parity``'s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.models.prophet.init import (
        curvature_diag,
        initial_theta,
    )
    from tsspark_tpu_torch.models.prophet.model import _objective
    from tsspark_tpu_torch.ops import lbfgs

    cfg, solver = configs.CONFIG3, configs.SOLVER3
    split = configs.split_point(FULL_DAYS)
    ds_fit = batch.ds[:split]
    y_fit = np.nan_to_num(batch.y[:, :split])
    m_fit = batch.mask[:, :split]
    r_fit = batch.regressors[:, :split]
    bk = get_backend("cuda", cfg, solver, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lbfgs.timing.reset()
    # The main path: counts to 0 just before, read just after.
    lk.launches = lk.grad_launches = fan_k.launches = fk.launches = 0
    t0 = time.perf_counter()
    state = bk.fit(ds_fit, y_fit, mask=m_fit, regressors=r_fit)
    fit_s = time.perf_counter() - t0
    stages = dict(bk.stages.seconds)
    bk.stages.reset()
    t0 = time.perf_counter()
    fc = bk.predict(state, batch.ds, regressors=batch.regressors,
                    num_samples=0)
    predict_s = time.perf_counter() - t0
    launches = {"loss": lk.launches, "loss_grad": lk.grad_launches,
                "loss_value": lk.launches - lk.grad_launches,
                "fan": fan_k.launches, "forward": fk.launches}
    peak = torch.cuda.max_memory_allocated()
    iters, body_s = lbfgs.timing.iters, lbfgs.timing.body_s

    require(launches["loss_grad"] > 0 and launches["loss_value"] > 0
            and launches["fan"] > 0 and launches["forward"] > 0,
            f"kernels launched on the fit path: {launches}")
    require(tuple(state.theta.shape) == (FULL_SERIES, cfg.num_params),
            "fitted theta shape")
    require(bool(torch.isfinite(state.theta).all()), "theta finite")
    require(bool(np.isfinite(state.loss).all()), "loss finite")
    require(fc["yhat"].shape == (FULL_SERIES, FULL_DAYS), "forecast shape")
    require(bool(np.isfinite(fc["yhat"]).all()), "forecast finite")
    sc = configs.score(batch, fc)

    # One chunk's solve under the profiler: the first 8,192 series,
    # packed and unpacked as the fit does, init outside the window.
    c = bk.chunk_size
    u8 = design._indicator_reg_cols(r_fit)
    data_np, meta = design.prepare_fit_data(
        ds_fit, y_fit[:c], cfg, mask=m_fit[:c], regressors=r_fit[:c])
    packed, _ = design.pack_fit_data(data_np, meta, ds_fit, reg_u8_cols=u8,
                                     collapse_cap=True)
    data = design.unpack_fit_data(design.packed_to_device(packed, device),
                                  u8)
    theta0 = initial_theta(data, cfg, solver)
    precond = curvature_diag(data, cfg, theta0)
    fun, fval, fan = _objective(data, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        res = lbfgs.minimize(fun, theta0, solver, fun_value=fval,
                             precond=precond, fan_value=fan)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
    top = _device_events(prof)
    busy_ms = sum(ms for _, ms in top)
    chunk_iters = int(res.n_iters.max())

    # Parity on a subset spread over the batch.
    idx = fit_subset()
    t1 = time.perf_counter()
    oracle, plain = parity.get("oracle", 3), parity.get("plain", 3)
    wait_s = time.perf_counter() - t1
    sub_batch = batch._replace(y=batch.y[idx], mask=batch.mask[idx],
                               regressors=batch.regressors[idx],
                               series_ids=batch.series_ids[idx])
    o_sc = configs.score(sub_batch, {"yhat": oracle["yhat"]})
    d_train = sc["smape_train"][idx] - o_sc["smape_train"]
    d_hold = sc["smape_holdout"][idx] - o_sc["smape_holdout"]
    loss_readings, loss_failed = loss_parity(state.loss[idx], plain["loss"],
                                             oracle["loss"])
    loss_gap = state.loss[idx] - plain["loss"]
    worst = np.argsort(-np.abs(loss_gap))[:5]
    parity = {
        "subset": FIT_SUBSET,
        "oracle_s": oracle["seconds"], "plain_cpu_fit_s": plain["seconds"],
        "parity_wait_s": wait_s,
        "smape_train_max_abs_delta": float(np.abs(d_train).max()),
        "smape_train_mean_delta": float(d_train.mean()),
        "smape_holdout_max_abs_delta": float(np.abs(d_hold).max()),
        "smape_holdout_mean_delta": float(d_hold.mean()),
        **loss_readings,
        "loss_checks_failed": loss_failed,
        "worst_rows": [
            {"series": int(idx[w]), "gap": float(loss_gap[w]),
             "status": [int(state.status[idx[w]]), int(plain["status"][w])],
             "n_iters": [int(state.n_iters[idx[w]]),
                         int(plain["n_iters"][w])]}
            for w in worst],
    }
    status = np.bincount(np.asarray(state.status), minlength=5)
    out = {
        "phase": "fit", "series": FULL_SERIES, "days_fit": split,
        "days_forecast": FULL_DAYS, "params": cfg.num_params,
        "m5_like_s": gen_s, "fit_s": fit_s, "predict_s": predict_s,
        "stages_s": stages,
        "launches": launches,
        "iterations": {"mean": float(np.mean(state.n_iters)),
                       "max": int(np.max(state.n_iters)),
                       "solver_bodies": iters},
        "host_ms_per_iteration": 1e3 * body_s / max(iters, 1),
        "status_counts": {"running": int(status[0]), "gtol": int(status[1]),
                          "ftol": int(status[2]), "floor": int(status[3]),
                          "stalled": int(status[4])},
        "converged_frac": float(np.mean(state.converged)),
        "smape_train": float(sc["smape_train"].mean()),
        "smape_holdout": float(sc["smape_holdout"].mean()),
        "peak_device_bytes": peak,
        "chunk_solve_profile": {
            "rows": c, "iterations": chunk_iters, "traced_wall_s": traced,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / 1e3 / traced,
            "top_device_ms": [(k[:60], ms) for k, ms in top[:6]],
        },
        "parity": parity,
    }
    emit(out)
    require(parity["smape_train_max_abs_delta"] <= 0.1,
            f"per-series train sMAPE vs the scipy oracle: {parity}")
    require(abs(parity["smape_train_mean_delta"]) <= 0.05,
            f"mean train sMAPE vs the scipy oracle: {parity}")
    require(not loss_failed, f"loss parity: {loss_failed}: {parity}")
    d = -precond * fun(theta0)[1]
    return {"out": out, "inputs": {
        "data": data, "theta0": theta0, "direction": d.contiguous(),
        "theta_fit": state.theta[:c].to(device).contiguous(), "cfg": cfg,
        "batch": batch}}


def phase_fit_logistic(device, batch, gen_s, parity) -> dict:
    """Eval config 4 at 8,192 series (``config4_wiki_logistic(scale=1024)``'s
    batch, ``batch``, generated in ``gen_s``) fitted on its first 1,080
    days through ``CudaBackend.fit``, then forecast with 256-sample bands
    over all 1,200 days through ``predict``; scored, and held against the
    scipy oracle and the plain CPU fit on a subset (``parity``'s;
    ``loss_parity`` at ``LIMITS4``)."""
    import torch

    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import bands as bands_k
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.models.prophet.init import initial_theta
    from tsspark_tpu_torch.models.prophet.predict import prepare_predict_data
    from tsspark_tpu_torch.ops import lbfgs

    cfg, solver = configs.CONFIG4, configs.SOLVER4
    split = configs.split_point(C4_DAYS)
    ds_fit = batch.ds[:split]
    y_fit, m_fit = batch.y[:, :split], batch.mask[:, :split]
    cap_fit = batch.cap[:, :split]
    bk = get_backend("cuda", cfg, solver, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lbfgs.timing.reset()
    # The main path: counts to 0 just before, read just after.
    lk.launches = lk.grad_launches = lk.stack_launches = fan_k.launches = 0
    fk.launches = bands_k.launches = 0
    t0 = time.perf_counter()
    state = bk.fit(ds_fit, y_fit, mask=m_fit, cap=cap_fit)
    fit_s = time.perf_counter() - t0
    stages = dict(bk.stages.seconds)
    bk.stages.reset()
    t0 = time.perf_counter()
    fc = bk.predict(state, batch.ds, cap=batch.cap, num_samples=256)
    predict_s = time.perf_counter() - t0
    launches = {"loss": lk.launches, "loss_grad": lk.grad_launches,
                "loss_value": lk.launches - lk.grad_launches,
                "loss_stack": lk.stack_launches,
                "fan": fan_k.launches, "forward": fk.launches,
                "bands": bands_k.launches}
    peak = torch.cuda.max_memory_allocated()
    iters, body_s = lbfgs.timing.iters, lbfgs.timing.body_s

    # The line search's trial stacks went through the trial-stack layout.
    require(launches["loss_grad"] > 0 and launches["loss_value"] > 0
            and launches["loss_stack"] > 0
            and launches["forward"] > 0 and launches["bands"] > 0,
            f"kernels launched on the config-4 path: {launches}")
    require(tuple(state.theta.shape) == (C4_SERIES, cfg.num_params),
            "fitted theta shape")
    require(bool(torch.isfinite(state.theta).all()), "theta finite")
    require(bool(np.isfinite(state.loss).all()), "loss finite")
    for k, v in fc.items():
        require(v.shape == (C4_SERIES, C4_DAYS), f"forecast {k} shape")
        require(bool(np.isfinite(v).all()), f"forecast {k} finite")
    require(bool((fc["yhat_lower"] <= fc["yhat_upper"]).all()),
            "yhat_lower <= yhat_upper")
    require(ordered(torch.from_numpy(fc["trend_lower"]),
                    torch.from_numpy(fc["trend_upper"]), True),
            "trend_lower <= trend_upper")
    sc = configs.score(batch, fc)

    # Parity on a subset spread over the batch.
    idx = fit4_subset()
    t1 = time.perf_counter()
    oracle, plain = parity.get("oracle", 4), parity.get("plain", 4)
    wait_s = time.perf_counter() - t1
    loss_readings, loss_failed = loss_parity(state.loss[idx], plain["loss"],
                                             oracle["loss"], LIMITS4)
    loss_gap = state.loss[idx] - plain["loss"]
    worst = np.argsort(-np.abs(loss_gap))[:5]
    parity = {
        "subset": FIT4_SUBSET, "limits": LIMITS4,
        "oracle_s": oracle["seconds"], "plain_cpu_fit_s": plain["seconds"],
        "parity_wait_s": wait_s,
        **loss_readings,
        "loss_checks_failed": loss_failed,
        "worst_rows": [
            {"series": int(idx[w]), "gap": float(loss_gap[w]),
             "status": [int(state.status[idx[w]]), int(plain["status"][w])],
             "n_iters": [int(state.n_iters[idx[w]]),
                         int(plain["n_iters"][w])]}
            for w in worst],
    }
    status = np.bincount(np.asarray(state.status), minlength=5)
    out = {
        "phase": "fit_logistic", "series": C4_SERIES, "days_fit": split,
        "days_forecast": C4_DAYS, "params": cfg.num_params,
        "samples": 256,
        "wiki_logistic_like_s": gen_s, "fit_s": fit_s,
        "predict_s": predict_s, "stages_s": stages,
        "launches": launches,
        "iterations": {"mean": float(np.mean(state.n_iters)),
                       "max": int(np.max(state.n_iters)),
                       "solver_bodies": iters},
        "host_ms_per_iteration": 1e3 * body_s / max(iters, 1),
        "status_counts": {"running": int(status[0]), "gtol": int(status[1]),
                          "ftol": int(status[2]), "floor": int(status[3]),
                          "stalled": int(status[4])},
        "converged_frac": float(np.mean(state.converged)),
        "smape_train": float(sc["smape_train"].mean()),
        "smape_holdout": float(sc["smape_holdout"].mean()),
        "peak_device_bytes": peak,
        "parity": parity,
    }
    emit(out)
    require(not loss_failed, f"config-4 loss parity: {loss_failed}: "
            f"{parity}")

    # The kernels' inputs at this path's shapes: the fit's chunk as the
    # fit packs it, its ridge init, a line search's 21-row trial stack,
    # and the forecast's chunk.
    data_np, meta = design.prepare_fit_data(ds_fit, y_fit, cfg, mask=m_fit,
                                            cap=cap_fit)
    packed, _ = design.pack_fit_data(data_np, meta, ds_fit)
    data = design.unpack_fit_data(design.packed_to_device(packed, device))
    theta0 = initial_theta(data, cfg, solver)
    trials = line_search_stack(data, cfg, solver, device)
    theta_fit = state.theta.to(device).contiguous()
    pdata = prepare_predict_data(batch.ds, meta, cfg, device, cap=batch.cap)
    return {"out": out, "inputs": {
        "data": data, "theta0": theta0, "theta_fit": theta_fit,
        "trials": trials, "pdata": pdata, "cfg": cfg,
        "predict_chunk": bk._chunk(C4_SERIES, 256 * C4_DAYS, 1),
        "y_scale": torch.as_tensor(meta.y_scale, dtype=torch.float32,
                                   device=device),
        "floor": torch.as_tensor(meta.floor, dtype=torch.float32,
                                 device=device)}}


# Continuous refit (eval config 5): ``StreamingForecaster`` over a 510-day
# base batch and three 73-day micro-batches, at config 5's published 50
# series (phase stream5) and at the M5 fleet's 30,490 (phase
# stream_fleet).  At config 5's scale a series' forecast sMAPE (percent,
# 14 days against the noise-free generator) is held per series against
# the port's plain CPU run of the same series at STREAM_SMAPE_TOL.  Readings at config 5's 50
# series on the CPU (tests/test_torch_stream5.py ``-m slow`` prints them):
# sound runs part by at most 0.0089 (the JAX package's warm against cold
# run; the port's plain run against the JAX package's: 0.0072 warm, 0.0044
# cold and replayed); the planted faults against the sound port run: the
# warm start taken from the neighbouring series' row ("rolled") 4.78, the
# stored theta passed on untransferred ("raw_theta") 0.0129 — within two
# of the sound spread, so no sMAPE limit can see that one (60 iterations
# and the rescue pass recover from it; tests/test_torch_streaming.py holds
# transfer_theta itself to the JAX package at 1e-6).  The limit sits 5.6x
# above the sound readings and ~100x below the rolled fault.
STREAM_SMAPE_TOL = 0.05
STREAM_FAULTS = ("rolled", "raw_theta")
REPLAY_TOL = 1e-3       # |delta mean sMAPE| after the replay: the reference's
# At the fleet's width the same generator puts levels up to 6.1e5 under
# the same noise, and a forecast's sMAPE there is ~1e-4: no sMAPE limit
# can fail a wrong fleet forecast.  The fleet's forecasts are held per
# series in units of the noise instead: the largest |yhat_a - yhat_b|
# over the 14 days, / NOISE5.  There float32 resolves a series to a few
# ulps of its level, ~1e-7 x 6e5 = 0.07 at the top, and two sound runs
# part by more than the noise.  Readings (the 64-series subset; an H100,
# PERF.md §6): the card against the CPU plain path at most 6.75 warm,
# 2.5 replayed, 20.1 cold (cold rows start from a ridge init taken over
# the card's 8,192-row chunk); the card's replay against its warm run at
# most 10.5 over all 30,490 series; on the CPU the subset's warm and cold
# runs part by up to 9.7.  The rolled fault on the subset reads 150.5
# against the sound CPU run (series 0, warm-started from the top
# series' row), and must fail the limit.  The limit sits 2x above the
# largest sound reading and 3.8x below the fault.
NOISE5 = 0.5
FLEET_NOISE_TOL = 40.0
FLEET_SERIES = 30490
FLEET_SUBSET = 64
FLEET_BUDGET_S = 250.0  # past this the cold run takes the first 8,192 series
FLEET_COLD_CUT = 8192


def fleet_subset() -> np.ndarray:
    return np.linspace(0, FLEET_SERIES - 1, FLEET_SUBSET).astype(np.int64)


def stream5_fault_run(name: str, df) -> dict:
    """Config 5's schedule over ``df`` on the CPU plain path with a
    planted fault in the warm start: "rolled" (each series warm-started
    from its neighbour's transferred row), "raw_theta" (the stored theta
    passed on untransferred); ``config5_run``'s detail."""
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.streaming import driver

    sound = driver.transfer_theta

    def rolled(th, mo, mn, cfg, device=None):
        import torch

        return torch.roll(sound(th, mo, mn, cfg, device=device), 1, 0)

    def raw_theta(th, mo, mn, cfg, device=None):
        return th.to(device)

    driver.transfer_theta = {"rolled": rolled, "raw_theta": raw_theta}[name]
    try:
        _, det = configs.config5_run("cuda", 1.0, "cpu", frame=df,
                                     warmup=False)
    finally:
        driver.transfer_theta = sound
    return det


def stream_job(kind: str, df) -> dict:
    """One CPU run of config 5's schedule over ``df`` in a ``ParityFits``
    worker: "plain" the port's plain path (warm, cold, replayed), else a
    planted fault (``stream5_fault_run``, warm): per-series sMAPE and
    yhat of each."""
    import torch

    from tsspark_tpu_torch.eval import configs

    torch.set_num_threads(PARITY_THREADS)
    t0 = time.perf_counter()
    if kind == "plain":
        out, det = configs.config5_run("cuda", 1.0, "cpu", frame=df,
                                       warmup=False)
        keys = ("warm", "cold", "replay")
        res = {"out": out}
    else:
        det, keys, res = stream5_fault_run(kind, df), ("warm",), {}
    for k in keys:
        res[k], res[f"yhat_{k}"] = det[f"smape_{k}"], det[f"yhat_{k}"]
    res["seconds"] = time.perf_counter() - t0
    return res


def _stream_counts():
    from tsspark_tpu_torch.kernels import bands as bands_k
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk

    return {"loss_grad": lk.grad_launches,
            "loss_value": lk.launches - lk.grad_launches,
            "loss_stack": lk.stack_launches, "fan": fan_k.launches,
            "forward": fk.launches, "bands": bands_k.launches}


def _zero_counts() -> None:
    from tsspark_tpu_torch.kernels import bands as bands_k
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk

    lk.launches = lk.grad_launches = lk.stack_launches = fan_k.launches = 0
    fk.launches = bands_k.launches = 0


def _sum_counts(rows) -> dict:
    out = {}
    for r in rows:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _smape_gap(got, want) -> dict:
    d = np.abs(np.asarray(got) - np.asarray(want))
    return {"max": float(d.max()), "mean": float(d.mean()),
            "series_over_tol": int((d > STREAM_SMAPE_TOL).sum())}


def phase_stream5(device, parity) -> dict:
    """Eval config 5 at its published scale through ``config5_run`` on
    the card (the runner's throwaway pass, the warm run, the cold run,
    the replay), held against the port's plain CPU run per series and
    against the planted faults; K3 (both modes) and K4 on its 50-series
    chunk of the last micro-batch (``hold_stream_kernels``) and K1 on its
    50 x 14 forecast chunk, against their plain versions."""
    import json
    import os

    import torch

    from tsspark_tpu_torch import native
    from tsspark_tpu_torch.eval import configs

    require(native.available(), "the native ingest library builds here")
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    out, det = configs.config5_run("cuda", 1.0, device)
    wall = time.perf_counter() - t0
    launches = _stream_counts()
    sf = det["forecaster"]
    ids, theta, data = stream_chunk(sf, det["batches"][-1], device)
    kern = {"loss_fan": hold_stream_kernels(theta, data, sf.config, seed=4),
            "forward": stream_forward(sf, ids, device)[0]}
    plain = parity.get_stream("plain", "stream5")
    faults = {k: parity.get_stream(k, "stream5")["warm"]
              for k in STREAM_FAULTS}
    gaps = {k: _smape_gap(det[f"smape_{k}"], plain[k])
            for k in ("warm", "cold", "replay")}
    fault_gaps = {k: _smape_gap(v, det["smape_warm"])
                  for k, v in faults.items()}
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "EVAL_builder_r05_cpu.json")
    with open(ref_path) as fh:
        jax_cpu = json.load(fh)["config5_streaming"]
    po = plain["out"]
    res = {"phase": "stream5", "wall_s": wall, "native": native.available(),
           "config5": out, "launches": launches,
           "warm_batches": [{"wall_s": w, "stages_s": s} for w, s in zip(
               det["warm"]["batch_seconds"], det["warm"]["batch_stages"])],
           "plain_cpu": {"config5": po, "seconds": plain["seconds"]},
           "smape_vs_plain_cpu": gaps, "tolerance": STREAM_SMAPE_TOL,
           "planted_faults_vs_card": fault_gaps, "kernels": kern,
           "jax_package_cpu_record": {
               "source": "EVAL_builder_r05_cpu.json",
               "smape_warm": jax_cpu["warm_vs_cold"]["smape_warm"],
               "smape_cold": jax_cpu["warm_vs_cold"]["smape_cold"],
               "warm_starts": jax_cpu["warm_starts"],
               "cold_starts": jax_cpu["cold_starts"],
               "replay_delta": jax_cpu["crash_replay"][
                   "smape_delta_after_replay"]}}
    emit(res)
    for k in ("micro_batches", "warm_starts", "cold_starts", "n_series"):
        require(out[k] == po[k], f"stream5 {k}: {out[k]} != {po[k]}")
    require(out["warm_vs_cold"]["cold_starts_forced"]
            == po["warm_vs_cold"]["cold_starts_forced"],
            "stream5 forced cold starts")
    require((out["warm_starts"], out["cold_starts"]) == (150, 50),
            f"stream5 counts {out['warm_starts']}, {out['cold_starts']}")
    require(out["crash_replay"]["smape_delta_after_replay"] < REPLAY_TOL,
            f"stream5 replay: {out['crash_replay']}")
    require(all(np.isfinite(det[f"smape_{k}"]).all()
                for k in ("warm", "cold", "replay")), "stream5 finite")
    require(all(g["max"] <= STREAM_SMAPE_TOL for g in gaps.values()),
            f"stream5 sMAPE against the plain CPU run: {gaps}")
    require(fault_gaps["rolled"]["max"] > STREAM_SMAPE_TOL,
            f"stream5: the rolled fault passes the limit: {fault_gaps}")
    require(launches["loss_grad"] > 0 and launches["loss_value"] > 0
            and launches["fan"] > 0 and launches["forward"] > 0,
            f"stream5 kernels launched: {launches}")
    return res


def _stream_drive(sf, batches) -> list:
    """Each micro-batch through ``sf.process``, kernel counts set to 0
    just before and read just after: per micro-batch its wall, stages,
    warm and cold starts and launches."""
    import torch

    rows = []
    for i, b in enumerate(batches):
        w0, c0 = sf.stats.warm_starts, sf.stats.cold_starts
        torch.cuda.synchronize()
        _zero_counts()
        sf.process(b)
        torch.cuda.synchronize()
        rows.append({"batch": i, "rows": int(len(b)),
                     "wall_s": sf.stats.batch_seconds[-1],
                     "warm": sf.stats.warm_starts - w0,
                     "cold": sf.stats.cold_starts - c0,
                     "launches": _stream_counts(),
                     "stages_s": sf.stats.batch_stages[-1]})
        require(rows[-1]["launches"]["loss_grad"] > 0
                and rows[-1]["launches"]["fan"] > 0,
                f"a fleet micro-batch launched K3 and K4: {rows[-1]}")
    return rows


def _stream_forecast(sf, sids) -> tuple:
    """The deterministic 14-day forecast of every series (counts set to 0
    just before, read just after): yhat, per-series sMAPE, the wall and
    the launches."""
    import torch

    from tsspark_tpu_torch.eval import configs

    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    yhat, sm = configs.config5_forecast(sf, sids)
    torch.cuda.synchronize()
    return yhat, sm, time.perf_counter() - t0, _stream_counts()


# K3 and K4 on a streaming chunk.  At its warm start a chunk's residual
# y - yhat is the noise, 0.5 on levels of 20 to 6e5: from 5e-4 down to
# 8e-7 of the scaled series, a few float32 ulps of yhat at the fleet's
# top.  There float32 cannot resolve the loss, and GAP_RULE, which counts
# the sums' terms and not the residual's cancellation, cannot hold for any
# two float32 orders: the plain float32 gradient is 0.11 of the rule's
# unit from float64 on config 5's 50 series and 15.3 on every 32nd of the
# fleet's first 8,192 (PERF.md §6).  Off the optimum as below, the plain
# float32 loss, gradient and fan are all within 0.005 of it on both.
# So the kernels are held by GAP_RULE on the
# chunk's own data with the warm start moved off its optimum
# (``off_optimum``), where residuals are of the data's own size, and one
# observed cell dropped from the kernel's input there (a planted fault)
# must fail the rule.  Their gap at the warm start itself is reported.
STREAM_THETA_SD = 0.05


def off_optimum(theta, seed: int) -> tuple:
    """The warm start moved off its optimum: every parameter moved by
    N(0, STREAM_THETA_SD) and the noise scale set to 0.05 of the series'
    scale (``random_theta``'s magnitudes); and a ray's direction for K4,
    N(0, 0.02) as phase fan's (the path's own direction, the
    preconditioned gradient, leads back to the optimum)."""
    import torch

    gen = torch.Generator(device=theta.device).manual_seed(seed)
    out = theta + STREAM_THETA_SD * torch.randn(
        theta.shape, generator=gen, device=theta.device)
    out[:, 2] = float(np.log(0.05))
    d = 0.02 * torch.randn(theta.shape, generator=gen, device=theta.device)
    return out.contiguous(), d


def stream_chunk(sf, batch, device, width=None):
    """The refit chunk of ``batch``'s first ``width`` series (default the
    backend's chunk width) as the driver builds it: (ids, the warm start
    transferred from the store, the device data)."""
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.streaming.warmstart import transfer_theta

    cfg = sf.config
    ids = list(dict.fromkeys(batch.series_id.astype(str)))[
        :width or sf.backend.chunk_size]
    codes = sf._codes(ids)
    grid = sf._hist.union_grid(codes)
    y32 = sf._hist.materialize(codes, grid).astype(np.float32)
    data_np, meta = design.prepare_fit_data(grid, y32, cfg)
    packed, u8 = design.pack_fit_data(data_np, meta, grid,
                                      collapse_cap=True)
    data = design.unpack_fit_data(design.packed_to_device(packed, device),
                                  u8)
    old_theta, old_meta, _ = sf.store.lookup(ids)
    theta = transfer_theta(old_theta, old_meta, meta, cfg,
                           device=device).contiguous()
    return ids, theta, data


def hold_stream_kernels(theta_ws, data, cfg, seed: int) -> dict:
    """K3 (both modes) and K4 against their plain versions on a streaming
    chunk: by GAP_RULE off the optimum (required), the same with one
    observed cell a row dropped from the kernels' input (required to
    fail), and at the warm start (reported)."""
    import torch

    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import loss as lk

    theta, d = off_optimum(theta_ws, seed)
    b, t_len = data.t.shape
    f_k, g_k = lk.loss(theta, data, cfg)
    v_k, _ = lk.loss(theta, data, cfg, grad=False)
    f_p, g_p = lk.loss_plain(theta, data, cfg)
    ladder = _ladder(b, data.t.device)
    fan_got = fan_k.fan(theta, d, ladder, data, cfg)
    fan_want = fan_k.fan_plain(theta, d, ladder, data, cfg)
    fan_sc = fan_scale(theta, d, ladder, data, cfg)
    gaps = loss_gaps(theta, data, cfg, {"f": (f_k, f_p), "g": (g_k, g_p),
                                        "value": (v_k, f_p)})
    gaps["fan"] = _gap(fan_got, fan_want, fan_sc, t_len)

    mask = data.mask.clone()
    mask[torch.arange(b, device=mask.device), mask.argmax(-1)] = 0.0
    dropped = data._replace(mask=mask)
    planted = loss_gaps(theta, data, cfg, {
        "f": (lk.loss(theta, dropped, cfg, grad=False)[0], f_p)})
    planted["fan"] = _gap(fan_k.fan(theta, d, ladder, dropped, cfg),
                          fan_want, fan_sc, t_len)

    fw_k, gw_k = lk.loss(theta_ws, data, cfg)
    fw_p, gw_p = lk.loss_plain(theta_ws, data, cfg)
    out = {"shape": [b, t_len, cfg.num_params], "gap": gaps,
           "tolerance": GAP_RULE,
           "max_abs_err": max(float((f_k - f_p).abs().max()),
                              float((g_k - g_p).abs().max()),
                              float((v_k - f_p).abs().max())),
           "fan_max_abs_err": float((fan_got - fan_want).abs().max()),
           "planted_dropped_cell": planted,
           "warm_start_gap_reported": loss_gaps(theta_ws, data, cfg, {
               "f": (fw_k, fw_p), "g": (gw_k, gw_p)})}
    require(within_gap_rule(gaps), f"K3/K4 on a streaming chunk: {out}")
    require(min(planted.values()) > GAP_TOL,
            f"a dropped cell passes GAP_RULE on a streaming chunk: {out}")
    return out


def stream_forward(sf, ids, device) -> tuple:
    """K1 against its plain version on the forecast's chunk of ``ids``:
    (readings, the chunk's inputs)."""
    import torch

    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.predict import (
        prepare_predict_data,
    )

    cfg = sf.config
    theta, meta, _ = sf.store.lookup(ids)
    theta = theta.to(device)
    last = meta.ds_start + meta.ds_span
    fgrid = last[:, None] + sf.store.lookup_step(ids)[:, None] \
        * np.arange(1, 15)
    pdata = prepare_predict_data(fgrid, meta, cfg, device)
    scale = torch.as_tensor(meta.y_scale, dtype=torch.float32,
                            device=device)
    floor = torch.as_tensor(meta.floor, dtype=torch.float32, device=device)
    got = fk.forward(theta, pdata, cfg, scale, floor)
    want = fk.forward_plain(theta, pdata, cfg, scale, floor)
    err = _forward_err(got, want, scale)
    require(err <= 2e-5, f"forward on a streaming forecast chunk: {err}")
    return ({"shape": list(pdata.t.shape), "max_rel_err": err,
             "max_abs_err": max(float((g - w).abs().max())
                                for g, w in zip(got, want))},
            (theta, pdata, scale, floor))


def stream_kernels(sf, batch, device) -> dict:
    """K3 (both modes), K4, K1 and K2 at the fleet path's shapes, on its
    inputs, against their plain versions: the first 8,192 series of the
    last micro-batch's union grid (K3/K4, ``hold_stream_kernels``, and
    timed at the warm start), and the forecast's 8,192 x 14 chunk (K1; K2
    at S = 256 on given draws).  Also one warm chunk's solve under the
    profiler (the card's idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet.init import curvature_diag
    from tsspark_tpu_torch.models.prophet.model import _objective
    from tsspark_tpu_torch.ops import lbfgs

    cfg, solver = sf.config, sf.backend.solver_config
    ids, theta, data = stream_chunk(sf, batch, device)
    b, t_len = data.t.shape
    held = hold_stream_kernels(theta, data, cfg, seed=5)
    _, g_k = lk.loss(theta, data, cfg)
    precond = curvature_diag(data, cfg, theta)
    d = (-precond * g_k).contiguous()
    ladder = _ladder(b, device)
    out = {"loss": {**held,
                    "ms": cuda_ms(lambda: lk.loss(theta, data, cfg)),
                    "plain_ms": cuda_ms(lambda: lk.loss_plain(
                        theta, data, cfg), iters=3, warmup=1),
                    **loss_bound_ms(b, b, t_len, cfg, True),
                    "value_mode": {
                        "ms": cuda_ms(lambda: lk.loss(theta, data, cfg,
                                                      grad=False)),
                        **loss_bound_ms(b, b, t_len, cfg, False)}},
           "fan": {"shape": [20, b, t_len],
                   "gap": held["gap"]["fan"],
                   "max_abs_err": held["fan_max_abs_err"],
                   "ms": cuda_ms(lambda: fan_k.fan(theta, d, ladder, data,
                                                   cfg)),
                   "plain_ms": cuda_ms(lambda: fan_k.fan_plain(
                       theta, d, ladder, data, cfg), iters=3, warmup=1),
                   **fan_bound_ms(b, t_len, 20, cfg)}}

    # One warm chunk's solve under the profiler.
    fun, fval, fan = _objective(data, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        res = lbfgs.minimize(fun, theta, solver, fun_value=fval,
                             precond=precond, fan_value=fan)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
    top = _device_events(prof)
    busy_ms = sum(ms for _, ms in top)
    out["warm_chunk_solve_profile"] = {
        "rows": b, "days": t_len, "iterations": int(res.n_iters.max()),
        "traced_wall_s": traced, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / 1e3 / traced,
        "top_device_ms": [(k[:60], ms) for k, ms in top[:6]]}

    # K1 and K2 on the forecast's chunk.
    k1, (theta_s, pdata, scale, floor) = stream_forward(sf, ids, device)
    out["forward"] = {**k1,
                      "ms": cuda_ms(lambda: fk.forward(theta_s, pdata, cfg,
                                                       scale, floor)),
                      "device_ms": device_ms(lambda: fk.forward(
                          theta_s, pdata, cfg, scale, floor)),
                      **forward_bound_ms(b, 14, cfg, True, True)}
    _, det, add, mult = fk.forward(theta_s, pdata, cfg)
    s = 256
    gen = torch.Generator(device=device).manual_seed(9)
    draws = bk.sample_draws((s,) + tuple(pdata.t.shape), gen, device)
    kargs = (theta_s, pdata, det, add, mult, scale, floor, cfg)
    got = bk.bands(*kargs, s, draws=draws)
    want = bk.bands_plain(*kargs, draws)
    k2_err = _band_err(got, want, scale)
    require(k2_err <= 1e-5, f"bands on the fleet's forecast chunk: {k2_err}")
    out["bands"] = {"shape": list(pdata.t.shape) + [s], "max_rel_err": k2_err,
                    "max_abs_err": max(float((got[k] - want[k]).abs().max())
                                       for k in want),
                    "ms": cuda_ms(lambda: bk.bands(*kargs, s, seed=1)),
                    **bands_bound_ms(b, 14, s, cfg)}
    return out


def _noise_gap(a, b) -> np.ndarray:
    """Per series, the largest |a - b| of two (n, 14) forecasts over the
    horizon, in units of config 5's noise."""
    return np.abs(np.asarray(a) - np.asarray(b)).max(-1) / NOISE5


def _noise_summary(d) -> dict:
    """Max, median and count over the limit of per-series noise units,
    and the max of each tenth of the series (levels rise with the
    series' index)."""
    return {"max": float(d.max()), "median": float(np.median(d)),
            "series_over_tol": int((d > FLEET_NOISE_TOL).sum()),
            "max_by_tenth": [float(x.max()) for x in np.array_split(d, 10)
                             if x.size]}


def phase_stream_fleet(device, frame, gen_s, parity) -> dict:
    """Config 5's generator and model at the M5 fleet's 30,490 series
    (``frame``, built in ``gen_s``): the warm run, a replay of its last
    micro-batch, the cold run (the first 8,192 series when the phase has
    passed ``FLEET_BUDGET_S``), each micro-batch's wall, stages, starts
    and launches; the forecasts' sMAPE, one S = 256 forecast, the path's
    kernels against their plain versions, and the 64-series subset's
    forecasts against the same series streamed on the CPU plain path, in
    units of the noise (``FLEET_NOISE_TOL``, which the rolled fault on
    that subset must fail)."""
    import torch

    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.streaming.driver import StreamingForecaster

    t_phase = time.perf_counter()
    n_days = configs.config5_size(1.0)[1]
    batches = configs.config5_batches(frame, n_days)
    sids = [f"s{i}" for i in range(FLEET_SERIES)]
    torch.cuda.reset_peak_memory_stats()

    sf = StreamingForecaster(configs.CONFIG5, configs.SOLVER5, device=device)
    t0 = time.perf_counter()
    warm_rows = _stream_drive(sf, batches)
    warm_wall = time.perf_counter() - t0
    yh_warm, sm_warm, fc_s, fc_launch = _stream_forecast(sf, sids)
    n_warm, n_cold = sf.stats.warm_starts, sf.stats.cold_starts
    # One forecast with 256-sample bands (K2).
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    fcb = sf.forecast(sids, horizon=configs.HORIZON5, num_samples=256)
    torch.cuda.synchronize()
    bands = {"wall_s": time.perf_counter() - t0, "launches": _stream_counts()}
    lo, hi = fcb.yhat_lower.to_numpy(), fcb.yhat_upper.to_numpy()
    require(np.isfinite(lo).all() and np.isfinite(hi).all()
            and bool((lo <= hi).all()), "fleet bands finite and ordered")
    del fcb, lo, hi
    kern = stream_kernels(sf, batches[-1], device)

    replay_rows = _stream_drive(sf, batches[-1:])
    yh_replay, sm_replay, _, _ = _stream_forecast(sf, sids)
    replay_delta = abs(float(sm_replay.mean()) - float(sm_warm.mean()))

    elapsed = time.perf_counter() - t_phase
    cut = elapsed + warm_wall > FLEET_BUDGET_S
    n_cold_series = FLEET_COLD_CUT if cut else FLEET_SERIES
    cold_batches = batches if not cut else [
        b[b.series_id.isin(set(sids[:n_cold_series]))] for b in batches]
    sf_cold = StreamingForecaster(configs.CONFIG5, configs.SOLVER5,
                                  device=device, warm_start=False)
    t0 = time.perf_counter()
    cold_rows = _stream_drive(sf_cold, cold_batches)
    cold_wall = time.perf_counter() - t0
    yh_cold, sm_cold, _, _ = _stream_forecast(sf_cold, sids[:n_cold_series])

    # The 64-series subset against the same series streamed alone on the
    # CPU plain path, and the rolled fault there against the sound run.
    idx = fleet_subset()
    plain = parity.get_stream("plain", "fleet")
    rolled = parity.get_stream("rolled", "fleet")
    in_cold = idx < n_cold_series
    noise = {"warm": _noise_gap(yh_warm[idx], plain["yhat_warm"]),
             "replay": _noise_gap(yh_replay[idx], plain["yhat_replay"]),
             "cold": _noise_gap(yh_cold[idx[in_cold]],
                                plain["yhat_cold"][in_cold])}
    replay_noise = _noise_gap(yh_replay, yh_warm)
    fault_noise = _noise_gap(rolled["yhat_warm"], plain["yhat_warm"])
    levels = configs.config5_truth(idx, 0.0)
    res = {
        "phase": "stream_fleet", "series": FLEET_SERIES, "days": n_days,
        "frame_s": gen_s,
        "warm": {"wall_s": warm_wall, "micro_batches": warm_rows,
                 "warm_starts": n_warm, "cold_starts": n_cold,
                 "launches": _sum_counts(warm_rows),
                 "smape_mean": float(sm_warm.mean()),
                 "smape_max": float(sm_warm.max()),
                 "forecast": {"wall_s": fc_s, "launches": fc_launch},
                 "forecast_s256": bands},
        "replay": {"micro_batch": replay_rows[0],
                   "smape_mean": float(sm_replay.mean()),
                   "smape_delta": replay_delta,
                   "vs_warm_noise_units": _noise_summary(replay_noise)},
        "cold": {"series": n_cold_series, "cut": cut, "wall_s": cold_wall,
                 "micro_batches": cold_rows,
                 "warm_starts": sf_cold.stats.warm_starts,
                 "cold_starts": sf_cold.stats.cold_starts,
                 "smape_mean": float(sm_cold.mean())},
        "kernels": kern,
        "subset_vs_plain_cpu": {
            "subset": FLEET_SUBSET, "tolerance_noise_units": FLEET_NOISE_TOL,
            "noise_units": {k: _noise_summary(v) for k, v in noise.items()},
            "rolled_fault_noise_units": _noise_summary(fault_noise),
            "per_series": {"level": levels.tolist(),
                           **{k: v.tolist() for k, v in noise.items()},
                           "rolled": fault_noise.tolist()},
            "plain_cpu_s": plain["seconds"]},
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(res)
    require((n_warm, n_cold) == (3 * FLEET_SERIES, FLEET_SERIES),
            f"fleet warm run starts: {n_warm}, {n_cold}")
    require(sf_cold.stats.warm_starts == 0
            and sf_cold.stats.cold_starts == 4 * n_cold_series,
            "fleet cold run starts")
    require(all(np.isfinite(a).all() for a in (yh_warm, yh_replay,
                                                yh_cold)),
            "fleet forecasts finite")
    require(replay_delta < REPLAY_TOL, f"fleet replay: {replay_delta}")
    require(replay_noise.max() <= FLEET_NOISE_TOL,
            f"fleet replay per series: {_noise_summary(replay_noise)}")
    require(replay_rows[0]["warm"] == FLEET_SERIES, "fleet replay warm")
    require(fc_launch["forward"] > 0, f"fleet forecast K1: {fc_launch}")
    require(bands["launches"]["bands"] > 0, f"fleet bands K2: {bands}")
    require(all(v.max() <= FLEET_NOISE_TOL for v in noise.values()),
            "fleet subset against the plain CPU run: "
            f"{res['subset_vs_plain_cpu']['noise_units']}")
    require(fault_noise.max() > FLEET_NOISE_TOL,
            f"fleet: the rolled fault passes the limit: {fault_noise.max()}")
    return res


# The full-posterior path: config 3's batch through fit_mcmc with the
# default sampler (300 warmup and 300 kept transitions of 24 leapfrog
# steps), then predict_mcmc over every day.  Its sampler is held in
# distribution against the same sampler driven by the plain loss on a
# subset of MCMC_SUBSET series: per (series, parameter), z = |mean_1 -
# mean_2| / sqrt(var_1/ESS_1 + var_2/ESS_2) from two chains of other
# seeds is a standard normal's absolute value when both sample one
# posterior, so more than Z_FRAC of z past Z_LIMIT (a standard normal puts
# 6e-5 there) or a median past Z_MEDIAN (its median is 0.674) is a fault.
MCMC_SUBSET = 64
Z_LIMIT, Z_FRAC, Z_MEDIAN = 4.0, 0.01, 1.0
DRAWS_TOL = 1e-5


def z_scores(a, b) -> np.ndarray:
    """Per (series, parameter) z of two (S, B, P) draw sets (see
    MCMC_SUBSET), ESS from ``hmc.split_rhat_ess``."""
    from tsspark_tpu_torch.ops import hmc

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    se2 = (a.var(0, ddof=1) / hmc.split_rhat_ess(a)[1]
           + b.var(0, ddof=1) / hmc.split_rhat_ess(b)[1])
    return np.abs(a.mean(0) - b.mean(0)) / np.sqrt(np.maximum(se2, 1e-30))


def plain_logdensity(data, cfg, example):
    """``model.mcmc_logdensity`` on K3's plain version (torch ops on the
    card's tensors) for parameters shaped as ``example``, replayed from a
    CUDA graph: its ~400 small launches a call captured once, so the
    reference sampler's 14,401 calls take seconds, not minutes.  Each call
    copies its argument into the graph's input and returns copies of its
    outputs; the arithmetic is the plain version's own kernels."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    def logdensity(th):
        f, g = lk.loss_plain(th, data, cfg)
        lp = -f + th[:, 2]
        grad = -g
        grad[:, 2] += 1.0
        return lp, grad

    static_in = example.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            logdensity(static_in)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = logdensity(static_in)

    def replay(th):
        static_in.copy_(th)
        graph.replay()
        return tuple(o.clone() for o in static_out)

    return replay


def draws_bound_ms(b, t_len, s, config) -> dict:
    """Least time for the posterior-draws function over (B, T) with S
    draws: the draws, the per-row inputs and the eight (B, T) outputs
    moved once; per sample-cell ~4F + 36 float32 operations (the feature
    totals' two multiply-adds a feature, the trend, the deterministic
    yhat, a simulated path step, the noise, the four means' adds and the
    two selections' O(1) share; ~4F + 46 under logistic growth), one
    Philox4x32-10 draw (40 integer multiplies) and four transcendentals
    (six under logistic growth: two sigmoids).  The units run side by
    side, so the least time is the largest of the four."""
    ncp, fs, r = (config.n_changepoints, config.num_seasonal_features,
                  config.num_regressors)
    f = fs + r
    logistic = config.growth == "logistic"
    floats = (s * b * config.num_params + (1 + r + logistic) * b * t_len
              + t_len * fs + b * ncp + b * (s + 3) + 8 * b * t_len)
    cells = b * t_len * s
    times = {
        "bytes": 4 * floats / PEAK_BYTES_PER_S * 1e3,
        "float32": cells * (4 * f + (46 if logistic else 36))
        / PEAK_F32_PER_S * 1e3,
        "integer_multiplies": cells * 40 / PEAK_INT32_MUL_PER_S * 1e3,
        "transcendentals": cells * (6 if logistic else 4)
        / PEAK_SFU_PER_S * 1e3,
    }
    by = max(times, key=times.get)
    return {"bound_ms": times[by],
            "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_parts_ms": times}


def _draw_case(rng, growth, b, t_len, s, per_series, device,
               features="mixed"):
    """Small K6 inputs: a config of every feature kind (``features``
    "mixed": 12 seasonal columns and 2 regressors; "none": no feature;
    "wide": 36 seasonal columns and 2 regressors, past 32), draws around
    a fitted-like point, synthetic data with a future (t up to 1.2), data
    scales and given variates."""
    import torch

    from tsspark_tpu_torch.config import (
        ProphetConfig,
        RegressorConfig,
        SeasonalityConfig,
    )
    from tsspark_tpu_torch.kernels import bands as bk

    weekly = SeasonalityConfig("weekly", 7.0, 3, mode="multiplicative")
    regs = (RegressorConfig("r0"),
            RegressorConfig("r1", mode="multiplicative"))
    seas, regs = {
        "mixed": ((SeasonalityConfig("yearly", 365.25, 3), weekly), regs),
        "none": ((), ()),
        "wide": ((SeasonalityConfig("yearly", 365.25, 15), weekly), regs),
    }[features]
    cfg = ProphetConfig(growth=growth, n_changepoints=10,
                        seasonalities=seas, regressors=regs)
    make = logistic_theta if growth == "logistic" else random_theta
    base = make(rng, b, cfg)
    samples = torch.from_numpy(
        (base[None] + 0.02 * rng.normal(0.0, 1.0, (s,) + base.shape))
        .astype(np.float32)).to(device)
    data = synthetic_data(rng, cfg, b, t_len, per_series, device)
    sc = torch.from_numpy(rng.uniform(1.0, 50.0, b).astype(np.float32))
    fl = torch.from_numpy(rng.uniform(0.0, 5.0, b).astype(np.float32))
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1_000_000)))
    variates = bk.sample_draws((s, b, t_len), gen, device)
    return cfg, samples, data, sc.to(device), fl.to(device), variates


def _draws_vs_plain(cfg, samples, data, sc, fl, variates) -> tuple:
    """(max |k - p| / (y_scale + |p|), max |k - p|, plain seconds) of K6
    against its plain version on the same given variates."""
    import torch

    from tsspark_tpu_torch.kernels import draws as dk

    got = dk.draws(samples, data, sc, fl, cfg, variates=variates)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = dk.draws_plain(samples, data, sc, fl, cfg, variates)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for k, v in got.items():
        require(bool(torch.isfinite(v).all()), f"draws {k} finite")
    return (_band_err(got, want, sc),
            max(float((got[k] - want[k]).abs().max()) for k in want),
            plain_s)


# K6's small shapes: (growth, S, per-series features, feature set).
DRAW_CASES = (("linear", 128, False, "mixed"), ("linear", 1024, True, "mixed"),
              ("flat", 128, False, "mixed"), ("logistic", 64, False, "mixed"),
              ("linear", 300, False, "mixed"), ("logistic", 300, True, "mixed"),
              ("linear", 1, False, "mixed"), ("linear", 128, False, "none"),
              ("linear", 300, False, "wide"), ("linear", 1024, False, "wide"))


def draws_small_cases(device) -> dict:
    """K6 against its plain version on given draws at ``DRAW_CASES``, and
    each case's rows bitwise invariant on its own Philox draws."""
    rng = np.random.default_rng(17)
    small = {}
    for growth, s, per_series, features in DRAW_CASES:
        cfg, samples, data, sc, fl, variates = _draw_case(
            rng, growth, 48, 160, s, per_series, device, features)
        err, abs_err, _ = _draws_vs_plain(cfg, samples, data, sc, fl,
                                          variates)
        name = (f"{growth}_S{s}{'_per_series' if per_series else ''}"
                f"_F{cfg.num_features}")
        small[name] = {"max_rel_err": err, "max_abs_err": abs_err,
                       "rows_bitwise": draws_row_invariance(
                           samples, data, sc, fl, cfg, device)["bitwise"]}
        require(err <= DRAWS_TOL, f"draws {name}: {err}")
    return small


def draws_row_invariance(samples, data, sc, fl, cfg, device) -> dict:
    """K6 with its own Philox draws gives a row the same bits wherever it
    sits, the row keeping its Philox coordinate: a slice launched alone,
    and the batch permuted."""
    import torch

    from tsspark_tpu_torch.kernels import draws as dk

    b = samples.shape[1]
    full = dk.draws(samples, data, sc, fl, cfg, seed=31)
    ids = torch.arange(b, dtype=torch.int32, device=device)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(3))
    perm = perm.to(device)
    lo, hi = b // 8, b // 8 + max(1, b // 4)
    for name, idx in (("slice", slice(lo, hi)), ("permuted", perm)):
        got = dk.draws(samples[:, idx].contiguous(), _rows(data, idx),
                       sc[idx].contiguous(), fl[idx].contiguous(), cfg,
                       seed=31, rows=ids[idx].contiguous())
        require(all(torch.equal(got[k], full[k][idx]) for k in full),
                f"draws: a {name} batch differs")
    torch.cuda.synchronize()
    return {"bitwise": True, "rows": [lo, hi], "permuted": b}


def nonfinite_agreement(theta, data, cfg) -> dict:
    """K3 gives a non-finite loss exactly where its plain version does, at
    points the sampler's trajectories can reach and the line search never
    priced: log_sigma at +-60, k or a changepoint's delta at 1e20, m NaN;
    each a stack of the batch's rows (a trial stack: row i on data row
    i % B)."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    b = theta.shape[0]
    ncp = cfg.n_changepoints
    parts = [theta.clone() for _ in range(6)]
    parts[1][:, 2] = 60.0
    parts[2][:, 2] = -60.0
    parts[3][:, 0] = 1e20
    parts[4][:, 1] = float("nan")
    parts[5][:, 3 + ncp // 2] = 1e20
    stack = torch.cat(parts).contiguous()
    f_k, g_k = lk.loss(stack, data, cfg)
    f_p, g_p = lk.loss_plain(stack, data, cfg)
    fin_k, fin_p = torch.isfinite(f_k), torch.isfinite(f_p)
    gfin_k = torch.isfinite(g_k).all(1)
    gfin_p = torch.isfinite(g_p).all(1)
    out = {"rows": int(stack.shape[0]),
           "f_nonfinite": [int((~fin_k[i * b:(i + 1) * b]).sum())
                           for i in range(6)],
           "f_masks_equal": bool(torch.equal(fin_k, fin_p)),
           "g_nonfinite_rows": [int((~gfin_k).sum()), int((~gfin_p).sum())],
           "g_masks_equal": bool(torch.equal(gfin_k, gfin_p))}
    require(out["f_masks_equal"],
            f"K3 and its plain version disagree on where f is finite: {out}")
    return out


def phase_mcmc(fit, device) -> dict:
    """Config 3's batch (``phase_fit``'s) through ``ProphetModel.fit_mcmc``
    with ``McmcConfig()`` on its first 1,746 days, then ``predict_mcmc``
    over all 1,941 through K6; the sampler held in distribution against
    the plain loss's, K3 against its plain version where the loss is not
    finite, K6 against its plain version on given draws (small shapes of
    the three growths, and the path's first chunk) and for bitwise row
    invariance; one short full-width sample under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsspark_tpu_torch.config import McmcConfig
    from tsspark_tpu_torch.eval import configs
    from tsspark_tpu_torch.kernels import bands as bands_k
    from tsspark_tpu_torch.kernels import draws as dk
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet import design
    from tsspark_tpu_torch.models.prophet.model import (
        ProphetModel,
        mcmc_core,
    )
    from tsspark_tpu_torch.models.prophet.predict import prepare_predict_data
    from tsspark_tpu_torch.ops import hmc

    cfg, solver = configs.CONFIG3, configs.SOLVER3
    batch = fit["inputs"]["batch"]
    n_ser, n_days = batch.y.shape
    split = configs.split_point(n_days)
    ds_fit = batch.ds[:split]
    y_fit = np.nan_to_num(batch.y[:, :split])
    m_fit = batch.mask[:, :split]
    r_fit = batch.regressors[:, :split]
    mcfg = McmcConfig()
    model = ProphetModel(cfg, solver, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hmc.timing.reset()
    # The main path: counts to 0 just before, read just after.
    lk.launches = lk.grad_launches = fan_k.launches = fk.launches = 0
    bands_k.launches = dk.launches = 0
    t0 = time.perf_counter()
    state = model.fit_mcmc(ds_fit, y_fit, mask=m_fit, regressors=r_fit,
                           mcmc_config=mcfg, seed=0)
    fit_s = time.perf_counter() - t0
    fit_stages = dict(model.stages.seconds)
    model.stages.reset()
    t0 = time.perf_counter()
    fc = model.predict_mcmc(state, batch.ds, regressors=batch.regressors,
                            seed=0)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    launches = {"loss": lk.launches, "loss_grad": lk.grad_launches,
                "loss_value": lk.launches - lk.grad_launches,
                "fan": fan_k.launches, "forward": fk.launches,
                "bands": bands_k.launches, "draws": dk.launches}
    leapfrogs, host_s = hmc.timing.leapfrogs, hmc.timing.host_s
    peak = torch.cuda.max_memory_allocated()

    n_s = mcfg.num_samples
    hmc_grad = 1 + (mcfg.num_warmup + n_s) * mcfg.num_leapfrog
    require(launches["loss_grad"] >= hmc_grad and launches["fan"] > 0
            and launches["draws"] == -(-n_ser // dk.CHUNK_ROWS),
            f"kernels launched on the MCMC path: {launches}")
    require(tuple(state.samples.shape) == (n_s, n_ser, cfg.num_params),
            "draws shape")
    require(bool(torch.isfinite(state.samples).all()), "draws finite")
    require(state.rhat.shape == state.ess.shape == (n_ser, cfg.num_params)
            and np.isfinite(state.rhat).all() and np.isfinite(state.ess).all(),
            "split-R-hat and ESS finite, one a (series, parameter)")
    for k in dk.OUTPUTS:
        require(tuple(fc[k].shape) == (n_ser, n_days), f"forecast {k} shape")
        require(bool(torch.isfinite(fc[k]).all()), f"forecast {k} finite")
    require(ordered(fc["yhat_lower"], fc["yhat_upper"], False),
            "yhat_lower <= yhat_upper")
    require(ordered(fc["trend_lower"], fc["trend_upper"], True),
            "trend_lower <= trend_upper")
    fc_np = {k: v.cpu().numpy() for k, v in fc.items()}
    sc = configs.score(batch, fc_np)
    y_hold = batch.y[:, split:]
    m_hold = batch.mask[:, split:] > 0
    inside = ((y_hold >= fc_np["yhat_lower"][:, split:])
              & (y_hold <= fc_np["yhat_upper"][:, split:]))
    acc = state.accept_rate
    out = {
        "phase": "mcmc", "series": n_ser, "days_fit": split,
        "days_forecast": n_days, "params": cfg.num_params,
        "mcmc_config": {"num_warmup": mcfg.num_warmup, "num_samples": n_s,
                        "num_leapfrog": mcfg.num_leapfrog},
        "fit_mcmc_s": fit_s, "predict_mcmc_s": predict_s,
        "stages_s": fit_stages,
        "predict_stages_s": dict(model.stages.seconds),
        "launches": launches, "loss_grad_in_hmc": hmc_grad,
        "leapfrogs": leapfrogs,
        "hmc_wall_ms_per_leapfrog": 1e3 * host_s / max(leapfrogs, 1),
        "accept_rate": {"mean": float(acc.mean()), "min": float(acc.min()),
                        "p01": float(np.quantile(acc, 0.01)),
                        "median": float(np.median(acc))},
        "divergences": {"total": int(state.divergences.sum()),
                        "chains_with_any": int((state.divergences > 0).sum())},
        "step_size_median": float(np.median(state.step_size)),
        "rhat_max": float(state.rhat.max()),
        "rhat_over_1.1_frac": float((state.rhat > 1.1).mean()),
        "ess_min": float(state.ess.min()),
        "ess_median": float(np.median(state.ess)),
        "smape_train": float(sc["smape_train"].mean()),
        "smape_holdout": float(sc["smape_holdout"].mean()),
        "holdout_coverage_80": float(inside[m_hold].mean()),
        "peak_device_bytes": peak,
    }
    emit(out)

    # The sampler in distribution: K3's chains against the plain loss's on
    # a subset, each from the MAP point with its own seed.
    idx = np.linspace(0, n_ser - 1, MCMC_SUBSET).astype(np.int64)
    data_np, _ = design.prepare_fit_data(ds_fit, y_fit[idx], cfg,
                                         mask=m_fit[idx],
                                         regressors=r_fit[idx])
    sub = design.fitdata_to_device(data_np, device)
    theta_map = state.map_state.theta[idx].to(device).contiguous()
    nonfinite = nonfinite_agreement(theta_map, sub, cfg)
    hmc.timing.reset()
    t0 = time.perf_counter()
    res_k = mcmc_core(sub, theta_map, torch.Generator(device=device)
                      .manual_seed(1), cfg, mcfg)
    torch.cuda.synchronize()
    k3_s = time.perf_counter() - t0
    sub_ms_leapfrog = 1e3 * hmc.timing.host_s / max(hmc.timing.leapfrogs, 1)
    gen = torch.Generator(device=device).manual_seed(2)
    theta0 = theta_map + mcfg.init_jitter * torch.randn(
        theta_map.shape, generator=gen, device=device)
    t0 = time.perf_counter()
    res_p = hmc.sample(plain_logdensity(sub, cfg, theta0), theta0, gen, mcfg)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    draws_k = res_k.samples.cpu().numpy()
    draws_p = res_p.samples.cpu().numpy()
    z = z_scores(draws_k, draws_p)
    rhat_k = hmc.split_rhat_ess(draws_k)[0]
    rhat_p = hmc.split_rhat_ess(draws_p)[0]
    over = z > Z_LIMIT
    sampler = {
        "subset": MCMC_SUBSET, "k3_s": k3_s, "plain_s": plain_s,
        "host_ms_per_leapfrog_k3": sub_ms_leapfrog,
        "z_median": float(np.median(z)), "z_max": float(z.max()),
        "z_over_limit_frac": float((z > Z_LIMIT).mean()),
        "limits": {"z": Z_LIMIT, "frac": Z_FRAC, "median": Z_MEDIAN},
        # Where z passes its limit: the series (subset rows) and how many
        # of their parameters, and the two chains' split-R-hat there.
        "z_over_limit_rows": {int(r): int(n) for r, n in zip(
            *np.unique(np.nonzero(over)[0], return_counts=True))},
        "rhat_max_where_over": [float(rhat_k[over].max(initial=0.0)),
                                float(rhat_p[over].max(initial=0.0))],
        "rhat_over_1.1_frac": [float((rhat_k > 1.1).mean()),
                               float((rhat_p > 1.1).mean())],
        "accept_mean": [float(res_k.accept_rate.mean()),
                        float(res_p.accept_rate.mean())],
        "divergences": [int(res_k.divergences.sum()),
                        int(res_p.divergences.sum())],
        "k3_nonfinite": nonfinite,
    }
    emit({"phase": "mcmc_sampler", **sampler})
    require(sampler["z_over_limit_frac"] <= Z_FRAC
            and sampler["z_median"] < Z_MEDIAN,
            f"K3's sampler against the plain loss's: {sampler}")
    del res_k, res_p, sub

    # K6 against its plain version on given draws: small shapes (both
    # thread caps, one draw, no feature and more than 32, a coefficient
    # table too large for shared memory at S = 1,024), then the path's
    # first chunk of rows; its rows bitwise invariant.
    small = draws_small_cases(device)
    rows = min(dk.CHUNK_ROWS, n_ser)
    meta_c = state.meta._replace(**{
        f: np.asarray(v)[:rows] for f, v in state.meta._asdict().items()})
    pdata = prepare_predict_data(batch.ds, meta_c, cfg, device,
                                 regressors=batch.regressors[:rows])
    samples_c = state.samples[:, :rows].contiguous()
    sc_c = torch.as_tensor(meta_c.y_scale, dtype=torch.float32,
                           device=device)
    fl_c = torch.as_tensor(meta_c.floor, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(23)
    variates = bands_k.sample_draws((n_s, rows, n_days), gen, device)
    err, abs_err, plain_chunk_s = _draws_vs_plain(cfg, samples_c, pdata,
                                                  sc_c, fl_c, variates)
    require(err <= DRAWS_TOL, f"draws at the path's chunk: {err}")
    del variates
    k6 = {"name": "draws", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/draws.cu",
          "replaces": "tsspark_tpu/models/prophet/predict.py:209",
          "launches": launches["draws"],
          "max_abs_err": abs_err, "max_rel_err": err,
          "tolerance": f"|k-p|/(y_scale+|p|) <= {DRAWS_TOL} (given draws)",
          "ms": cuda_ms(lambda: dk.draws(samples_c, pdata, sc_c, fl_c, cfg,
                                         seed=1), iters=10),
          "plain_ms": 1e3 * plain_chunk_s,
          "plain_ms_note": "the plain version on given draws, one call",
          **draws_bound_ms(rows, n_days, n_s, cfg),
          # No single PyTorch call computes the posterior predictive; the
          # quantiles alone (torch.quantile) refuse the chunk's 3e8
          # samples (past 2**24).
          "library_ms": None, "shape": [rows, n_days, n_s],
          "small_shapes": small,
          "row_invariance": draws_row_invariance(samples_c, pdata, sc_c,
                                                 fl_c, cfg, device),
          "whole_batch": {"shape": [n_ser, n_days, n_s],
                          **draws_bound_ms(n_ser, n_days, n_s, cfg)}}
    del pdata, samples_c

    # Where a full-width sampler's time goes: eight transitions from the
    # MAP point under the profiler.
    data_np, _ = design.prepare_fit_data(ds_fit, y_fit, cfg, mask=m_fit,
                                         regressors=r_fit)
    data = design.fitdata_to_device(data_np, device)
    del data_np
    theta_map = state.map_state.theta.to(device).contiguous()
    short = McmcConfig(num_warmup=4, num_samples=4)
    gen = torch.Generator(device=device).manual_seed(3)
    torch.cuda.synchronize()
    hmc.timing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        mcmc_core(data, theta_map, gen, cfg, short)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
    top = _device_events(prof)
    busy_ms = sum(ms for _, ms in top)
    profile_out = {
        "phase": "mcmc_profile", "rows": n_ser,
        "leapfrogs": hmc.timing.leapfrogs, "traced_wall_s": traced,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / 1e3 / traced,
        "wall_ms_per_leapfrog": 1e3 * traced / max(hmc.timing.leapfrogs, 1),
        "top_device_ms": [(k[:60], ms) for k, ms in top[:6]],
    }
    emit(profile_out)
    k6["sampler"] = {"profile": profile_out, "subset": sampler}
    return {"out": out, "kernel": k6}


def _device_events(prof):
    """(name, device ms) of the events that ran ON the card — kernels and
    copies — in a profile, longest first.  Host ops carry their children's
    device time too, so only device-side events are summed."""
    from torch.autograd import DeviceType

    evs = [(ev.key, ev.self_device_time_total / 1e3)
           for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    return sorted(evs, key=lambda kv: -kv[1])


def phase_profile(root: str, ids, device) -> dict:
    """Where a full-width request's time goes, on a fresh engine with no
    cache (every request dispatches): each request once under the torch
    profiler for the device's busy time, and once without it for the
    wall time and the host stages, read from the engine's and the
    backend's own stage clocks."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsspark_tpu_torch.serve import (
        ForecastCache,
        ParamRegistry,
        PredictionEngine,
    )

    engine = PredictionEngine(ParamRegistry.open(root),
                              cache=ForecastCache(0), device=device)
    engine.forecast(ids[:64], HORIZON)  # load the snapshot, warm up
    out = {"phase": "profile"}
    for name, n_s in (("a: all series, deterministic", 0),
                      ("c: all series, 256 samples", 256)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.forecast(ids, HORIZON, num_samples=n_s, seed=1,
                            timeout_s=600.0)
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        top = _device_events(prof)
        dev_ms = sum(ms for _, ms in top)
        engine.stats.stages.reset()
        engine.backend.stages.reset()
        t0 = time.perf_counter()
        engine.forecast(ids, HORIZON, num_samples=n_s, seed=1,
                        timeout_s=600.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = {
            "wall_s": wall, "traced_wall_s": traced_wall,
            "device_busy_ms": dev_ms,
            "device_idle_share": 1.0 - dev_ms / 1e3 / traced_wall,
            "top_device_ms": [(k[:60], ms) for k, ms in top[:5]],
            "engine_stages_s": dict(engine.stats.stages.seconds),
            "backend_stages_s": dict(engine.backend.stages.seconds),
            "backend_stage_calls": dict(engine.backend.stages.calls),
        }
    return out


def _forward_err(got, want, scale) -> float:
    """K1's rule on data-unit outputs: |k - p| / (y_scale + |p|) for
    yhat, trend and additive, |k - p| / (1 + |p|) for multiplicative."""
    units = (scale[:, None],) * 3 + (1.0,)
    return max(float(((g - w).abs() / (u + w.abs())).max())
               for g, w, u in zip(got, want, units))


def logistic_kernels(fit4, fit, device) -> list:
    """K3's, K1's and K2's logistic branches at the config-4 path's
    shapes, on its inputs: K3 (gradient and value modes) at 8192x1080 at
    the ridge init and at the fitted parameters; K3's trial-stack layout
    on a line search's 21 x 8192 trial stack (and on one of flat growth
    over config 3's first chunk, ``fit``'s); K1 and K2 on the forecast of
    the fitted batch over 1,200 days, at the forecast's chunk of rows (K2
    with 256 samples) and over the whole batch.  Each against its plain
    version, timed, its rows bitwise invariant."""
    import dataclasses

    import torch

    from tsspark_tpu_torch.eval.configs import SOLVER3
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk

    inp = fit4["inputs"]
    data, cfg = inp["data"], inp["cfg"]
    b, t_len = data.t.shape
    launches = fit4["out"]["launches"]
    gaps, abs_err = {}, 0.0
    for where in ("theta0", "theta_fit"):
        theta = inp[where]
        f_k, g_k = lk.loss(theta, data, cfg)
        v_k, _ = lk.loss(theta, data, cfg, grad=False)
        f_p, g_p = lk.loss_plain(theta, data, cfg)
        gaps[where] = loss_gaps(theta, data, cfg, {
            "f": (f_k, f_p), "g": (g_k, g_p), "value_mode": (v_k, f_p)})
        abs_err = max(abs_err, float((f_k - f_p).abs().max()),
                      float((v_k - f_p).abs().max()),
                      float((g_k - g_p).abs().max()))
        require(within_gap_rule(gaps[where]),
                f"logistic loss at {b}x{t_len} ({where}): {gaps[where]}")
    stack = {"config4": trial_stack(inp["trials"], data, cfg)}
    theta = inp["theta0"]
    k3 = {"name": "loss_logistic", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/loss.cu",
          "replaces": "tsspark_tpu/models/prophet/trend.py:97",
          "launches": launches["loss"],
          "launches_grad": launches["loss_grad"],
          "launches_value": launches["loss_value"],
          "max_abs_err": abs_err,
          "gap": gaps, "tolerance": GAP_RULE,
          "ms": cuda_ms(lambda: lk.loss(theta, data, cfg)),
          "plain_ms": cuda_ms(lambda: lk.loss_plain(theta, data, cfg),
                              iters=3, warmup=1),
          **loss_bound_ms(b, b, t_len, cfg, True),
          "library_ms": None, "shape": [b, t_len, cfg.num_params],
          "value_mode": {
              "ms": cuda_ms(lambda: lk.loss(theta, data, cfg, grad=False)),
              "plain_ms": cuda_ms(lambda: lk.loss_plain(theta, data, cfg,
                                                        grad=False),
                                  iters=3, warmup=1),
              **loss_bound_ms(b, b, t_len, cfg, False)},
          "row_invariance": loss_row_invariance(data, cfg, theta, device)}
    # Flat growth's stack: config 3's first chunk, the same line search
    # around its ridge init under flat growth.
    finp = fit["inputs"]
    fcfg = dataclasses.replace(finp["cfg"], growth="flat")
    stack["flat_config3"] = trial_stack(
        line_search_stack(finp["data"], fcfg, SOLVER3, device),
        finp["data"], fcfg)
    k3s = {"name": "loss_stack", "route": "cuda",
           "source": "tsspark_tpu_torch/csrc/loss.cu",
           "replaces": "tsspark_tpu/models/prophet/loss.py:88",
           "launches": launches["loss_stack"],
           "max_abs_err": max(v["max_abs_err"] for v in stack.values()),
           "tolerance": GAP_RULE + "; each trial the row layout's bits",
           **{k: stack["config4"][k] for k in (
               "ms", "plain_ms", "bound_ms", "bound_by", "shape")},
           "library_ms": None, "cases": stack}
    # K1 on the forecast of the fitted batch: at the launch shape of the
    # path (``predict`` takes rows in chunks whose (S, rows, T) samples
    # stay under 2**28; a sampled forecast takes K1's outputs in scaled
    # units) chunk by chunk over all 8,192 rows, and over the whole batch
    # in data units, against its plain version at phase ``forward``'s
    # tolerance.
    theta = inp["theta_fit"]
    pdata, scale, floor = inp["pdata"], inp["y_scale"], inp["floor"]
    s, rows = 256, inp["predict_chunk"]
    pb, pt = pdata.t.shape
    f_tol, f_err, f_abs = 2e-5, 0.0, 0.0
    for r0 in range(0, pb, rows):
        idx = slice(r0, min(r0 + rows, pb))
        part = (theta[idx].contiguous(), _rows(pdata, idx))
        got = fk.forward(*part, cfg)
        want = fk.forward_plain(*part, cfg)
        f_err = max(f_err, *(rel_err(g, w) for g, w in zip(got, want)))
        f_abs = max(f_abs, *(float((g - w).abs().max())
                             for g, w in zip(got, want)))
    got = fk.forward(theta, pdata, cfg, scale, floor)
    want = fk.forward_plain(theta, pdata, cfg, scale, floor)
    f_err_data = _forward_err(got, want, scale)
    for g in got:
        require(bool(torch.isfinite(g).all()), "logistic forward finite")
    del got, want
    require(max(f_err, f_err_data) <= f_tol,
            f"logistic forward at {pb}x{pt}: {f_err}, data units "
            f"{f_err_data} > {f_tol}")
    fchunk = (theta[:rows].contiguous(), _rows(pdata, slice(0, rows)))
    k1 = {"name": "forward_logistic", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/forward.cu",
          "replaces": "tsspark_tpu/models/prophet/trend.py:132",
          "launches": launches["forward"],
          "max_abs_err": f_abs, "max_rel_err": f_err,
          "max_rel_err_data_units": f_err_data,
          "tolerance": f"|k-p|/(1+|p|) <= {f_tol} (scaled units); "
                       f"|k-p|/(y_scale+|p|) <= {f_tol} (data units)",
          "ms": cuda_ms(lambda: fk.forward(*fchunk, cfg)),
          "plain_ms": cuda_ms(lambda: fk.forward_plain(*fchunk, cfg),
                              iters=3, warmup=1),
          **forward_bound_ms(rows, pt, cfg, False, False),
          "library_ms": None, "shape": [rows, pt, "shared X"],
          "whole_batch": {
              "shape": [pb, pt],
              "ms": cuda_ms(lambda: fk.forward(theta, pdata, cfg, scale,
                                               floor)),
              **forward_bound_ms(pb, pt, cfg, False, True)},
          "row_invariance": forward_row_invariance(theta, pdata, cfg, scale,
                                                   floor, device)}
    # K2 on the same forecast, 256 samples, at the path's chunk: against
    # the plain scan on given draws, chunk by chunk over all 8,192 rows;
    # timed per chunk and over the whole batch at once.
    _, det, add, mult = fk.forward(theta, pdata, cfg)
    gen = torch.Generator(device=device).manual_seed(9)
    err, abs_b, plain_s = 0.0, 0.0, 0.0
    for r0 in range(0, pb, rows):
        idx = slice(r0, min(r0 + rows, pb))
        part = _band_rows((theta, pdata, det, add, mult, scale, floor), idx)
        draws = bk.sample_draws((s, idx.stop - r0, pt), gen, device)
        got = bk.bands(*part, cfg, s, draws=draws)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = bk.bands_plain(*part, cfg, draws)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t1
        err = max(err, _band_err(got, want, part[5]))
        abs_b = max(abs_b, max(float((got[k] - want[k]).abs().max())
                               for k in want))
        del draws, got, want
    require(err <= 1e-5, f"logistic bands at {pb}x{pt}x{s}: {err}")
    kargs = (theta, pdata, det, add, mult, scale, floor)
    chunk = _band_rows(kargs, slice(0, rows))
    n_chunks = -(-pb // rows)
    k2 = {"name": "bands_logistic", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/bands.cu",
          "replaces": "tsspark_tpu/models/prophet/predict.py:185",
          "launches": launches["bands"],
          "max_abs_err": abs_b, "max_rel_err": err,
          "tolerance": "|k-p|/(y_scale+|p|) <= 1e-05 (given draws)",
          "ms": cuda_ms(lambda: bk.bands(*chunk, cfg, s, seed=1), iters=10),
          "plain_ms": 1e3 * plain_s / n_chunks,
          "plain_ms_note": f"the plain scan on given draws, mean of "
                           f"{n_chunks} chunks",
          **bands_bound_ms(rows, pt, s, cfg),
          **bands_variates_bound_ms(rows, pt, s, cfg),
          # One torch.quantile of the sampled paths would be the closest
          # library call; it refuses inputs above 2**24 elements and one
          # chunk's (256, 512, 1200) samples hold 1.6e8.
          "library_ms": None, "shape": [rows, pt, s],
          "whole_batch": {
              "shape": [pb, pt, s],
              "ms": cuda_ms(lambda: bk.bands(*kargs, cfg, s, seed=1),
                            iters=5, warmup=1),
              **bands_bound_ms(pb, pt, s, cfg),
              **bands_variates_bound_ms(pb, pt, s, cfg)},
          "row_invariance": band_row_invariance(kargs, cfg, s, device)}
    return [k3, k3s, k1, k2]


def line_search_stack(data, cfg, solver, device, k_steps=20):
    """The line search's (K + 1) B trial stack at the ridge init: K rungs
    along the preconditioned steepest-descent direction and the fallback
    row (``ops.lbfgs``'s first iteration, without the closed-form fan)."""
    import torch

    from tsspark_tpu_torch.models.prophet.init import (
        curvature_diag,
        initial_theta,
    )
    from tsspark_tpu_torch.models.prophet.model import _objective

    theta0 = initial_theta(data, cfg, solver)
    precond = curvature_diag(data, cfg, theta0)
    fun, _, _ = _objective(data, cfg)
    d = (-precond * fun(theta0)[1]).contiguous()
    steps = 0.5 ** torch.arange(k_steps, dtype=torch.float32, device=device)
    return torch.cat([(theta0[None] + steps[:, None, None] * d[None])
                      .reshape(-1, cfg.num_params), theta0]).contiguous()


def trial_stack(trials, data, cfg) -> dict:
    """K3's trial-stack layout on an (n B, P) stack: within ``GAP_TOL``
    of its plain version, each trial's values the same bits as the row
    layout's launch of that trial alone, timed beside its bound."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    b, t_len = data.t.shape
    n = trials.shape[0] // b
    s_k, _ = lk.loss(trials, data, cfg, grad=False)
    s_p, _ = lk.loss_plain(trials, data, cfg, grad=False)
    f_scale = torch.cat([loss_scales(trials[i * b:(i + 1) * b], data, cfg)[0]
                         for i in range(n)])
    gap = _gap(s_k, s_p, f_scale, t_len)
    require(gap <= GAP_TOL, f"loss on the {n}x{b} trial stack ({cfg.growth})"
            f": gap {gap}")
    require(bool(torch.isfinite(s_k).all()), "trial stack finite")
    for i in range(n):
        rows = slice(i * b, (i + 1) * b)
        alone, _ = lk.loss(trials[rows].contiguous(), data, cfg, grad=False)
        require(torch.equal(s_k[rows], alone),
                f"trial {i} of the {n}x{b} stack ({cfg.growth}) differs from "
                f"its row-layout launch")
    out = {"shape": [n * b, t_len, cfg.num_params], "gap": gap,
           "max_abs_err": float((s_k - s_p).abs().max()),
           "trials_bitwise": True,
           "ms": cuda_ms(lambda: lk.loss(trials, data, cfg, grad=False)),
           "one_trial_ms": cuda_ms(lambda: lk.loss(trials[:b].contiguous(),
                                                   data, cfg, grad=False)),
           "plain_ms": cuda_ms(lambda: lk.loss_plain(trials, data, cfg,
                                                     grad=False),
                               iters=2, warmup=1),
           **loss_bound_ms(n * b, b, t_len, cfg, False)}
    del s_k, s_p
    return out


def phase_kernels(serve, fwd, bnd, fit, fit4, mcmc, device) -> dict:
    """Each kernel at the main path's largest launch shapes, on the main
    path's inputs: held against its plain version, then timed."""
    import torch

    from tsspark_tpu_torch.backends.cuda import _slice_repeat_pad, _slice_state
    from tsspark_tpu_torch.kernels import bands as bk
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.models.prophet.predict import prepare_predict_data

    inp = serve["inputs"]
    cfg = inp["cfg"]
    c = min(8192, int(inp["state"].theta.shape[0]))  # the backend's chunk
    sub = _slice_state(inp["state"], 0, c, c)
    theta = sub.theta.to(device)
    scale = torch.as_tensor(sub.meta.y_scale, dtype=torch.float32,
                            device=device)
    floor = torch.as_tensor(sub.meta.floor, dtype=torch.float32,
                            device=device)
    f_tol, b_tol = 2e-5, 1e-5
    # K1: the in-sample + 28-day chunk over the shared calendar.
    data = prepare_predict_data(inp["ds_full"], sub.meta, cfg, device)
    b, t_len = data.t.shape
    got = fk.forward(theta, data, cfg, scale, floor)
    want = fk.forward_plain(theta, data, cfg, scale, floor)
    k1_err = _forward_err(got, want, scale)
    k1_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    require(k1_err <= f_tol, f"forward at {b}x{t_len}: {k1_err} > {f_tol}")
    del got, want
    k1_ms = cuda_ms(lambda: fk.forward(theta, data, cfg, scale, floor))
    k1_plain = cuda_ms(lambda: fk.forward_plain(theta, data, cfg, scale,
                                                floor), iters=3, warmup=1)
    # The engine's per-series chunk (horizon bucket 32).
    last = sub.meta.ds_start + sub.meta.ds_span
    step = _slice_repeat_pad(inp["step"], 0, c, c)
    grid = last[:, None] + step[:, None] * np.arange(1, 33)
    eng = prepare_predict_data(grid, sub.meta, cfg, device)
    got = fk.forward(theta, eng, cfg, scale, floor)
    want = fk.forward_plain(theta, eng, cfg, scale, floor)
    k1e_err = _forward_err(got, want, scale)
    k1e_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    require(k1e_err <= f_tol, f"forward at the engine chunk: {k1e_err}")
    k1_rows = {"in_sample": forward_row_invariance(theta, data, cfg, scale,
                                                   floor, device),
               "engine_chunk": forward_row_invariance(theta, eng, cfg, scale,
                                                      floor, device)}
    k1 = {"name": "forward", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/forward.cu",
          "replaces": "tsspark_tpu/models/prophet/design.py:377",
          "launches": serve["out"]["launches"]["forward"],
          "max_abs_err": max(k1_abs, k1e_abs),
          "max_rel_err": max(k1_err, k1e_err),
          "tolerance": f"|k-p|/(y_scale+|p|) <= {f_tol} (data units)",
          "ms": k1_ms, "plain_ms": k1_plain,
          **forward_bound_ms(b, t_len, cfg, False, True),
          "library_ms": None, "shape": [b, t_len, "shared X"],
          "per_series": {
              "shape": list(eng.t.shape),
              "ms": cuda_ms(lambda: fk.forward(theta, eng, cfg, scale,
                                               floor)),
              "device_ms": device_ms(lambda: fk.forward(theta, eng, cfg,
                                                        scale, floor)),
              **forward_bound_ms(c, 32, cfg, True, True)},
          "at_2048": {"max_abs_err_scaled": fwd["max_abs_err_scaled"]},
          "row_invariance": k1_rows}
    # K2: the engine's sampled chunk, S=256, on the engine chunk's own
    # forward outputs, with given draws so both versions see one set.
    _, det, add, mult = fk.forward(theta, eng, cfg)
    s = 256
    gen = torch.Generator(device=device).manual_seed(5)
    draws = bk.sample_draws((s, c, 32), gen, device)
    kargs = (theta, eng, det, add, mult, scale, floor, cfg)
    got = bk.bands(*kargs, s, draws=draws)
    want = bk.bands_plain(*kargs, draws)
    k2_err = _band_err(got, want, scale)
    k2_abs = max(float((got[k] - want[k]).abs().max()) for k in want)
    require(k2_err <= b_tol, f"bands at {c}x32x{s}: {k2_err} > {b_tol}")
    del got, want
    k2_ms = cuda_ms(lambda: bk.bands(*kargs, s, seed=1))
    k2_plain = cuda_ms(lambda: bk.bands_plain(*kargs, draws),
                       iters=3, warmup=1)
    del draws
    k2 = {"name": "bands", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/bands.cu",
          "replaces": "tsspark_tpu/models/prophet/predict.py:273",
          "launches": serve["out"]["launches"]["bands"],
          "max_abs_err": k2_abs, "max_rel_err": k2_err,
          "tolerance": f"|k-p|/(y_scale+|p|) <= {b_tol} (given draws)",
          "ms": k2_ms, "plain_ms": k2_plain,
          **bands_bound_ms(c, 32, s, cfg),
          **bands_variates_bound_ms(c, 32, s, cfg),
          "row_invariance": band_row_invariance(kargs[:7], cfg, s, device),
          # torch.quantile refuses inputs above 2**24 elements; the main
          # path's (256, 8192, 32) sample tensor holds 2**26.
          "library_ms": None,
          "shape": [c, 32, s],
          "at_1024": {"ms": bnd["ms"],
                      "torch_quantile_ms": bnd["torch_quantile_ms"]}}
    k1["launches_fit"] = fit["out"]["launches"]["forward"]
    kernels = [k1, k2] + fit_kernels(fit, device) \
        + logistic_kernels(fit4, fit, device) + [mcmc["kernel"]]
    # K3's gradient launches on the MCMC path (its MAP fit and sampler).
    kernels[2]["launches_mcmc_path"] = mcmc["out"]["launches"]["loss_grad"]
    for k in kernels:
        k["max_err"] = k["max_abs_err"]
    return {"kernels": kernels}


def add_stream_launches(kernels, stream5, fleet) -> None:
    """Each streaming-path kernel's entry gains its launches on the two
    streaming paths (phase stream5's whole run; the fleet's warm run, its
    replay and its cold run, its forecasts) and its checks against the
    plain version at stream5's and the fleet's shapes
    (``hold_stream_kernels``, ``stream_forward``, ``stream_kernels``)."""
    fl = {k: _sum_counts(fleet[k]["micro_batches"]) for k in ("warm",
                                                               "cold")}
    fl["replay"] = fleet["replay"]["micro_batch"]["launches"]
    refit = {k: sum(fl[r][k] for r in fl) for k in fl["warm"]}
    fc = fleet["warm"]["forecast"]["launches"]
    s256 = fleet["warm"]["forecast_s256"]["launches"]
    s5 = stream5["launches"]
    fleet_launches = {
        "loss": refit["loss_grad"] + refit["loss_value"],
        "fan": refit["fan"],
        "forward": fc["forward"] + s256["forward"],
        "bands": s256["bands"]}
    stream5_launches = {"loss": s5["loss_grad"] + s5["loss_value"],
                        "fan": s5["fan"], "forward": s5["forward"],
                        "bands": s5["bands"]}
    s5k = stream5["kernels"]
    stream5_checks = {"loss": s5k["loss_fan"]["gap"],
                      "fan": s5k["loss_fan"]["gap"]["fan"],
                      "forward": s5k["forward"]}
    for k in kernels:
        if k["name"] in fleet_launches:
            if k["name"] in stream5_checks:
                k["stream5_check"] = stream5_checks[k["name"]]
            k["launches_stream5"] = stream5_launches[k["name"]]
            k["launches_stream_fleet"] = fleet_launches[k["name"]]
            k["stream_fleet_check"] = fleet["kernels"][k["name"]]
            if k["name"] == "loss":
                k["launches_stream_fleet_grad"] = refit["loss_grad"]
                k["launches_stream_fleet_value"] = refit["loss_value"]


def fit_kernels(fit, device) -> list:
    """K3 (both modes) and K4 at the fit path's shapes, on config 3's first
    chunk: at the ridge init (the solve's first calls) and at the fitted
    parameters; K4 on the first direction of the solve."""
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import loss as lk

    inp = fit["inputs"]
    data, cfg = inp["data"], inp["cfg"]
    b, t_len = data.t.shape
    tol = GAP_RULE
    gaps, abs_f, abs_g = {}, 0.0, 0.0
    for where in ("theta0", "theta_fit"):
        theta = inp[where]
        f_k, g_k = lk.loss(theta, data, cfg)
        v_k, _ = lk.loss(theta, data, cfg, grad=False)
        f_p, g_p = lk.loss_plain(theta, data, cfg)
        gaps[where] = loss_gaps(theta, data, cfg, {
            "f": (f_k, f_p), "g": (g_k, g_p), "value_mode": (v_k, f_p)})
        abs_f = max(abs_f, float((f_k - f_p).abs().max()),
                    float((v_k - f_p).abs().max()))
        abs_g = max(abs_g, float((g_k - g_p).abs().max()))
        require(within_gap_rule(gaps[where]),
                f"loss at {b}x{t_len} ({where}): {gaps[where]}")
    theta = inp["theta0"]
    launches = fit["out"]["launches"]
    k3 = {"name": "loss", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/loss.cu",
          "replaces": "tsspark_tpu/models/prophet/loss.py:196",
          "launches": launches["loss"],
          "launches_grad": launches["loss_grad"],
          "launches_value": launches["loss_value"],
          "max_abs_err": max(abs_f, abs_g), "max_abs_err_f": abs_f,
          "gap": gaps, "tolerance": tol,
          "ms": cuda_ms(lambda: lk.loss(theta, data, cfg)),
          "plain_ms": cuda_ms(lambda: lk.loss_plain(theta, data, cfg),
                              iters=3, warmup=1),
          **loss_bound_ms(b, b, t_len, cfg, True),
          "library_ms": None, "shape": [b, t_len, cfg.num_params],
          "value_mode": {
              "launches": launches["loss_value"],
              "ms": cuda_ms(lambda: lk.loss(theta, data, cfg, grad=False)),
              "plain_ms": cuda_ms(lambda: lk.loss_plain(theta, data, cfg,
                                                        grad=False),
                                  iters=3, warmup=1),
              **loss_bound_ms(b, b, t_len, cfg, False)}}
    d = inp["direction"]
    ladder = _ladder(b, device)
    got = fan_k.fan(theta, d, ladder, data, cfg)
    want = fan_k.fan_plain(theta, d, ladder, data, cfg)
    gap = _gap(got, want, fan_scale(theta, d, ladder, data, cfg), t_len)
    require(gap <= GAP_TOL, f"fan at 20x{b}x{t_len}: gap {gap}")
    k4 = {"name": "fan", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/fan.cu",
          "replaces": "tsspark_tpu/models/prophet/loss.py:106",
          "launches": launches["fan"],
          "max_abs_err": float((got - want).abs().max()), "gap": gap,
          "tolerance": tol.replace("row", "rung"),
          "ms": cuda_ms(lambda: fan_k.fan(theta, d, ladder, data, cfg)),
          "plain_ms": cuda_ms(lambda: fan_k.fan_plain(theta, d, ladder,
                                                      data, cfg),
                              iters=3, warmup=1),
          **fan_bound_ms(b, t_len, 20, cfg),
          "library_ms": None, "shape": [20, b, t_len]}
    k3["row_invariance"] = k4["row_invariance"] = row_invariance(
        data, cfg, theta, d, ladder, device)
    return [k3, k4]


def forward_row_invariance(theta, data, cfg, scale, floor, device) -> dict:
    """K1 gives a row the same bits wherever it sits: rows 1000:1500 as a
    batch of their own, and the batch permuted."""
    import torch

    from tsspark_tpu_torch.kernels import forward as fk

    b = theta.shape[0]
    full = fk.forward(theta, data, cfg, scale, floor)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(2))
    perm = perm.to(device)
    for name, idx in (("rows 1000:1500", slice(1000, 1500)),
                      ("a permuted batch", perm)):
        got = fk.forward(theta[idx].contiguous(), _rows(data, idx), cfg,
                         scale[idx].contiguous(), floor[idx].contiguous())
        require(all(torch.equal(g, w[idx]) for g, w in zip(got, full)),
                f"forward at {tuple(data.t.shape)}: {name} differs")
    torch.cuda.synchronize()
    return {"bitwise": True, "rows": [1000, 1500], "permuted": b}


def _rows(data, idx):
    """FitData of the rows ``idx`` (a slice or an index tensor)."""
    per_row = ["t", "y", "mask", "s", "cap", "X_reg"]
    if data.X_season.ndim == 3:
        per_row.append("X_season")
    return data._replace(**{f: getattr(data, f)[idx].contiguous()
                            for f in per_row})


def row_invariance(data, cfg, theta, d, ladder, device) -> dict:
    """K3 (both modes) and K4 give a row the same bits wherever it sits:
    rows 1000:1500 launched as a batch of their own, the batch permuted,
    and (K3) a trial stack of 3B rows against three separate launches."""
    import torch

    from tsspark_tpu_torch.kernels import fan as fan_k

    out = loss_row_invariance(data, cfg, theta, device)
    b = theta.shape[0]
    sl = slice(1000, 1500)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(0))
    perm = perm.to(device)
    sub, permuted = _rows(data, sl), _rows(data, perm)
    fan = fan_k.fan(theta, d, ladder, data, cfg)
    require(torch.equal(fan_k.fan(theta[sl].contiguous(), d[sl].contiguous(),
                                  ladder[:, sl].contiguous(), sub, cfg),
                        fan[:, sl]), "fan: rows 1000:1500 alone differ")
    require(torch.equal(fan_k.fan(theta[perm].contiguous(),
                                  d[perm].contiguous(),
                                  ladder[:, perm].contiguous(), permuted, cfg),
                        fan[:, perm]), "fan: a permuted batch differs")
    torch.cuda.synchronize()
    return out


def loss_row_invariance(data, cfg, theta, device) -> dict:
    """K3 (both modes) gives a row the same bits wherever it sits: rows
    1000:1500 launched as a batch of their own, the batch permuted, and a
    trial stack of 3B rows against three separate launches."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    b = theta.shape[0]
    sl = slice(1000, 1500)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(0))
    perm = perm.to(device)
    sub, permuted = _rows(data, sl), _rows(data, perm)
    same = lambda a, c: a is None or torch.equal(a, c)  # noqa: E731
    for grad in (True, False):
        mode = "gradient" if grad else "value"
        f, g = lk.loss(theta, data, cfg, grad)
        fs, gs = lk.loss(theta[sl].contiguous(), sub, cfg, grad)
        require(same(fs, f[sl]) and (g is None or same(gs, g[sl])),
                f"loss ({mode}): rows 1000:1500 alone differ")
        fp, gp = lk.loss(theta[perm].contiguous(), permuted, cfg, grad)
        require(same(fp, f[perm]) and (g is None or same(gp, g[perm])),
                f"loss ({mode}): a permuted batch differs")
        parts = [theta, theta * 1.01, theta * 0.99]
        fst, gst = lk.loss(torch.cat(parts).contiguous(), data, cfg, grad)
        for n, part in enumerate(parts):
            fn, gn = lk.loss(part.contiguous(), data, cfg, grad)
            rows = slice(n * b, (n + 1) * b)
            require(same(fst[rows], fn) and (gn is None
                                             or same(gst[rows], gn)),
                    f"loss ({mode}): trial stack part {n} differs")
    torch.cuda.synchronize()
    return {"bitwise": True, "rows": [1000, 1500], "permuted": b,
            "loss_trial_stack": 3 * b}


# ---------------------------------------------------------------------------
# phase uncertainty: ADVI (K3 on the draw stack, K7), the quantile plane,
# interval reads, coverage and the gold audit at the M5 fleet's width
# ---------------------------------------------------------------------------

UNC_SUBSET = 64         # the ADVI parity subset (card against CPU)
UNC_CHECK_ROWS = 512    # K3's draw-stack gaps, the plane's bitwise checks
UNC_PROBES = 200
UNC_SEED = 0
# The card's ADVI against the plain CPU path on the same MAP theta and the
# same draws, per series: max over parameters of |d mu| / sd (the CPU
# posterior's) and of |d log sd|.  Read on the card (PERF.md §6):
# 2.3e-4 and 6.0e-6 (K3's sums against the plain loss's, carried through
# 200 steps); the planted faults (``ADVI_FAULTS``) 1.66 / 1.08 (the
# entropy's -1 dropped) and 80.7 / 5.73 (eps left out of the rho
# gradient).  The limits sit ~40x and ~170x above the sound readings and
# 100x below the faults.
ADVI_PARITY = {"dmu_sd": 0.01, "dlog_sd": 0.001}
ADVI_FAULTS = ("no_entropy", "no_eps_in_rho_grad")
# K7 against its plain version on the path's tensors: both take every
# operation in the same order, each rounded on its own (no FMA), so the
# same bits are required.
K7_TOL = 0.0


def advi_parity_job(ds_fit, y, mask, theta0, seed: int) -> dict:
    """The plain CPU ADVI fit of the parity subset from the card's MAP
    theta, on ``advi_draws(seed)``.  Runs in a ``ParityFits`` worker."""
    import torch

    from tsspark_tpu_torch.config import ProphetConfig
    from tsspark_tpu_torch.models.prophet.design import prepare_fit_data
    from tsspark_tpu_torch.uncertainty import advi

    torch.set_num_threads(PARITY_THREADS)
    cfg = ProphetConfig()
    data, _ = prepare_fit_data(ds_fit, y, cfg, mask=mask)
    t0 = time.perf_counter()
    post = advi.fit_advi(theta0, data, None, cfg, device="cpu",
                         draws=advi_draws(seed, theta0.shape, "cpu"))
    return {"seconds": time.perf_counter() - t0, "mu": post.mu.numpy(),
            "rho": post.rho.numpy()}


def advi_draws(seed: int, shape, device):
    """The parity fits' draws: (K, B, P) standard normals a step from one
    host generator, the same sequence on both sides."""
    import torch

    from tsspark_tpu_torch.config import AdviConfig

    gen = torch.Generator().manual_seed(seed)
    k = AdviConfig().num_elbo_samples
    return lambda _i: torch.randn((k,) + tuple(shape), generator=gen) \
        .to(device)


def advi_distance(mu, rho, ref_mu, ref_rho) -> dict:
    """Per series max over parameters of |d mu| / sd_ref and |d log sd|:
    their max and median over series."""
    dmu = (np.abs(mu - ref_mu) / np.exp(ref_rho)).max(-1)
    dsd = np.abs(rho - ref_rho).max(-1)
    return {"dmu_sd": float(dmu.max()), "dmu_sd_median": float(np.median(dmu)),
            "dlog_sd": float(dsd.max()),
            "dlog_sd_median": float(np.median(dsd))}


def within_advi_parity(d: dict) -> bool:
    return all(d[k] <= v for k, v in ADVI_PARITY.items())


def planted_advi_fault(kind: str):
    """A K7 step with one planted fault, as the plain version on the card:
    the entropy's -1 dropped from g_rho, or eps left out of it."""
    import torch

    from tsspark_tpu_torch.kernels import advi as advi_k

    real = advi_k.elbo_grads

    def grads(g, eps, sd, inv_k):
        g_mu, g_rho = real(g, eps, sd, inv_k)
        if kind == "no_entropy":
            return g_mu, g_rho + 1.0
        return g_mu, real(g, torch.ones_like(eps), sd, inv_k)[1]

    def step(*args):
        saved = advi_k.elbo_grads
        advi_k.elbo_grads = grads
        try:
            return advi_k.advi_plain(*args)
        finally:
            advi_k.elbo_grads = saved
    return step


def advi_bound_ms(k_draws, b, p) -> dict:
    """Least time for one K7 launch: g and eps (K B P each), f (K B), mu,
    rho and the four moments read once, the six states and the loss
    written once; against ~4K + 20 float32 operations a (b, p).  K7 also
    reads sd, but sd = exp(rho) is not work the function needs."""
    floats = 2 * k_draws * b * p + k_draws * b + 6 * b * p + 6 * b * p + b
    t_bytes = 4 * floats / PEAK_BYTES_PER_S * 1e3
    t_ops = b * p * (4 * k_draws + 20) / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def stack_gaps(mu, rho, eps, data, cfg) -> dict:
    """K3 (both modes) on a draw stack against its plain version by
    GAP_RULE, each draw held to its own rows' scale; the same with one
    observed cell a row dropped (required to fail); the plain float32
    version against float64 by the same rule (the rule holds K3 only where
    float32 itself is within it)."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.uncertainty.advi import _stack

    k_draws, b, p = eps.shape
    _, stack = _stack(mu, rho, eps)
    f_k, g_k = lk.loss(stack, data, cfg)
    v_k, _ = lk.loss(stack, data, cfg, grad=False)
    f_p, g_p = lk.loss_plain(stack, data, cfg)
    mask = data.mask.clone()
    mask[torch.arange(b, device=mask.device), mask.argmax(-1)] = 0.0
    dropped = data._replace(mask=mask)
    f_drop, _ = lk.loss(stack, dropped, cfg, grad=False)
    data64 = data._replace(**{f: getattr(data, f).double()
                              for f in data._fields})
    f64, g64 = lk.loss_plain(stack.double(), data64, cfg)
    gaps, planted, plain64 = {}, [], {}
    rows = lambda x, k: x[k * b:(k + 1) * b]  # noqa: E731
    for k in range(k_draws):
        th = rows(stack, k)
        gk = loss_gaps(th, data, cfg, {
            "f": (rows(f_k, k), rows(f_p, k)),
            "g": (rows(g_k, k), rows(g_p, k)),
            "value_mode": (rows(v_k, k), rows(f_p, k))})
        for name, v in gk.items():
            gaps[name] = max(gaps.get(name, 0.0), v)
        planted.append(loss_gaps(th, data, cfg, {
            "f": (rows(f_drop, k), rows(f_p, k))})["f"])
        pk = loss_gaps(th, data, cfg, {
            "f": (rows(f_p, k).double(), rows(f64, k)),
            "g": (rows(g_p, k).double(), rows(g64, k))})
        for name, v in pk.items():
            plain64[name] = max(plain64.get(name, 0.0), v)
    torch.cuda.synchronize()
    return {"gap": gaps, "planted_dropped_cell": min(planted),
            "plain_f32_vs_f64": plain64,
            "max_abs_err": max(float((f_k - f_p).abs().max()),
                               float((g_k - g_p).abs().max()),
                               float((v_k - f_p).abs().max()))}


def draw_stack_bits(stack, data, cfg, k_draws, f, g) -> dict:
    """K3's draw-stack launch (``f``, ``g`` on the (K B, P) ``stack``)
    against each draw's rows launched alone (the row layout, N = B): the
    same bits are required."""
    import torch

    from tsspark_tpu_torch.kernels import loss as lk

    b = stack.shape[0] // k_draws
    same, err = True, 0.0
    for k in range(k_draws):
        rows = slice(k * b, (k + 1) * b)
        fk, gk = lk.loss(stack[rows].contiguous(), data, cfg)
        same = same and torch.equal(f[rows], fk) and torch.equal(g[rows], gk)
        err = max(err, float((f[rows] - fk).abs().max()),
                  float((g[rows] - gk).abs().max()))
    torch.cuda.synchronize()
    return {"bitwise": bool(same), "max_abs_err": err}


def k7_check(state, g, f, eps, sd, step, advi) -> dict:
    """K7 against its plain version on clones of the path's tensors."""
    import torch

    from tsspark_tpu_torch.kernels import advi as advi_k

    sc = advi_k.adam_scalars(advi, step)
    mine = [x.clone() for x in state]
    plain = [x.clone() for x in state]
    got = advi_k.advi_step(g, f, eps, sd, *mine, sc)
    want = advi_k.advi_plain(g, f, eps, sd, *plain, sc)
    torch.cuda.synchronize()
    pairs = [(got, want)] + list(zip(mine, plain))
    err = max(float((a - c).abs().max()) for a, c in pairs)
    same = all(torch.equal(a, c) for a, c in pairs)
    require(same and err <= K7_TOL,
            f"advi at step {step}: max |k-p| {err}, bitwise {same}")
    return {"bitwise": same, "max_abs_err": err}


def phase_uncertainty(serve, device, parity) -> dict:
    """The uncertainty tier at the M5 fleet's width (``run_calibration_
    smoke``'s recipe): serve's ``m5_like(30490, 1941)`` batch under
    ``ProphetConfig()``, the last 28 days withheld; the MAP fit through
    ``CudaBackend.fit`` (``SolverConfig(max_iters=25)``), ``publish``,
    ``fit_advi`` at ``AdviConfig()`` (K3 on the 121,960-row draw stack,
    K7), ``save_posterior``, ``qplane.maybe_publish`` (ADVI mode),
    ``evaluate_version``, 200 reads through ``PredictionEngine.quantiles``,
    512 reads of a version without a posterior (MAP mode: K1), and
    ``gold.audit_version`` (8 rows, ``McmcConfig()``).  Then the checks:
    K3 on the draw stack by GAP_RULE, K7 against its plain version, the
    card's ADVI against the plain CPU path on 64 series (with planted
    faults), the plane against ``compute_rows``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsspark_tpu_torch.backends.registry import get_backend
    from tsspark_tpu_torch.config import (
        AdviConfig,
        ProphetConfig,
        SolverConfig,
    )
    from tsspark_tpu_torch.kernels import advi as advi_k
    from tsspark_tpu_torch.kernels import fan as fan_k
    from tsspark_tpu_torch.kernels import forward as fk
    from tsspark_tpu_torch.kernels import loss as lk
    from tsspark_tpu_torch.models.prophet.design import (
        fitdata_to_device,
        prepare_fit_data,
    )
    from tsspark_tpu_torch.ops import hmc
    from tsspark_tpu_torch.serve import (
        ForecastCache,
        ParamRegistry,
        PredictionEngine,
    )
    from tsspark_tpu_torch.uncertainty import advi as advi_mod
    from tsspark_tpu_torch.uncertainty import calibrate, gold, qplane

    cfg, advi = ProphetConfig(), AdviConfig()
    batch = serve["inputs"]["batch"]
    n, days = batch.y.shape
    cut = days - calibrate.DEFAULT_HOLDOUT
    ds_fit = batch.ds[:cut]
    y_fit = np.nan_to_num(batch.y[:, :cut])
    m_fit = batch.mask[:, :cut]
    ids = batch.series_ids
    stages = {}

    def stage(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    root = tempfile.mkdtemp(prefix="uncertainty_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hmc.timing.reset()
        # The main path: counts to 0 just before, read just after.
        lk.launches = lk.grad_launches = lk.stack_launches = 0
        fk.launches = advi_k.launches = fan_k.launches = 0
        bk = get_backend("cuda", cfg, SolverConfig(max_iters=25),
                         device=device)
        state = stage("map_fit", bk.fit, ds_fit, y_fit, mask=m_fit)
        reg = ParamRegistry(root, cfg)
        v = stage("publish", reg.publish, state, ids, step=np.ones(n))
        data_np, _ = stage("advi_prep", prepare_fit_data, ds_fit, y_fit,
                           cfg, mask=m_fit)
        theta0 = np.nan_to_num(state.theta.cpu().numpy().astype(np.float32))
        before = (lk.stack_launches, lk.grad_launches)
        t0 = time.perf_counter()
        post = advi_mod.fit_advi(
            theta0, data_np, torch.Generator(device=device)
            .manual_seed(UNC_SEED), cfg, advi, device=device)
        torch.cuda.synchronize()
        stages["fit_advi"] = time.perf_counter() - t0
        k7_path = advi_k.launches
        # K3's draw-stack launches in fit_advi (gradient mode, all of them).
        k3_draw_path = lk.stack_launches - before[0]
        k3_grad_path = lk.grad_launches - before[1]
        stage("save_posterior", advi_mod.save_posterior,
              reg.version_dir(v), post, seed=UNC_SEED,
              num_steps=advi.num_steps)
        pub = stage("qplane_publish", qplane.maybe_publish, reg, v, bk,
                    horizons=(7, 14, 28))
        calib = stage("evaluate", calibrate.evaluate_version, reg, v,
                      batch.ds[cut:], batch.y[:, cut:],
                      mask_future=batch.mask[:, cut:])
        eng = PredictionEngine(reg, cache=ForecastCache(0), device=device)
        rng = np.random.default_rng(UNC_SEED)
        walls = []
        t0 = time.perf_counter()
        for _ in range(UNC_PROBES):
            k = int(rng.integers(1, 9))
            sel = [ids[i] for i in np.sort(rng.choice(n, k, replace=False))]
            h = int(rng.choice((7, 14, 28)))
            t1 = time.perf_counter()
            eng.quantiles(sel, h)
            walls.append((time.perf_counter() - t1) * 1e3)
        stages["reads"] = time.perf_counter() - t0
        reads = {"probes": UNC_PROBES,
                 "p50_ms": float(np.percentile(walls, 50)),
                 "p99_ms": float(np.percentile(walls, 99)),
                 "qplane_hits": eng.stats.qplane_hits,
                 "qplane_misses": eng.stats.qplane_misses}
        plane_view = qplane.attach(reg.version_dir(v))
        n_chk = min(UNC_CHECK_ROWS, n)
        sel512 = list(ids[:n_chk])
        eng_advi = {h: eng.quantiles(sel512, h) for h in (7, 14, 28)}
        # A version without a posterior: MAP-mode intervals (K1).
        v_map = reg.publish(state, ids, step=np.ones(n))
        eng_map = PredictionEngine(reg, cache=ForecastCache(0),
                                   device=device)
        k1_before = fk.launches
        map_res = stage("reads_map_mode", eng_map.quantiles, sel512, 28)
        k1_map = fk.launches - k1_before
        require(map_res.version == v_map
                and eng_map.stats.qplane_misses == n_chk,
                "MAP-mode reads: served by the version without a posterior")
        hmc.timing.reset()
        audit = stage("gold", gold.audit_version, reg, version=v,
                      arrays=(ds_fit, y_fit, m_fit, None), device=device)
        launches = {"loss": lk.launches, "loss_grad": lk.grad_launches,
                    "loss_value": lk.launches - lk.grad_launches,
                    "loss_stack": lk.stack_launches,
                    "loss_draw_stack_in_fit_advi": k3_draw_path,
                    "fan": fan_k.launches, "forward": fk.launches,
                    "advi": advi_k.launches}
        gold_leapfrogs, gold_host_s = hmc.timing.leapfrogs, hmc.timing.host_s
        peak = torch.cuda.max_memory_allocated()

        require(k7_path == advi.num_steps and launches["advi"] == k7_path,
                f"K7 launches on the path: {launches}")
        require(k3_draw_path >= advi.num_steps
                and k3_grad_path == k3_draw_path,
                f"K3's draw-stack layout on fit_advi's path: {launches}")
        require(launches["loss_grad"] >= advi.num_steps
                and launches["fan"] > 0 and launches["forward"] > 0
                and k1_map > 0,
                f"kernels launched on the uncertainty path: {launches}")
        mu, rho = post.mu.cpu().numpy(), post.rho.cpu().numpy()
        elbo = post.elbo.cpu().numpy()
        require(mu.shape == rho.shape == (n, cfg.num_params)
                and elbo.shape == (n,), "posterior shapes")
        finite = {"mu": bool(np.isfinite(mu).all()),
                  "rho": bool(np.isfinite(rho).all()),
                  "elbo": bool(np.isfinite(elbo).all())}
        require(all(finite.values()), f"posterior finite: {finite}")
        require(pub is not None and pub["status"] == "published"
                and pub["mode"] == "advi", f"qplane publish: {pub}")
        require(calib is not None and calib["mode"] == "advi",
                f"evaluate_version: {calib}")
        # The plane: finite, ordered, its columns the compute path's bits
        # on 512 rows, the engine's reads the plane's and compute's bits.
        plane_checks = {}
        for hb in plane_view.buckets:
            cols = {pm: np.asarray(c) for pm, c in
                    plane_view.columns[hb].items()}
            require(all(np.isfinite(c).all() for c in cols.values()),
                    f"plane bucket {hb} finite")
            require(bool((cols[100] <= cols[500]).all()
                         and (cols[500] <= cols[900]).all()),
                    f"plane bucket {hb}: q100 <= q500 <= q900")
            idx = np.arange(n_chk)
            ref = qplane.compute_rows(reg.load(v), cfg, bk, idx, hb,
                                      posterior=post)
            require(all(np.array_equal(cols[pm][idx], ref[pm])
                        for pm in ref),
                    f"plane bucket {hb} != compute_rows on 512 rows")
            h = {8: 7, 16: 14, 32: 28}[hb]
            res = eng_advi[h]
            require(all(np.array_equal(res.values[f"q{pm:03d}"],
                                       ref[pm][:, :h]) for pm in ref),
                    f"engine.quantiles(h={h}) != compute_rows")
            plane_checks[str(hb)] = "bitwise (512 rows), finite, ordered"
        for k, val in map_res.values.items():
            require(np.isfinite(val).all(), f"MAP-mode {k} finite")
        require(bool((map_res.values["q100"] <= map_res.values["q500"])
                     .all() and (map_res.values["q500"]
                                 <= map_res.values["q900"]).all()),
                "MAP-mode quantiles ordered")
        require(audit is not None and np.isfinite(audit["qdiv_max"])
                and np.isfinite(audit["rhat_max"])
                and np.isfinite(audit["ess_min"]), f"gold audit: {audit}")

        # The path's loop replayed step by step from the same generator
        # (it must land on fit_advi's bits): the first and the last step's
        # tensors for the kernel checks, the first step's for the times.
        data = fitdata_to_device(data_np, device)
        del data_np
        gen = torch.Generator(device=device).manual_seed(UNC_SEED)
        shape = (advi.num_elbo_samples, n, cfg.num_params)
        st = advi_mod.init_state(torch.from_numpy(theta0).to(device), advi)
        eps0 = torch.randn(shape, generator=gen, device=device)
        state0 = [x.clone() for x in st]
        sd0, stack0 = advi_mod._stack(st.mu, st.rho, eps0)
        f0, g0 = lk.loss(stack0, data, cfg)
        bits_first = draw_stack_bits(stack0, data, cfg,
                                     advi.num_elbo_samples, f0, g0)
        require(bits_first["bitwise"],
                f"K3's draw stack at the first step: each draw against "
                f"its row-layout launch: {bits_first}")
        k3_ms = cuda_ms(lambda: lk.loss(stack0, data, cfg), iters=10)
        k3_row_ms = cuda_ms(lambda: [
            lk.loss(stack0[k * n:(k + 1) * n], data, cfg)
            for k in range(advi.num_elbo_samples)], iters=5)
        k3_plain_ms = cuda_ms(lambda: lk.loss_plain(stack0, data, cfg),
                              iters=1, warmup=1)
        sc0 = advi_k.adam_scalars(advi, 0)
        tmp = [x.clone() for x in state0]
        k7_ms = cuda_ms(lambda: advi_k.advi_step(g0, f0, eps0, sd0, *tmp,
                                                 sc0))
        tmp = [x.clone() for x in state0]
        k7_plain_ms = cuda_ms(lambda: advi_k.advi_plain(
            g0, f0, eps0, sd0, *tmp, sc0), iters=3, warmup=1)
        tmp = [x.clone().requires_grad_() for x in state0[:2]]
        for x, gr in zip(tmp, (g0[:n], g0[n:2 * n])):
            x.grad = gr.clone()
        adam = torch.optim.Adam(tmp, lr=advi.learning_rate,
                                betas=(advi.adam_b1, advi.adam_b2),
                                eps=advi.adam_eps, fused=True)
        adam_ms = cuda_ms(adam.step)
        del tmp, adam
        step_ms = 1e3 * stages["fit_advi"] / advi.num_steps
        # Five steps under the profiler, on a copy: the card's idle share.
        cp = advi_mod.AdviState(*[x.clone() for x in state0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for i in range(5):
                advi_mod.elbo_step(cp, data, cfg, eps0, i, advi)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t1
        top = _device_events(prof)
        busy_ms = sum(ms for _, ms in top)
        del cp
        # The step's device work by CUDA events, part by part (the draws,
        # the stack, K3, K7): the idle share where the profiler records
        # no device event.
        parts_ms = k3_ms + k7_ms + cuda_ms(lambda: torch.randn(
            shape, generator=torch.Generator(device=device), device=device)) \
            + cuda_ms(lambda: advi_mod._stack(state0[0], state0[1], eps0))
        k7_first = k7_check(state0, g0, f0, eps0, sd0, 0, advi)
        advi_mod.elbo_step(st, data, cfg, eps0, 0, advi)
        for i in range(1, advi.num_steps - 1):
            advi_mod.elbo_step(st, data, cfg, torch.randn(
                shape, generator=gen, device=device), i, advi)
        eps_last = torch.randn(shape, generator=gen, device=device)
        state_last = [x.clone() for x in st]
        sd_l, stack_l = advi_mod._stack(st.mu, st.rho, eps_last)
        f_l, g_l = lk.loss(stack_l, data, cfg)
        bits_last = draw_stack_bits(stack_l, data, cfg,
                                    advi.num_elbo_samples, f_l, g_l)
        require(bits_last["bitwise"],
                f"K3's draw stack at the last step: each draw against "
                f"its row-layout launch: {bits_last}")
        k7_last = k7_check(state_last, g_l, f_l, eps_last, sd_l,
                           advi.num_steps - 1, advi)
        advi_mod.elbo_step(st, data, cfg, eps_last, advi.num_steps - 1, advi)
        require(torch.equal(st.mu, post.mu) and torch.equal(st.rho, post.rho),
                "the replayed ADVI loop differs from fit_advi's bits")

        # K3 on the draw stack (first 512 series x 4 draws) by GAP_RULE at
        # the first and the last step.
        r = slice(0, n_chk)
        sub = _rows(data, r)
        first = stack_gaps(state0[0][r].contiguous(),
                           state0[1][r].contiguous(),
                           eps0[:, r].contiguous(), sub, cfg)
        require(within_gap_rule(first["gap"]),
                f"K3 on the first-step draw stack: {first}")
        require(first["planted_dropped_cell"] > GAP_TOL,
                f"a dropped cell passes GAP_RULE on the draw stack: {first}")
        last = stack_gaps(state_last[0][r].contiguous(),
                          state_last[1][r].contiguous(),
                          eps_last[:, r].contiguous(), sub, cfg)
        last["held"] = within_gap_rule(last["plain_f32_vs_f64"])
        if last["held"]:
            require(within_gap_rule(last["gap"]),
                    f"K3 on the last-step draw stack: {last}")
        del data, sub, st, stack_l, g_l, f_l, stack0, g0, f0

        # The card's ADVI against the plain CPU path on 64 series: the
        # card's MAP theta, the same host draws.
        idx = np.linspace(0, n - 1, UNC_SUBSET).astype(np.int64)
        th_sub = theta0[idx]
        job = parity.submit(advi_parity_job, ds_fit, y_fit[idx], m_fit[idx],
                            th_sub, UNC_SEED + 1)
        sub_np, _ = prepare_fit_data(ds_fit, y_fit[idx], cfg,
                                     mask=m_fit[idx])
        card = advi_mod.fit_advi(th_sub, sub_np, None, cfg, device=device,
                                 draws=advi_draws(UNC_SEED + 1,
                                                  th_sub.shape, device))
        faults = {}
        for kind in ADVI_FAULTS:
            saved = advi_k.advi_step
            advi_k.advi_step = planted_advi_fault(kind)
            try:
                bad = advi_mod.fit_advi(
                    th_sub, sub_np, None, cfg, device=device,
                    draws=advi_draws(UNC_SEED + 1, th_sub.shape, device))
            finally:
                advi_k.advi_step = saved
            faults[kind] = (bad.mu.cpu().numpy(), bad.rho.cpu().numpy())
        t1 = time.perf_counter()
        cpu = job.get()
        wait_s = time.perf_counter() - t1
        sound = advi_distance(card.mu.cpu().numpy(), card.rho.cpu().numpy(),
                              cpu["mu"], cpu["rho"])
        planted = {k: advi_distance(m, rr, cpu["mu"], cpu["rho"])
                   for k, (m, rr) in faults.items()}
        advi_parity = {"subset": UNC_SUBSET, "cpu_s": cpu["seconds"],
                       "wait_s": wait_s, "limits": ADVI_PARITY,
                       "card_vs_cpu": sound, "planted": planted}
        emit({"phase": "uncertainty_parity", **advi_parity})
        require(within_advi_parity(sound),
                f"the card's ADVI against the CPU's: {advi_parity}")
        require(not any(within_advi_parity(d) for d in planted.values()),
                f"a planted ADVI fault passes the parity limits: "
                f"{advi_parity}")
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)

    sd = np.exp(rho)
    out = {
        "phase": "uncertainty", "series": n, "days_fit": cut,
        "holdout": calibrate.DEFAULT_HOLDOUT, "params": cfg.num_params,
        "advi": {"num_steps": advi.num_steps,
                 "num_elbo_samples": advi.num_elbo_samples,
                 "stack_rows": advi.num_elbo_samples * n},
        "stages_s": stages,
        "map_fit_backend_stages_s": dict(bk.stages.seconds),
        "launches": launches, "launches_k1_map_mode_reads": k1_map,
        "ms_per_advi_step": {
            "wall": step_ms, "k3": k3_ms, "k7": k7_ms,
            "rest_torch_ops_and_host": step_ms - k3_ms - k7_ms},
        "advi_profile_5_steps": {
            "traced_wall_s": traced,
            "device_busy_ms": busy_ms if top else "not measured",
            "device_idle_share": (1.0 - busy_ms / 1e3 / traced if top
                                  else "not measured: the profiler "
                                  "recorded no device event"),
            "top_device_ms": [(k[:60], ms) for k, ms in top[:6]]},
        "device_ms_per_step_event_timed_parts": parts_ms,
        "idle_share_from_event_timed_parts": 1.0 - parts_ms / step_ms,
        "peak_device_bytes": peak,
        "posterior_sd": {
            "quantiles_all": {str(q): float(np.quantile(sd, q))
                              for q in (0.01, 0.1, 0.5, 0.9, 0.99)},
            "median_by_block": {
                "k": float(np.median(sd[:, 0])),
                "m": float(np.median(sd[:, 1])),
                "log_sigma": float(np.median(sd[:, 2])),
                "delta": float(np.median(sd[:, 3:3 + cfg.n_changepoints])),
                "beta": float(np.median(sd[:, 3 + cfg.n_changepoints:]))}},
        "elbo_median": float(np.median(elbo)),
        "qplane": {k: pub[k] for k in ("mode", "buckets", "nbytes",
                                       "publish_s")},
        "coverage_abs_gap": calib["coverage_abs_gap"],
        "coverage": {hb: {"interval_empirical": r["interval_empirical"],
                          "coverage_abs_gap": r["coverage_abs_gap"],
                          "n_cells": r["n_cells"],
                          "quantile_empirical": {
                              str(pm): g["empirical"] for pm, g in
                              r["quantile_gaps"].items()}}
                     for hb, r in calib["buckets"].items()},
        "reads": reads, "plane_checks": plane_checks,
        "gold": {k: audit[k] for k in ("rows", "qdiv_max", "qdiv_mean",
                                       "rhat_max", "ess_min", "accept_mean",
                                       "hmc_divergences")},
        "gold_host_ms_per_leapfrog": 1e3 * gold_host_s
        / max(gold_leapfrogs, 1),
        "gold_leapfrogs": gold_leapfrogs,
        "k3_draw_stack": {"first_step": first, "last_step": last,
                          "row_layout_bits": {"first_step": bits_first,
                                              "last_step": bits_last}},
        "k7": {"first_step": k7_first, "last_step": k7_last},
    }
    emit(out)
    kb = advi.num_elbo_samples * n
    k7 = {"name": "advi", "route": "cuda",
          "source": "tsspark_tpu_torch/csrc/advi.cu",
          "replaces": "tsspark_tpu/uncertainty/advi.py:87",
          "launches": launches["advi"],
          "max_abs_err": max(k7_first["max_abs_err"],
                             k7_last["max_abs_err"]),
          "tolerance": "bitwise (the plain version's operation order)",
          "ms": k7_ms, "plain_ms": k7_plain_ms,
          **advi_bound_ms(advi.num_elbo_samples, n, cfg.num_params),
          # No single PyTorch call computes the ELBO's reduction over the
          # draws and the Adam step; torch.optim.Adam(fused=True) on the
          # same (B, P) parameters, the update alone, as a yardstick.
          "library_ms": None, "adam_fused_update_only_ms": adam_ms,
          "shape": [advi.num_elbo_samples, n, cfg.num_params]}
    k3_stack = {"shape": [kb, cut, cfg.num_params],
                "source": "tsspark_tpu_torch/csrc/loss_draws.cuh",
                "layout": "draw stack (csrc/loss_draws.cuh draw_kernel: a warp "
                          "a series' 4 draws)",
                "ms": k3_ms, "plain_ms": k3_plain_ms,
                "row_layout_ms": k3_row_ms,
                "launches": launches["loss_draw_stack_in_fit_advi"],
                "max_abs_err": max(first["max_abs_err"],
                                   last["max_abs_err"]),
                "tolerance": GAP_RULE + " (512 series x 4 draws)",
                "max_abs_err_vs_row_layout": max(
                    bits_first["max_abs_err"], bits_last["max_abs_err"]),
                "tolerance_vs_row_layout": "bitwise",
                "library_ms": None,
                **loss_bound_ms(kb, n, cut, cfg, True),
                "gap": {"first_step": first["gap"],
                        "last_step": last["gap"]}}
    return {"out": out, "kernel": k7, "k3_stack": k3_stack}


def add_uncertainty(kernels, unc) -> None:
    """K7's entry joins the kernels line; K3's gains the ADVI draw stack
    (gradient, the draw-stack layout: each data row read once for a
    series' four draws)."""
    for k in kernels:
        if k["name"] == "loss":
            k["advi_draw_stack"] = unc["k3_stack"]
    kernels.append(unc["kernel"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from tsspark_tpu_torch.device import resolve_device
    from tsspark_tpu_torch.kernels import build

    t_start = time.perf_counter()
    device = resolve_device(None)
    smi = smi_line()
    build.library()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build.build_seconds,
          "ptxas": {k: [ln for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in build.ptxas_log.items()}})
    rng = np.random.default_rng(args.seed)
    phases_s = {"device": time.perf_counter() - t_start}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phases_s[name] = time.perf_counter() - t0
        return out

    from tsspark_tpu_torch.data.datasets import m5_like, wiki_logistic_like

    t0 = time.perf_counter()
    batch3 = m5_like(FULL_SERIES, FULL_DAYS, seed=2)
    gen3_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch4 = wiki_logistic_like(C4_SERIES, C4_DAYS)
    gen4_s = time.perf_counter() - t0
    from tsspark_tpu_torch.eval import configs

    t0 = time.perf_counter()
    n5, days5 = configs.config5_size(1.0)
    stream5_df = configs.config5_frame(n5, days5)
    fleet_df = configs.config5_frame(FLEET_SERIES, days5)
    fleet_sub = fleet_df[fleet_df.series_id.isin(
        {f"s{i}" for i in fleet_subset()})]
    gen5_s = time.perf_counter() - t0
    phases_s["data"] = gen3_s + gen4_s + gen5_s
    parity = ParityFits(batch3, batch4, stream5_df, fleet_sub)
    finished = False
    try:
        fwd = timed("forward", phase_forward, rng, device)
        bnd = timed("bands", phase_bands, rng, device)
        timed("loss", phase_loss, rng, device)
        timed("fan", phase_fan, rng, device)
        serve = timed("serve", phase_serve, args, device)
        fit = timed("fit", phase_fit, device, batch3, gen3_s, parity)
        mcmc = timed("mcmc", phase_mcmc, fit, device)
        fit4 = timed("fit_logistic", phase_fit_logistic, device, batch4,
                     gen4_s, parity)
        stream5 = timed("stream5", phase_stream5, device, parity)
        fleet = timed("stream_fleet", phase_stream_fleet, device, fleet_df,
                      gen5_s, parity)
        del fleet_df
        unc = timed("uncertainty", phase_uncertainty, serve, device, parity)
        kernels = timed("kernels", phase_kernels, serve, fwd, bnd, fit,
                        fit4, mcmc, device)
        add_stream_launches(kernels["kernels"], stream5, fleet)
        add_uncertainty(kernels["kernels"], unc)
        finished = True
    finally:
        parity.close(finished)
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start,
          "phases_s": phases_s})
    emit(kernels)
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
