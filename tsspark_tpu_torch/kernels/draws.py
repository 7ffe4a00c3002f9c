"""K6 ``draws``: the posterior-predictive forecast from MCMC draws as one
CUDA kernel.

``draws`` is the wrapper ``predict.forecast_from_draws`` calls.  On a CPU
tensor it runs the plain PyTorch version, ``draws_plain`` (the JAX
package's ``forecast_from_draws`` a draw at a time: ``trend_fn``,
``seasonal_split``, ``predict._simulate_trends`` and the noise, then
``bands.quantile_linear`` across the draws); on a CUDA tensor it launches
``csrc/draws.cu`` once per chunk of ``CHUNK_ROWS`` rows, or raises.
``launches`` counts kernel launches.

Variates: the kernel draws its own from a Philox4x32-10 counter (stream
1, where K2 draws on stream 0); the plain version draws from a
``torch.Generator``.  Both accept GIVEN variates instead, ``(u, laplace,
normal)`` of shape (S, B, T) each, the three the JAX package draws per
posterior draw (its ``k_bern``, ``k_lap`` and ``k_noise`` keys), so either
can be held against the other, or against the JAX package, on the same
numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tsspark_tpu_torch.config import ProphetConfig
from tsspark_tpu_torch.kernels import COUNT_LOCK, build
from tsspark_tpu_torch.kernels.bands import (
    Draws,
    quantile_linear,
    quantile_points,
    sample_draws,
)
from tsspark_tpu_torch.kernels.forward import GROWTH_CODES, _require

#: Kernel launches since the count was last set to 0.
launches = 0


def _count() -> None:
    """One launch, counted under ``COUNT_LOCK`` (two threads may launch)."""
    global launches
    with COUNT_LOCK:
        launches += 1


#: The most draws the kernel takes: one block a row, a thread a draw.
MAX_SAMPLES = 1024

#: Rows a launch takes on the card (its (B, P, S) copy of the draws).
CHUNK_ROWS = 512

OUTPUTS = ("yhat", "trend", "additive", "multiplicative", "yhat_lower",
           "yhat_upper", "trend_lower", "trend_upper")


def draw_rates(samples: torch.Tensor, data, config: ProphetConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) changepoint probability of a future step and (S, B) Laplace
    scale of each draw's simulated deltas (``predict.step_cp_prob`` and
    ``predict.laplace_scale``), computed once for both versions."""
    from tsspark_tpu_torch.models.prophet.params import unpack
    from tsspark_tpu_torch.models.prophet.predict import (
        laplace_scale,
        step_cp_prob,
    )

    return (step_cp_prob(data, config),
            laplace_scale(unpack(samples, config).delta, config))


def draws_plain(samples: torch.Tensor, data, y_scale: torch.Tensor,
                floor: torch.Tensor, config: ProphetConfig, variates: Draws,
                return_samples: bool = False) -> Dict[str, torch.Tensor]:
    """The forecast from (S, B, P) draws on the given (S, B, T) variates,
    a draw at a time: the means of the deterministic yhat, trend and
    feature totals (summed in ascending draw order), the interval
    quantiles of the sampled yhat and trend, all in data units."""
    from tsspark_tpu_torch.models.prophet.design import (
        seasonal_split,
        trend_fn,
    )
    from tsspark_tpu_torch.models.prophet.params import unpack
    from tsspark_tpu_torch.models.prophet.predict import _simulate_trends

    u, lap, z = variates
    cp, lam = draw_rates(samples, data, config)
    n_s = samples.shape[0]
    b, t_len = data.t.shape
    sums = [torch.zeros((b, t_len), dtype=torch.float32,
                        device=samples.device) for _ in range(4)]
    yhat_s = torch.empty((n_s, b, t_len), dtype=torch.float32,
                         device=samples.device)
    trend_s = torch.empty_like(yhat_s)
    for s in range(n_s):
        th = samples[s]
        p = unpack(th, config)
        det = trend_fn(p, data, config)
        add, mult = seasonal_split(th, data, config)
        tr = _simulate_trends(th, data, config, u[s:s + 1], lap[s:s + 1],
                              det=det, rates=(cp, lam[s]))[0]
        sigma = torch.exp(p.log_sigma)[:, None]
        yhat_s[s] = tr * (1.0 + mult) + add + z[s] * sigma
        trend_s[s] = tr
        for acc, v in zip(sums, (det * (1.0 + mult) + add, det, add, mult)):
            acc += v
    dety, det, add, mult = (acc / float(n_s) for acc in sums)
    sc, fl = y_scale[:, None], floor[:, None]
    qs = quantile_points(config.interval_width)
    y_lo, y_hi = quantile_linear(yhat_s, qs)
    t_lo, t_hi = quantile_linear(trend_s, qs)
    out = {
        "yhat": dety * sc + fl,
        "trend": det * sc + fl,
        "additive": add * sc,
        "multiplicative": mult,
        "yhat_lower": y_lo * sc + fl,
        "yhat_upper": y_hi * sc + fl,
        "trend_lower": t_lo * sc + fl,
        "trend_upper": t_hi * sc + fl,
    }
    if return_samples:
        out["yhat_samples"] = yhat_s * sc[None] + fl[None]
    return out


def draws(samples: torch.Tensor, data, y_scale: torch.Tensor,
          floor: torch.Tensor, config: ProphetConfig, seed: int = 0,
          variates: Optional[Draws] = None, return_samples: bool = False,
          rows: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """``OUTPUTS``, each (B, T) in data units, from (S, B, P) posterior
    draws over the (B, T) grid of ``data``, plus ``yhat_samples`` (S, B,
    T) when asked.

    ``seed`` keys the variates unless ``variates`` are given.  ``rows``
    (B,) int32: the kernel's Philox row coordinate of each row (default
    its index in the batch), so a row can be drawn alike in another
    batch.  On the card at most ``MAX_SAMPLES`` draws (ValueError past
    it); the rows go in launches of ``CHUNK_ROWS``."""
    dev = samples.device
    n_s, b, p = samples.shape
    t_len = data.t.shape[1]
    shape = (n_s, b, t_len)
    if variates is not None and any(tuple(v.shape) != shape
                                    for v in variates):
        raise ValueError(f"variates must each have shape {shape}")
    if n_s < 1:
        raise ValueError("draws: need at least one posterior draw")
    if dev.type == "cpu":
        if variates is None:
            gen = torch.Generator(device="cpu").manual_seed(int(seed))
            variates = sample_draws(shape, gen, dev)
        return draws_plain(samples, data, y_scale, floor, config, variates,
                           return_samples)
    if dev.type != "cuda":
        raise ValueError(f"draws: unsupported device {dev}")
    if n_s > MAX_SAMPLES:
        raise ValueError(
            f"draws: {n_s} posterior draws; the kernel takes at most "
            f"MAX_SAMPLES = {MAX_SAMPLES} (thin them: predict_mcmc's "
            f"max_draws)")
    ncp = config.n_changepoints
    fs = config.num_seasonal_features
    r = config.num_regressors
    _require("samples", samples, (n_s, b, config.num_params), dev)
    _require("t", data.t, (b, t_len), dev)
    _require("s", data.s, (b, ncp), dev)
    xs = data.X_season
    per_series = xs.ndim == 3
    _require("X_season", xs, (b, t_len, fs) if per_series else (t_len, fs),
             dev)
    _require("X_reg", data.X_reg, (b, t_len, r), dev)
    _require("mult_mask", data.mult_mask, (fs + r,), dev)
    logistic = config.growth == "logistic"
    if logistic:
        _require("cap", data.cap, (b, t_len), dev)
    _require("y_scale", y_scale, (b,), dev)
    _require("floor", floor, (b,), dev)
    if variates is not None:
        for name, v in zip(("u", "laplace", "normal"), variates):
            _require(name, v, shape, dev)
    if rows is not None and (rows.device != dev or rows.dtype != torch.int32
                             or tuple(rows.shape) != (b,)):
        raise ValueError(f"rows: expected an int32 ({b},) tensor on {dev}")
    cp, lam = draw_rates(samples, data, config)
    qs = quantile_points(config.interval_width)
    outs = {k: torch.empty((b, t_len), dtype=torch.float32, device=dev)
            for k in OUTPUTS}
    all_samples = (torch.empty(shape, dtype=torch.float32, device=dev)
                   if return_samples else None)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = build.library()
    for r0 in range(0, b, CHUNK_ROWS):
        r1 = min(b, r0 + CHUNK_ROWS)
        nb = r1 - r0
        theta_t = samples[:, r0:r1].permute(1, 2, 0).contiguous()
        lam_c = lam[:, r0:r1].t().contiguous()
        given = (None,) * 3 if variates is None else \
            tuple(v[:, r0:r1].contiguous() for v in variates)
        smp = (torch.empty((n_s, nb, t_len), dtype=torch.float32,
                           device=dev) if return_samples else None)
        out_c = [outs[k][r0:r1] for k in OUTPUTS]
        rows_c = None if rows is None else rows[r0:r1].contiguous()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.tsspark_draws(
                theta_t.data_ptr(), data.t[r0:r1].data_ptr(),
                data.s[r0:r1].data_ptr(),
                ptr(data.cap[r0:r1] if logistic else None),
                (xs[r0:r1] if per_series else xs).data_ptr(),
                t_len * fs if per_series else 0,
                data.X_reg[r0:r1].data_ptr(), data.mult_mask.data_ptr(),
                cp[r0:r1].data_ptr(), lam_c.data_ptr(),
                y_scale[r0:r1].data_ptr(), floor[r0:r1].data_ptr(),
                *(ptr(g) for g in given), ptr(rows_c), r0,
                int(seed) & 0xFFFFFFFFFFFFFFFF, float(qs[0]), float(qs[1]),
                *(o.data_ptr() for o in out_c), ptr(smp),
                nb, t_len, config.num_params, ncp, fs, r, n_s,
                GROWTH_CODES[config.growth], stream,
            )
        build.check(err, "draws")
        _count()
        if return_samples:
            all_samples[:, r0:r1] = smp
    if return_samples:
        outs["yhat_samples"] = all_samples
    return outs
