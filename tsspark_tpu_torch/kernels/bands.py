"""K2 ``bands``: predictive intervals as one CUDA kernel.

``bands`` is the wrapper ``predict.forecast`` calls for a sampled
forecast.  On a CPU tensor it runs the plain PyTorch version,
``bands_plain`` (``predict._simulate_trends``, the noise draw and
``quantile_linear``); on a CUDA tensor it launches ``csrc/bands.cu``
or raises.  ``launches`` counts kernel launches.

Variates: the kernel draws its own from a Philox4x32-10 counter; the
plain version draws from a ``torch.Generator``.  Both accept GIVEN
draws instead, ``(u, laplace, normal)`` of shape (S, B, T) each — a
U(0, 1) for the changepoint Bernoulli, a standard Laplace and a
standard normal, the three variates the JAX package draws — so either
can be held against the other, or against the JAX package, on the
same numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tsspark_tpu_torch.config import ProphetConfig
from tsspark_tpu_torch.kernels import COUNT_LOCK, build
from tsspark_tpu_torch.kernels.forward import GROWTH_CODES, _require

#: Kernel launches since the count was last set to 0.
launches = 0


def _count() -> None:
    """One launch, counted under ``COUNT_LOCK`` (two threads may launch)."""
    global launches
    with COUNT_LOCK:
        launches += 1


#: Sample counts up to this many run in one block a row, in shared
#: memory (``kFusedMaxSamples`` in bands.cu); larger ones go through a
#: device-memory scratch of the samples' keys.
FUSED_MAX_SAMPLES = 1024

#: The most device memory the scratch of a launch takes: rows (or, for a
#: very long row, steps) are taken in chunks whose keys fit it.
SCRATCH_BYTES = 256 * 2**20

Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def quantile_points(interval_width: float) -> Tuple[np.float32, np.float32]:
    """(lo, hi) quantile points in float32, as the JAX package forms them."""
    lo_q = (1.0 - interval_width) / 2.0
    return np.float32(lo_q), np.float32(1.0 - lo_q)


def quantile_linear(x: torch.Tensor, qs) -> Tuple[torch.Tensor, ...]:
    """``jnp.quantile(x, q, axis=0)`` for each q of ``qs`` with the
    "linear" rule, by one sort: position q*(S-1) in float32, the floor
    and ceil neighbours weighted by the fractional part; a column holding
    a NaN gives NaN, as jnp.quantile's does, and +-inf are values like any
    other.  No input-size limit (``torch.quantile`` refuses more than
    2**24 elements)."""
    n = x.shape[0]
    srt = torch.sort(x, dim=0).values
    nan = torch.isnan(srt[-1])  # torch.sort puts NaN last
    out = []
    for q in qs:
        pos = np.float32(q) * np.float32(n - 1)
        lo, hi = np.floor(pos), np.ceil(pos)
        hw = np.float32(pos - lo)
        lw = np.float32(1.0) - hw
        il = int(min(max(lo, 0), n - 1))
        ih = int(min(max(hi, 0), n - 1))
        q_val = srt[il] * float(lw) + srt[ih] * float(hw)
        out.append(torch.where(nan, torch.full_like(q_val, float("nan")),
                               q_val))
    return tuple(out)


def sample_draws(shape, generator: torch.Generator,
                 device: torch.device) -> Draws:
    """(u, laplace, normal) variates of ``shape`` from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    e1 = torch.empty(shape, device=device).exponential_(generator=generator)
    e2 = torch.empty(shape, device=device).exponential_(generator=generator)
    z = torch.randn(shape, generator=generator, device=device)
    return u, e1 - e2, z


def bands_plain(theta: torch.Tensor, data, det: torch.Tensor,
                add: torch.Tensor, mult: torch.Tensor,
                y_scale: torch.Tensor, floor: torch.Tensor,
                config: ProphetConfig, draws: Draws,
                return_samples: bool = False) -> Dict[str, torch.Tensor]:
    """Intervals in data units from the given (S, B, T) draws."""
    from tsspark_tpu_torch.models.prophet.predict import _simulate_trends

    u, lap, z = draws
    trends = _simulate_trends(theta, data, config, u, lap, det=det)
    sigma = torch.exp(theta[:, 2])[None, :, None]
    samples = trends * (1.0 + mult[None]) + add[None] + z * sigma
    qs = quantile_points(config.interval_width)
    sc, fl = y_scale[:, None], floor[:, None]
    y_lo, y_hi = quantile_linear(samples, qs)
    t_lo, t_hi = quantile_linear(trends, qs)
    out = {
        "yhat_lower": y_lo * sc + fl,
        "yhat_upper": y_hi * sc + fl,
        "trend_lower": t_lo * sc + fl,
        "trend_upper": t_hi * sc + fl,
    }
    if return_samples:
        out["yhat_samples"] = samples * sc[None] + fl[None]
    return out


def scratch_floats(b: int, t_len: int, num_samples: int) -> int:
    """Floats of device scratch a CUDA launch takes: none up to
    ``FUSED_MAX_SAMPLES``; else two keys a sample and step, plus the
    running sums of a row's samples, for as many rows as fit
    ``SCRATCH_BYTES`` (at least one step of one row)."""
    if num_samples <= FUSED_MAX_SAMPLES:
        return 0
    per_row = 2 * num_samples * t_len + 2 * num_samples
    need = min(b * per_row, SCRATCH_BYTES // 4)
    if need < 4 * num_samples:
        raise ValueError(f"bands: {num_samples} samples do not fit the "
                         f"{SCRATCH_BYTES}-byte scratch")
    return need


def bands(theta: torch.Tensor, data, det: torch.Tensor, add: torch.Tensor,
          mult: torch.Tensor, y_scale: torch.Tensor, floor: torch.Tensor,
          config: ProphetConfig, num_samples: int, seed: int = 0,
          draws: Optional[Draws] = None,
          return_samples: bool = False,
          rows: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """``yhat_lower/upper`` and ``trend_lower/upper`` in data units, each
    (B, T), plus ``yhat_samples`` (S, B, T) when asked.

    ``det``, ``add``, ``mult``: the deterministic trend and the additive
    and multiplicative totals in scaled units (the forward kernel's
    outputs).  ``seed`` keys the draws unless ``draws`` are given.
    ``rows`` (B,) int32: the kernel's Philox row coordinate of each row
    (default its index), so a row can be drawn alike in another batch.

    Any ``num_samples`` >= 1.  On the card, more than
    ``FUSED_MAX_SAMPLES`` samples take a scratch of at most
    ``SCRATCH_BYTES`` (256 MiB) of device memory for the launch."""
    dev = theta.device
    b, t_len = data.t.shape
    shape = (num_samples, b, t_len)
    if draws is not None and any(tuple(d.shape) != shape for d in draws):
        raise ValueError(f"draws must each have shape {shape}")
    if dev.type == "cpu":
        if draws is None:
            gen = torch.Generator(device="cpu").manual_seed(int(seed))
            draws = sample_draws(shape, gen, dev)
        return bands_plain(theta, data, det, add, mult, y_scale, floor,
                           config, draws, return_samples)
    if dev.type != "cuda":
        raise ValueError(f"bands: unsupported device {dev}")
    if num_samples < 1:
        raise ValueError(f"bands: num_samples must be >= 1, got "
                         f"{num_samples}")
    _require("theta", theta, (b, config.num_params), dev)
    for name, x in (("t", data.t), ("det", det), ("add", add),
                    ("mult", mult)):
        _require(name, x, (b, t_len), dev)
    _require("y_scale", y_scale, (b,), dev)
    _require("floor", floor, (b,), dev)
    logistic = config.growth == "logistic"
    rates = None
    if logistic:
        _require("cap", data.cap, (b, t_len), dev)
        _require("s", data.s, (b, config.n_changepoints), dev)
        # Logistic growth's row rates come from the plain version's own
        # reductions, so both draw the same deltas: the offset recursion
        # amplifies an ulp of them.  Linear and flat growth sum them in
        # the kernel.
        from tsspark_tpu_torch.models.prophet.params import unpack
        from tsspark_tpu_torch.models.prophet.predict import sample_rates

        rates = torch.stack(sample_rates(unpack(theta, config), data,
                                         config), -1).contiguous()
    if draws is not None:
        for name, x in zip(("u", "laplace", "normal"), draws):
            _require(name, x, shape, dev)
    if rows is not None:
        if rows.device != dev or rows.dtype != torch.int32 \
                or tuple(rows.shape) != (b,) or not rows.is_contiguous():
            raise ValueError(f"rows: expected a contiguous int32 ({b},) "
                             f"tensor on {dev}")
    lo_q, hi_q = quantile_points(config.interval_width)
    outs = [torch.empty((b, t_len), dtype=torch.float32, device=dev)
            for _ in range(4)]
    samples = (torch.empty(shape, dtype=torch.float32, device=dev)
               if return_samples else None)
    n_scratch = scratch_floats(b, t_len, num_samples)
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=dev)
               if n_scratch else None)
    given = (None, None, None) if draws is None else \
        tuple(d.data_ptr() for d in draws)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tsspark_bands(
            data.t.data_ptr(), det.data_ptr(), add.data_ptr(),
            mult.data_ptr(), theta.data_ptr(), y_scale.data_ptr(),
            floor.data_ptr(), ptr(data.cap if logistic else None),
            ptr(data.s if logistic else None), ptr(rates), *given,
            ptr(rows),
            int(seed) & 0xFFFFFFFFFFFFFFFF, float(lo_q), float(hi_q),
            *(o.data_ptr() for o in outs), ptr(samples),
            ptr(scratch), n_scratch,
            b, t_len, config.num_params, config.n_changepoints,
            num_samples, GROWTH_CODES[config.growth], stream,
        )
    build.check(err, "bands")
    _count()
    out = dict(zip(("yhat_lower", "yhat_upper", "trend_lower",
                    "trend_upper"), outs))
    if samples is not None:
        out["yhat_samples"] = samples
    return out
