"""Synthetic data (numpy), for driving the port at full size.

Copies of the JAX package's generators, deterministic in their seed,
plain numpy arrays out (the same bytes as the reference's):

* ``peyton_manning_like`` (eval config 1): one daily series of ~8 years
  with yearly and weekly seasonality, a few changepoints and 2% missing
  days;
* ``m4_hourly_like`` (eval config 2): 414 hourly series with daily and
  weekly seasonality, ragged lengths (700-960) right-aligned on a shared
  grid;
* ``m5_like`` (eval config 3): 30,490 daily series over 1,941 days with
  M5's onset pattern (leading unobserved days), weekly and yearly
  seasonality, changepoints, and holiday, price and promo effects;
* ``wiki_logistic_like`` (eval config 4): saturating pageview series
  with a known capacity and a multiplicative weekly pattern;
* ``m5_rows`` (the data plane's M5 family: ``base``, ``irregular``,
  ``missing_windows``, ``cold_start`` and ``hier`` scenarios) and
  ``demo_weekly_rows`` (the calibration smoke's workload): block-seeded
  (``SEED_BLOCK`` rows a stream), so rows [lo, hi) are the same bytes
  whatever range they are generated in, with their ``dataset_ids`` and
  the closed-form ``dataset_calendar``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class SeriesBatch(NamedTuple):
    """A padded batch of series on a shared calendar grid."""

    ds: np.ndarray            # (T,) absolute days since epoch
    y: np.ndarray             # (B, T) observations, NaN where missing
    mask: np.ndarray          # (B, T) 1.0 where observed
    series_ids: np.ndarray    # (B,) string ids
    cap: Optional[np.ndarray] = None         # (B, T) logistic capacity
    regressors: Optional[np.ndarray] = None  # (B, T, R)
    regressor_names: tuple = ()


def _trend_with_changepoints(rng, t, n_cp=4, base_slope=1.0, cp_scale=1.5):
    """Piecewise-linear trend on t in [0, 1]."""
    cps = np.sort(rng.uniform(0.05, 0.9, n_cp))
    deltas = rng.normal(0, cp_scale, n_cp)
    g = base_slope * t
    for c, d in zip(cps, deltas):
        g = g + d * np.maximum(t - c, 0.0)
    return g


def peyton_manning_like(
    n_days: int = 2905, start_day: float = 10957.0, seed: int = 0
) -> SeriesBatch:
    """One daily series shaped like log Wikipedia pageviews of a celebrity:
    ~8 years, strong yearly + weekly seasonality, a few trend changepoints,
    heavy-ish noise, occasional missing days.  Stands in for eval config 1."""
    rng = np.random.default_rng(seed)
    ds = start_day + np.arange(n_days, dtype=np.float64)
    t = np.linspace(0, 1, n_days)
    trend = 8.0 + _trend_with_changepoints(rng, t, n_cp=5, base_slope=-0.5)
    yearly = (
        0.45 * np.sin(2 * np.pi * ds / 365.25)
        + 0.25 * np.cos(2 * np.pi * ds / 365.25)
        + 0.18 * np.sin(4 * np.pi * ds / 365.25)
    )
    dow = ds.astype(np.int64) % 7
    weekly = np.asarray([0.12, 0.3, 0.22, 0.18, 0.1, -0.35, -0.42])[dow]
    y = trend + yearly + weekly + rng.normal(0, 0.25, n_days)
    miss = rng.uniform(size=n_days) < 0.02
    y[miss] = np.nan
    mask = (~miss).astype(np.float64)
    return SeriesBatch(
        ds=ds, y=y[None, :], mask=mask[None, :],
        series_ids=np.asarray(["peyton_manning_like"]),
    )


def m4_hourly_like(
    n_series: int = 414, max_len: int = 960, seed: int = 1,
    min_len: Optional[int] = None,
) -> SeriesBatch:
    """414 hourly series with daily + weekly seasonality and ragged lengths
    (M4-Hourly lengths span 700-960).  Stands in for eval config 2."""
    rng = np.random.default_rng(seed)
    if min_len is None:
        min_len = min(700, max(2, int(0.73 * max_len)))
    hours = np.arange(max_len, dtype=np.float64)
    ds = 15000.0 + hours / 24.0  # days, hourly grid
    y = np.full((n_series, max_len), np.nan)
    mask = np.zeros((n_series, max_len))
    lengths = rng.integers(min_len, max_len + 1, n_series)
    for i in range(n_series):
        n = lengths[i]
        t = np.linspace(0, 1, n)
        level = rng.uniform(10, 5000)
        trend = level * (1 + 0.3 * _trend_with_changepoints(rng, t, 3, 0.5,
                                                            0.8))
        hod = ds[:n] * 24 % 24
        daily = 0.25 * level * np.sin(2 * np.pi * hod / 24
                                      + rng.uniform(0, 2 * np.pi))
        daily += 0.1 * level * np.sin(4 * np.pi * hod / 24
                                      + rng.uniform(0, 2 * np.pi))
        dow = (ds[:n].astype(np.int64)) % 7
        weekly = 0.12 * level * np.asarray(
            [1.0, 0.9, 0.85, 0.9, 1.0, 1.3, 1.4]
        )[dow] - 0.12 * level
        noise = rng.normal(0, 0.05 * level, n)
        # Right-align on the shared grid (all series end "now", like M4).
        y[i, max_len - n:] = (trend + daily + weekly + noise)[:n]
        mask[i, max_len - n:] = 1.0
    ids = np.asarray([f"H{i+1}" for i in range(n_series)])
    return SeriesBatch(ds=ds, y=y, mask=mask, series_ids=ids)


def m5_like(
    n_series: int = 30490, n_days: int = 1941, seed: int = 2,
    with_regressors: bool = True,
) -> SeriesBatch:
    """M5-scale retail batch: 30,490 daily series, 1,941 days, holiday
    indicator + price + promo regressors.  Stands in for eval config 3.

    Generation is vectorized (30k x 1941 is ~59M points; a Python loop over
    series would take minutes)."""
    rng = np.random.default_rng(seed)
    ds = 13514.0 + np.arange(n_days, dtype=np.float64)
    t = np.linspace(0, 1, n_days)

    level = rng.lognormal(1.0, 1.0, (n_series, 1))
    slope = rng.normal(0.2, 0.4, (n_series, 1))
    n_cp = 3
    cps = np.sort(rng.uniform(0.1, 0.9, (n_series, n_cp)), axis=-1)
    deltas = rng.normal(0, 0.5, (n_series, n_cp))
    trend = 1.0 + slope * t[None, :]
    for j in range(n_cp):
        trend += deltas[:, j : j + 1] * np.maximum(t[None, :] - cps[:, j : j + 1], 0)

    dow = ds.astype(np.int64) % 7
    wk_pattern = rng.normal(0, 0.15, (n_series, 7))
    weekly = np.take_along_axis(
        wk_pattern, np.broadcast_to(dow[None, :], (n_series, n_days)), axis=1
    )
    yearly_phase = rng.uniform(0, 2 * np.pi, (n_series, 1))
    yearly = 0.2 * np.sin(2 * np.pi * ds[None, :] / 365.25 + yearly_phase)

    # Holiday calendar: ~12 fixed days/year, shared; per-series effect size.
    doy = ds.astype(np.int64) % 365
    holiday_days = np.asarray([0, 31, 59, 120, 151, 185, 243, 304, 327, 330, 358, 359])
    is_holiday = np.isin(doy, holiday_days).astype(np.float64)
    hol_effect = rng.normal(0.3, 0.2, (n_series, 1))

    price = 1.0 + 0.1 * np.cumsum(rng.normal(0, 0.02, (n_series, n_days)), axis=1)
    promo = (rng.uniform(size=(n_series, n_days)) < 0.05).astype(np.float64)
    price_beta = rng.normal(-0.3, 0.1, (n_series, 1))
    promo_beta = rng.normal(0.4, 0.15, (n_series, 1))

    signal = (
        trend
        + weekly
        + yearly
        + hol_effect * is_holiday[None, :]
        + price_beta * (price - 1.0)
        + promo_beta * promo
    )
    y = level * np.maximum(signal + rng.normal(0, 0.15, (n_series, n_days)), 0.0)

    # Leading zeros before "product launch" (M5's onset pattern): mask them.
    launch = rng.integers(0, n_days // 3, n_series)
    mask = (np.arange(n_days)[None, :] >= launch[:, None]).astype(np.float64)
    y = np.where(mask > 0, y, np.nan)

    reg = None
    names: tuple = ()
    if with_regressors:
        reg = np.stack([is_holiday[None, :].repeat(n_series, 0), price, promo], axis=-1)
        names = ("holiday", "price", "promo")
    ids = np.asarray([f"M5_{i:05d}" for i in range(n_series)])
    return SeriesBatch(
        ds=ds, y=y, mask=mask, series_ids=ids, regressors=reg,
        regressor_names=names,
    )


def wiki_logistic_like(
    n_series: int = 8, n_days: int = 1200, seed: int = 3
) -> SeriesBatch:
    """Saturating-growth pageview series with known capacity (eval
    config 4)."""
    rng = np.random.default_rng(seed)
    ds = 14000.0 + np.arange(n_days, dtype=np.float64)
    t = np.linspace(0, 1, n_days)
    caps = rng.uniform(5e3, 5e4, (n_series, 1))
    k = rng.uniform(4, 10, (n_series, 1))
    m = rng.uniform(0.2, 0.5, (n_series, 1))
    base = caps / (1.0 + np.exp(-k * (t[None, :] - m)))
    dow = ds.astype(np.int64) % 7
    weekly_mult = 1.0 + 0.1 * np.asarray(
        [0.5, 1, 0.8, 0.6, 0.2, -1.5, -1.8])[dow]
    y = base * weekly_mult[None, :] * (
        1 + rng.normal(0, 0.04, (n_series, n_days)))
    ids = np.asarray([f"wiki_{i}" for i in range(n_series)])
    return SeriesBatch(
        ds=ds, y=y, mask=np.ones_like(y), series_ids=ids,
        cap=np.broadcast_to(caps * 1.1, y.shape).copy(),
    )


# ---------------------------------------------------------------------------
# block-seeded generators (the JAX package's data-plane workloads)
# ---------------------------------------------------------------------------

#: Rows per seeding block: part of the data's identity, as in the JAX
#: package (a row's values depend on its block's rng alone).
SEED_BLOCK = 1024

#: M5-like hierarchy shape (store -> dept -> item): row i belongs to
#: store i % 10, dept (i // 10) % 7, so every block mixes all stores.
HIER_STORES = 10
HIER_DEPTS = 7


def _block_rng(seed: int, block: int, tag: int = 0):
    """The rng for one (seed, block) cell; ``tag`` separates streams."""
    return np.random.default_rng(
        [0x7355, int(seed) & 0xFFFFFFFF, int(block), int(tag)]
    )


def dataset_calendar(generator: str, n_timesteps: int) -> np.ndarray:
    """The shared float64 calendar grid of a named block generator: a
    closed formula, so creating a dataset never generates a seed block
    just to learn the grid (equal to the grid the row generators emit)."""
    if generator == "demo_weekly":
        return np.arange(n_timesteps, dtype=np.float64)
    return 13514.0 + np.arange(n_timesteps, dtype=np.float64)


def _zero_pad(idx: np.ndarray, width: int) -> np.ndarray:
    """``f"{i:0{width}d}"`` vectorized (values with more digits than
    ``width`` keep their own digits, as the f-spec does)."""
    natw = len(str(int(idx.max()))) if idx.size else 1
    s = idx.astype(f"<U{natw}")
    maxw = max(width, natw)
    out = s.astype(f"<U{maxw}")
    short = np.char.str_len(s) < width
    if short.any():
        out[short] = np.char.zfill(s[short], width)
    return out


def dataset_ids(generator: str, lo: int, hi: int) -> np.ndarray:
    """Series ids for rows [lo, hi) of a named block generator, by
    formula, so a warm cache reader never regenerates data to learn
    them: ``m5_hier``'s ``S<store>_D<dept>_I<item>``, ``demo_weekly``'s
    ``s0000``, else M5's ``M5_00000`` (vectorized: no per-row Python)."""
    idx = np.arange(lo, hi)
    if generator == "m5_hier":
        store = idx % HIER_STORES
        dept = (idx // HIER_STORES) % HIER_DEPTS
        item = idx // (HIER_STORES * HIER_DEPTS)
        # Width-bounded astypes: a bare astype(np.str_) defaults to U21
        # per component and np.char.add SUMS itemsizes, which would
        # quadruple the id columns' bytes for digits no id ever uses.
        s_w = len(str(HIER_STORES - 1))
        d_w = len(str(HIER_DEPTS - 1))
        out = np.char.add("S", store.astype(f"<U{s_w}"))
        out = np.char.add(out, "_D")
        out = np.char.add(out, dept.astype(f"<U{d_w}"))
        out = np.char.add(out, "_I")
        return np.char.add(out, _zero_pad(item, 5))
    if generator == "demo_weekly":
        return np.char.add("s", _zero_pad(idx, 4))
    return np.char.add("M5_", _zero_pad(idx, 5))


def _m5_block(rng, n_days: int, ds: np.ndarray, scenario: str,
              seed: int, row0: int):
    """One full SEED_BLOCK of m5-like rows (same generating process as
    :func:`m5_like`, per-block stream).  Returns (y, mask, reg)."""
    S = SEED_BLOCK
    t = np.linspace(0, 1, n_days)
    level = rng.lognormal(1.0, 1.0, (S, 1))
    slope = rng.normal(0.2, 0.4, (S, 1))
    n_cp = 3
    cps = np.sort(rng.uniform(0.1, 0.9, (S, n_cp)), axis=-1)
    deltas = rng.normal(0, 0.5, (S, n_cp))
    trend = 1.0 + slope * t[None, :]
    for j in range(n_cp):
        trend += deltas[:, j:j + 1] * np.maximum(t[None, :] - cps[:, j:j + 1], 0)

    dow = ds.astype(np.int64) % 7
    wk_pattern = rng.normal(0, 0.15, (S, 7))
    weekly = np.take_along_axis(
        wk_pattern, np.broadcast_to(dow[None, :], (S, n_days)), axis=1
    )
    yearly_phase = rng.uniform(0, 2 * np.pi, (S, 1))
    if scenario == "hier":
        # Shared store/dept structure: level and seasonality phase are
        # composed from per-store/per-dept tables drawn from a dedicated
        # stream (a function of the seed only — every block must see the
        # SAME tables).
        trng = _block_rng(seed, 0, tag=1)
        store_boost = trng.normal(0, 0.5, HIER_STORES)
        dept_boost = trng.normal(0, 0.35, HIER_DEPTS)
        store_phase = trng.uniform(0, 2 * np.pi, HIER_STORES)
        idx = np.arange(row0, row0 + S)
        store = idx % HIER_STORES
        dept = (idx // HIER_STORES) % HIER_DEPTS
        level = level * np.exp(store_boost[store] + dept_boost[dept])[:, None]
        yearly_phase = (store_phase[store][:, None]
                        + 0.2 * (yearly_phase - np.pi))
    yearly = 0.2 * np.sin(2 * np.pi * ds[None, :] / 365.25 + yearly_phase)

    doy = ds.astype(np.int64) % 365
    holiday_days = np.asarray(
        [0, 31, 59, 120, 151, 185, 243, 304, 327, 330, 358, 359]
    )
    is_holiday = np.isin(doy, holiday_days).astype(np.float64)
    hol_effect = rng.normal(0.3, 0.2, (S, 1))

    price = 1.0 + 0.1 * np.cumsum(rng.normal(0, 0.02, (S, n_days)), axis=1)
    promo = (rng.uniform(size=(S, n_days)) < 0.05).astype(np.float64)
    price_beta = rng.normal(-0.3, 0.1, (S, 1))
    promo_beta = rng.normal(0.4, 0.15, (S, 1))

    signal = (
        trend + weekly + yearly
        + hol_effect * is_holiday[None, :]
        + price_beta * (price - 1.0)
        + promo_beta * promo
    )
    y = level * np.maximum(signal + rng.normal(0, 0.15, (S, n_days)), 0.0)

    if scenario == "cold_start":
        # Half the block launches with only the trailing 2-30% of the
        # calendar observed — the late-onset series a production fleet
        # keeps gaining.
        late = rng.uniform(size=S) < 0.5
        launch = np.where(
            late,
            rng.integers(int(0.70 * n_days), max(int(0.98 * n_days), 1), S),
            rng.integers(0, max(n_days // 3, 1), S),
        )
    else:
        launch = rng.integers(0, max(n_days // 3, 1), S)
    mask = (np.arange(n_days)[None, :] >= launch[:, None]).astype(np.float64)

    if scenario == "irregular":
        # Irregular cadence: per-series dropout of 5-40% of otherwise
        # observed days, so the observed grid is ragged within the
        # shared calendar (exercises the mask path end to end).
        rate = rng.uniform(0.05, 0.4, (S, 1))
        drop = rng.uniform(size=(S, n_days)) < rate
        mask = np.where(drop, 0.0, mask)
    elif scenario == "missing_windows":
        # 1-3 contiguous outage windows per series, each ~3-10% of the
        # calendar (sensor gaps, stockouts).
        k = 3
        starts = rng.integers(0, n_days, (S, k))
        lens = rng.integers(max(n_days // 33, 2), max(n_days // 10, 3),
                            (S, k))
        active = rng.uniform(size=(S, k)) < 0.7
        grid = np.arange(n_days)
        win = ((grid[None, None, :] >= starts[:, :, None])
               & (grid[None, None, :] < (starts + lens)[:, :, None])
               & active[:, :, None]).any(axis=1)
        mask = np.where(win, 0.0, mask)

    y = np.where(mask > 0, y, np.nan)
    reg = np.stack(
        [is_holiday[None, :].repeat(S, 0), price, promo], axis=-1
    )
    return y, mask, reg


_M5_SCENARIOS = {
    "m5": "base",
    "m5_irregular": "irregular",
    "m5_missing_windows": "missing_windows",
    "m5_cold_start": "cold_start",
    "m5_hier": "hier",
}


def m5_rows(
    lo: int, hi: int, n_days: int = 1941, seed: int = 2,
    scenario: str = "base", with_regressors: bool = True,
) -> SeriesBatch:
    """Rows [lo, hi) of the block-seeded m5-like family.

    ``m5_rows(lo, hi, ...)`` is bitwise-identical to
    ``m5_rows(0, N, ...)`` sliced to [lo, hi) for any covering N — the
    property the data plane's parallel shard ingestion rests on."""
    if not 0 <= lo < hi:
        raise ValueError(f"bad row range [{lo}, {hi})")
    ds = 13514.0 + np.arange(n_days, dtype=np.float64)
    ys, masks, regs = [], [], []
    for block in range(lo // SEED_BLOCK, (hi - 1) // SEED_BLOCK + 1):
        row0 = block * SEED_BLOCK
        y_b, m_b, r_b = _m5_block(
            _block_rng(seed, block), n_days, ds, scenario, seed, row0
        )
        s = slice(max(lo, row0) - row0, min(hi, row0 + SEED_BLOCK) - row0)
        ys.append(y_b[s])
        masks.append(m_b[s])
        regs.append(r_b[s])
    gen = next(
        (k for k, v in _M5_SCENARIOS.items() if v == scenario), "m5"
    )
    return SeriesBatch(
        ds=ds,
        y=np.concatenate(ys, axis=0),
        mask=np.concatenate(masks, axis=0),
        series_ids=dataset_ids(gen, lo, hi),
        regressors=np.concatenate(regs, axis=0) if with_regressors else None,
        regressor_names=("holiday", "price", "promo") if with_regressors
        else (),
    )


_M5_SCENARIOS = {
    "m5": "base",
    "m5_irregular": "irregular",
    "m5_missing_windows": "missing_windows",
    "m5_cold_start": "cold_start",
    "m5_hier": "hier",
}


def m5_rows(
    lo: int, hi: int, n_days: int = 1941, seed: int = 2,
    scenario: str = "base", with_regressors: bool = True,
) -> SeriesBatch:
    """Rows [lo, hi) of the block-seeded m5-like family.

    ``m5_rows(lo, hi, ...)`` is bitwise-identical to
    ``m5_rows(0, N, ...)`` sliced to [lo, hi) for any covering N — the
    property the data plane's parallel shard ingestion rests on."""
    if not 0 <= lo < hi:
        raise ValueError(f"bad row range [{lo}, {hi})")
    ds = 13514.0 + np.arange(n_days, dtype=np.float64)
    ys, masks, regs = [], [], []
    for block in range(lo // SEED_BLOCK, (hi - 1) // SEED_BLOCK + 1):
        row0 = block * SEED_BLOCK
        y_b, m_b, r_b = _m5_block(
            _block_rng(seed, block), n_days, ds, scenario, seed, row0
        )
        s = slice(max(lo, row0) - row0, min(hi, row0 + SEED_BLOCK) - row0)
        ys.append(y_b[s])
        masks.append(m_b[s])
        regs.append(r_b[s])
    gen = next(
        (k for k, v in _M5_SCENARIOS.items() if v == scenario), "m5"
    )
    return SeriesBatch(
        ds=ds,
        y=np.concatenate(ys, axis=0),
        mask=np.concatenate(masks, axis=0),
        series_ids=dataset_ids(gen, lo, hi),
        regressors=np.concatenate(regs, axis=0) if with_regressors else None,
        regressor_names=("holiday", "price", "promo") if with_regressors
        else (),
    )


def demo_weekly_rows(
    lo: int, hi: int, n_steps: int = 180, seed: int = 0
) -> SeriesBatch:
    """Block-seeded smooth weekly-cycle series (level + slope + sine +
    N(0, 0.2^2)) on the day grid 0 .. n_steps - 1."""
    if not 0 <= lo < hi:
        raise ValueError(f"bad row range [{lo}, {hi})")
    t = np.arange(n_steps, dtype=np.float64)
    ys = []
    for block in range(lo // SEED_BLOCK, (hi - 1) // SEED_BLOCK + 1):
        rng = _block_rng(seed, block, tag=2)
        S = SEED_BLOCK
        level = rng.uniform(5.0, 50.0, (S, 1))
        slope = rng.uniform(-0.02, 0.05, (S, 1))
        amp = rng.uniform(0.5, 3.0, (S, 1))
        y_b = (level + slope * t[None, :]
               + amp * np.sin(2 * np.pi * t[None, :] / 7.0)
               + rng.normal(0, 0.2, (S, n_steps)))
        row0 = block * SEED_BLOCK
        ys.append(y_b[max(lo, row0) - row0:
                      min(hi, row0 + SEED_BLOCK) - row0])
    y = np.concatenate(ys, axis=0)
    return SeriesBatch(
        ds=t, y=y, mask=np.ones_like(y),
        series_ids=dataset_ids("demo_weekly", lo, hi),
    )
