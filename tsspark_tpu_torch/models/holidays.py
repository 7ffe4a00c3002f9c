"""Holiday calendars and holiday-indicator feature expansion.

A copy of the JAX package's ``models/holidays`` module, with the same
names and results.  A holiday is sugar over the external regressor
path: every (holiday, day-offset) pair expands to one 0/1 indicator
column appended to the regressor block, with ``standardize=False`` and
the holiday's own prior scale, as upstream Prophet lowers its
``holidays`` frame into the design matrix.  The expansion is host numpy
on the calendar grid; the model sees only the extra regressor columns
(which the fit's packer ships bit-packed, being exact 0/1).

Country calendars are computed arithmetically (nth-weekday rules + the
Gregorian Easter computus); nothing is looked up.  Supported: US, CA,
GB/UK, DE, FR, IT, ES, BR, JP, IN (the ``_COUNTRIES`` registry below is
the source of truth).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Iterable, Sequence, Tuple

import numpy as np

from tsspark_tpu_torch.config import ProphetConfig, RegressorConfig

_EPOCH = _dt.date(1970, 1, 1)


def _date_to_days(d: _dt.date) -> float:
    return float((d - _EPOCH).days)


def to_days(dates: Iterable) -> np.ndarray:
    """Absolute float days since the epoch from dates/strings/numbers."""
    out = []
    for d in dates:
        if isinstance(d, (int, float, np.integer, np.floating)):
            out.append(float(d))
        elif isinstance(d, _dt.datetime):
            out.append(_date_to_days(d.date()))
        elif isinstance(d, _dt.date):
            out.append(_date_to_days(d))
        else:  # ISO string / numpy datetime64 / pandas Timestamp
            d64 = np.datetime64(str(d), "D")
            out.append(float(d64.astype("datetime64[D]").astype(np.int64)))
    return np.asarray(out, np.float64)


@dataclasses.dataclass(frozen=True)
class Holiday:
    """One named holiday: its occurrence dates plus an effect window.

    ``lower_window``/``upper_window`` extend the effect to days before/after
    each occurrence (Prophet convention: lower_window=-1 covers the eve).
    Each distinct offset gets its own indicator column and coefficient.
    """

    name: str
    dates: Tuple[float, ...]  # absolute days since epoch
    lower_window: int = 0
    upper_window: int = 0
    prior_scale: float = 10.0
    mode: str = "additive"

    def __post_init__(self):
        if self.lower_window > 0:
            raise ValueError("lower_window must be <= 0 (days before)")
        if self.upper_window < 0:
            raise ValueError("upper_window must be >= 0 (days after)")
        if self.mode not in ("additive", "multiplicative"):
            raise ValueError(f"mode must be additive|multiplicative, got {self.mode}")

    @staticmethod
    def from_dates(name: str, dates: Iterable, **kwargs) -> "Holiday":
        return Holiday(name=name, dates=tuple(to_days(dates)), **kwargs)

    @property
    def offsets(self) -> Tuple[int, ...]:
        return tuple(range(self.lower_window, self.upper_window + 1))


def holidays_from_df(df, prior_scale: float = 10.0) -> Tuple[Holiday, ...]:
    """Prophet-style holidays frame -> Holiday specs.

    Expects columns ``holiday`` and ``ds``; optional ``lower_window``,
    ``upper_window``, ``prior_scale`` (constant per holiday name).
    """
    specs = []
    for name, grp in df.groupby("holiday", sort=True):
        lw = int(grp["lower_window"].iloc[0]) if "lower_window" in grp else 0
        uw = int(grp["upper_window"].iloc[0]) if "upper_window" in grp else 0
        ps = float(grp["prior_scale"].iloc[0]) if "prior_scale" in grp else prior_scale
        specs.append(
            Holiday.from_dates(
                str(name), grp["ds"], lower_window=lw, upper_window=uw,
                prior_scale=ps,
            )
        )
    return tuple(specs)


# ---------------------------------------------------------------------------
# Computed country calendars
# ---------------------------------------------------------------------------


def _nth_weekday(year: int, month: int, weekday: int, n: int) -> _dt.date:
    """n-th (1-based) given weekday (Mon=0) of a month."""
    d = _dt.date(year, month, 1)
    shift = (weekday - d.weekday()) % 7 + 7 * (n - 1)
    return d + _dt.timedelta(days=shift)


def _last_weekday(year: int, month: int, weekday: int) -> _dt.date:
    d = (
        _dt.date(year + 1, 1, 1)
        if month == 12
        else _dt.date(year, month + 1, 1)
    ) - _dt.timedelta(days=1)
    return d - _dt.timedelta(days=(d.weekday() - weekday) % 7)


def _easter(year: int) -> _dt.date:
    """Gregorian Easter Sunday (anonymous computus)."""
    a = year % 19
    b, c = divmod(year, 100)
    d, e = divmod(b, 4)
    g = (8 * b + 13) // 25
    h = (19 * a + b - d - g + 15) % 30
    i, k = divmod(c, 4)
    l = (32 + 2 * e + 2 * i - h - k) % 7
    m = (a + 11 * h + 22 * l) // 451
    month = (h + l - 7 * m + 114) // 31
    day = (h + l - 7 * m + 114) % 31 + 1
    return _dt.date(year, month, day)


def _us(year: int):
    yield "New Year's Day", _dt.date(year, 1, 1)
    yield "Martin Luther King Jr. Day", _nth_weekday(year, 1, 0, 3)
    yield "Washington's Birthday", _nth_weekday(year, 2, 0, 3)
    yield "Memorial Day", _last_weekday(year, 5, 0)
    if year >= 2021:
        yield "Juneteenth", _dt.date(year, 6, 19)
    yield "Independence Day", _dt.date(year, 7, 4)
    yield "Labor Day", _nth_weekday(year, 9, 0, 1)
    yield "Columbus Day", _nth_weekday(year, 10, 0, 2)
    yield "Veterans Day", _dt.date(year, 11, 11)
    yield "Thanksgiving", _nth_weekday(year, 11, 3, 4)
    yield "Christmas Day", _dt.date(year, 12, 25)


def _ca(year: int):
    easter = _easter(year)
    yield "New Year's Day", _dt.date(year, 1, 1)
    yield "Good Friday", easter - _dt.timedelta(days=2)
    # Victoria Day: the Monday on or before May 24.
    may24 = _dt.date(year, 5, 24)
    yield "Victoria Day", may24 - _dt.timedelta(days=may24.weekday() % 7)
    yield "Canada Day", _dt.date(year, 7, 1)
    yield "Labour Day", _nth_weekday(year, 9, 0, 1)
    yield "Thanksgiving", _nth_weekday(year, 10, 0, 2)
    yield "Christmas Day", _dt.date(year, 12, 25)
    yield "Boxing Day", _dt.date(year, 12, 26)


def _gb(year: int):
    easter = _easter(year)
    yield "New Year's Day", _dt.date(year, 1, 1)
    yield "Good Friday", easter - _dt.timedelta(days=2)
    yield "Easter Monday", easter + _dt.timedelta(days=1)
    yield "Early May Bank Holiday", _nth_weekday(year, 5, 0, 1)
    yield "Spring Bank Holiday", _last_weekday(year, 5, 0)
    yield "Summer Bank Holiday", _last_weekday(year, 8, 0)
    yield "Christmas Day", _dt.date(year, 12, 25)
    yield "Boxing Day", _dt.date(year, 12, 26)


def _de(year: int):
    easter = _easter(year)
    yield "Neujahr", _dt.date(year, 1, 1)
    yield "Karfreitag", easter - _dt.timedelta(days=2)
    yield "Ostermontag", easter + _dt.timedelta(days=1)
    yield "Tag der Arbeit", _dt.date(year, 5, 1)
    yield "Christi Himmelfahrt", easter + _dt.timedelta(days=39)
    yield "Pfingstmontag", easter + _dt.timedelta(days=50)
    yield "Tag der Deutschen Einheit", _dt.date(year, 10, 3)
    yield "Erster Weihnachtstag", _dt.date(year, 12, 25)
    yield "Zweiter Weihnachtstag", _dt.date(year, 12, 26)


def _fr(year: int):
    easter = _easter(year)
    yield "Jour de l'an", _dt.date(year, 1, 1)
    yield "Lundi de Paques", easter + _dt.timedelta(days=1)
    yield "Fete du Travail", _dt.date(year, 5, 1)
    yield "Victoire 1945", _dt.date(year, 5, 8)
    yield "Ascension", easter + _dt.timedelta(days=39)
    yield "Lundi de Pentecote", easter + _dt.timedelta(days=50)
    yield "Fete nationale", _dt.date(year, 7, 14)
    yield "Assomption", _dt.date(year, 8, 15)
    yield "Toussaint", _dt.date(year, 11, 1)
    yield "Armistice 1918", _dt.date(year, 11, 11)
    yield "Noel", _dt.date(year, 12, 25)


def _it(year: int):
    easter = _easter(year)
    yield "Capodanno", _dt.date(year, 1, 1)
    yield "Epifania", _dt.date(year, 1, 6)
    yield "Lunedi dell'Angelo", easter + _dt.timedelta(days=1)
    yield "Festa della Liberazione", _dt.date(year, 4, 25)
    yield "Festa del Lavoro", _dt.date(year, 5, 1)
    yield "Festa della Repubblica", _dt.date(year, 6, 2)
    yield "Ferragosto", _dt.date(year, 8, 15)
    yield "Tutti i Santi", _dt.date(year, 11, 1)
    yield "Immacolata Concezione", _dt.date(year, 12, 8)
    yield "Natale", _dt.date(year, 12, 25)
    yield "Santo Stefano", _dt.date(year, 12, 26)


def _es(year: int):
    easter = _easter(year)
    yield "Ano Nuevo", _dt.date(year, 1, 1)
    yield "Epifania del Senor", _dt.date(year, 1, 6)
    yield "Viernes Santo", easter - _dt.timedelta(days=2)
    yield "Fiesta del Trabajo", _dt.date(year, 5, 1)
    yield "Asuncion de la Virgen", _dt.date(year, 8, 15)
    yield "Fiesta Nacional", _dt.date(year, 10, 12)
    yield "Todos los Santos", _dt.date(year, 11, 1)
    yield "Dia de la Constitucion", _dt.date(year, 12, 6)
    yield "Inmaculada Concepcion", _dt.date(year, 12, 8)
    yield "Navidad", _dt.date(year, 12, 25)


def _br(year: int):
    easter = _easter(year)
    yield "Confraternizacao Universal", _dt.date(year, 1, 1)
    yield "Carnaval", easter - _dt.timedelta(days=47)  # Shrove Tuesday
    yield "Sexta-feira Santa", easter - _dt.timedelta(days=2)
    yield "Tiradentes", _dt.date(year, 4, 21)
    yield "Dia do Trabalhador", _dt.date(year, 5, 1)
    yield "Corpus Christi", easter + _dt.timedelta(days=60)
    yield "Independencia", _dt.date(year, 9, 7)
    yield "Nossa Senhora Aparecida", _dt.date(year, 10, 12)
    yield "Finados", _dt.date(year, 11, 2)
    yield "Proclamacao da Republica", _dt.date(year, 11, 15)
    yield "Natal", _dt.date(year, 12, 25)


def _jp(year: int):
    # Fixed-date subset (equinox days and Happy-Monday shifts post-2000
    # are approximated by their statutory rules below).  Era-dependent
    # dates are year-gated: the Emperor's Birthday moved with the era
    # (Dec 23 under Heisei 1989-2018, Feb 23 under Reiwa from 2020; none
    # gazetted in the 2019 transition year), and the Apr 29 / May 4 pair
    # was relabeled in 2007 (Apr 29: Greenery Day -> Showa Day; May 4:
    # citizens' rest day -> Greenery Day).
    yield "New Year's Day", _dt.date(year, 1, 1)
    if year >= 2000:
        yield "Coming of Age Day", _nth_weekday(year, 1, 0, 2)
    yield "National Foundation Day", _dt.date(year, 2, 11)
    if year >= 2020:
        yield "Emperor's Birthday", _dt.date(year, 2, 23)
    if year >= 2007:
        yield "Showa Day", _dt.date(year, 4, 29)
        yield "Greenery Day", _dt.date(year, 5, 4)
    else:
        yield "Greenery Day", _dt.date(year, 4, 29)
    yield "Constitution Day", _dt.date(year, 5, 3)
    yield "Children's Day", _dt.date(year, 5, 5)
    if year >= 2003:
        yield "Marine Day", _nth_weekday(year, 7, 0, 3)
    if year >= 2016:
        yield "Mountain Day", _dt.date(year, 8, 11)
    if year >= 2003:
        yield "Respect for the Aged Day", _nth_weekday(year, 9, 0, 3)
    if year >= 2000:
        yield "Health and Sports Day", _nth_weekday(year, 10, 0, 2)
    yield "Culture Day", _dt.date(year, 11, 3)
    yield "Labour Thanksgiving Day", _dt.date(year, 11, 23)
    if 1989 <= year <= 2018:
        yield "Emperor's Birthday", _dt.date(year, 12, 23)


def _in(year: int):
    # Pan-India gazetted fixed-date holidays (movable religious holidays
    # follow lunar calendars and need an external table — pass them via
    # holidays_from_df / Holiday.from_dates).
    yield "Republic Day", _dt.date(year, 1, 26)
    yield "Independence Day", _dt.date(year, 8, 15)
    yield "Gandhi Jayanti", _dt.date(year, 10, 2)
    yield "Christmas Day", _dt.date(year, 12, 25)


_COUNTRIES = {
    "US": _us, "CA": _ca, "GB": _gb, "UK": _gb, "DE": _de,
    "FR": _fr, "IT": _it, "ES": _es, "BR": _br, "JP": _jp, "IN": _in,
}


def country_holidays(
    country: str,
    years: Sequence[int],
    lower_window: int = 0,
    upper_window: int = 0,
    prior_scale: float = 10.0,
    mode: str = "additive",
) -> Tuple[Holiday, ...]:
    """Computed holiday calendar for a country over the given years."""
    gen = _COUNTRIES.get(country.upper())
    if gen is None:
        raise ValueError(
            f"unknown country {country!r}; available: {sorted(set(_COUNTRIES))}"
        )
    by_name: dict = {}
    for year in years:
        for name, date in gen(year):
            by_name.setdefault(name, []).append(_date_to_days(date))
    return tuple(
        Holiday(
            name=name,
            dates=tuple(days),
            lower_window=lower_window,
            upper_window=upper_window,
            prior_scale=prior_scale,
            mode=mode,
        )
        for name, days in sorted(by_name.items())
    )


# ---------------------------------------------------------------------------
# Feature expansion
# ---------------------------------------------------------------------------


def holiday_column_configs(
    holidays: Sequence[Holiday],
) -> Tuple[RegressorConfig, ...]:
    """One RegressorConfig per (holiday, offset) indicator column."""
    cols = []
    for h in holidays:
        for off in h.offsets:
            suffix = "" if off == 0 else f"_{off:+d}"
            cols.append(
                RegressorConfig(
                    name=f"{h.name}{suffix}",
                    prior_scale=h.prior_scale,
                    standardize=False,
                    mode=h.mode,
                )
            )
    return tuple(cols)


def holiday_features(
    ds_days: np.ndarray, holidays: Sequence[Holiday]
) -> np.ndarray:
    """0/1 indicator matrix (T, H) on a calendar grid (absolute days).

    Grid timestamps match a holiday occurrence when they fall on the same
    calendar day (floor of the fractional day — so every hour of a sub-daily
    grid on Dec 25 matches Christmas), shifted by each window offset.
    """
    grid = np.floor(np.asarray(ds_days, np.float64)).astype(np.int64)
    cols = []
    for h in holidays:
        days = np.floor(np.asarray(h.dates, np.float64)).astype(np.int64)
        for off in h.offsets:
            cols.append(np.isin(grid, days + off).astype(np.float32))
    if not cols:
        return np.zeros((len(grid), 0), np.float32)
    return np.stack(cols, axis=-1)


def add_holidays(
    config: ProphetConfig, holidays: Sequence[Holiday]
) -> ProphetConfig:
    """Config with the holiday indicator columns appended as regressors."""
    return dataclasses.replace(
        config, regressors=config.regressors + holiday_column_configs(holidays)
    )
