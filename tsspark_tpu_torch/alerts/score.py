"""Deterministic anomaly scoring of landed deltas.

After each delta lands, the advanced rows' NEWEST observations are
scored against the active version's *served* forecast:

* **interval mode** — the version publishes a quantile plane
  (``uncertainty.qplane``): an observation outside the served
  ``[q_lo, q_hi]`` interval fires, severity = distance outside the
  interval in interval widths.  Served through ``engine.quantiles``,
  whose compute fallback bitwise-reproduces plane cells, so the mode
  decision keys off the VERSION (plane published or not), never off
  transient attach state.
* **z-score fallback** — no quantile plane for the version: residual
  z-score of the observation against the served point forecast, with
  the scale estimated from the patch window's first differences.  The
  degradation is recorded on every alert it produced (``degraded``).

Scoring is a pure function of (delta patch bytes, served forecast,
config thresholds) — all deterministic per (series, delta_seq,
version) — so a re-score after any crash converges bitwise to the
original record: :func:`canonical_bytes` of the record dict is the
unit the alert log's CRC sentinel certifies.

The decision core (:func:`score_rows`) is plain NumPy over served
arrays: no kernel launch, raw filesystem write or spawn is reachable
from it.  The served arrays come from the engine: a plane read, or K1 on
a miss.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

#: Alert record schema (bumped on any canonical-layout change: the CRC
#: sentinel certifies bytes, so layout drift must be explicit).
SCHEMA = 1

#: z-score threshold of the fallback mode (|z| above this fires).
DEFAULT_Z = 3.0

#: Served interval of the primary mode: (lo, hi) quantiles.
DEFAULT_QUANTILES = (0.1, 0.9)

#: Floor for interval widths / residual scales — a constant series must
#: not turn every exact repeat into a division blow-up.
_EPS = 1e-9


def default_z() -> float:
    """The fallback-mode threshold, overridable via ``TSSPARK_ALERTS_Z``
    (a bad value falls back to the default rather than killing the
    scorer: thresholds are policy, not protocol)."""
    raw = os.environ.get("TSSPARK_ALERTS_Z")
    if raw is None:
        return DEFAULT_Z
    try:
        z = float(raw)
    except ValueError:
        return DEFAULT_Z
    return z if z > 0 else DEFAULT_Z


# ---------------------------------------------------------------------------
# the decision core (pure NumPy, no IO)
# ---------------------------------------------------------------------------


def score_rows(
    y: np.ndarray,
    *,
    lo: Optional[np.ndarray] = None,
    hi: Optional[np.ndarray] = None,
    yhat: Optional[np.ndarray] = None,
    sigma: Optional[np.ndarray] = None,
    z: float = DEFAULT_Z,
) -> Tuple[np.ndarray, np.ndarray, str]:
    """Vectorized breach decision for a batch of observations.

    Interval mode when ``lo``/``hi`` are given (fired = outside the
    interval; severity = distance outside in interval widths), else
    z-score mode against ``yhat``/``sigma`` (fired = |z| > threshold;
    severity = excess |z| in threshold units).  Returns
    ``(fired bool[k], severity float64[k], mode)``.  Pure and
    deterministic: same inputs, same bits."""
    y = np.asarray(y, np.float64)
    if lo is not None and hi is not None:
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        width = np.maximum(hi - lo, _EPS)
        below = y < lo
        above = y > hi
        fired = below | above
        dist = np.where(below, lo - y, np.where(above, y - hi, 0.0))
        return fired, dist / width, "interval"
    if yhat is None or sigma is None:
        raise ValueError("score_rows needs lo/hi or yhat/sigma")
    yhat = np.asarray(yhat, np.float64)
    sigma = np.maximum(np.asarray(sigma, np.float64), _EPS)
    zs = np.abs(y - yhat) / sigma
    fired = zs > float(z)
    sev = np.maximum(zs - float(z), 0.0) / float(z)
    return fired, sev, "zscore"


def residual_scale(y: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Per-row local noise scale for the z-score fallback: std of the
    observed window's first differences (floored).  Uses only the
    delta patch itself, so the fallback needs nothing beyond the point
    forecast — deterministic by construction."""
    y = np.asarray(y, np.float64)
    m = np.asarray(mask, np.float64) > 0
    out = np.empty(y.shape[0], np.float64)
    for i in range(y.shape[0]):
        vals = y[i][m[i]]
        d = np.diff(vals)
        out[i] = float(np.std(d)) if d.size else 0.0
    return np.maximum(out, _EPS)


def newest_observations(patch: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(values, window positions) of each patched row's newest OBSERVED
    sample — the observation the delta just delivered, the thing the
    served forecast is judged against."""
    y = np.asarray(patch["y"], np.float64)
    m = np.asarray(patch["mask"], np.float64) > 0
    w = m.shape[1]
    # Index of the last observed column (rows are never landed fully
    # unobserved; an all-hole row degrades to the last column).
    pos = np.where(m.any(axis=1),
                   w - 1 - np.argmax(m[:, ::-1], axis=1), w - 1)
    vals = y[np.arange(y.shape[0]), pos]
    return vals, pos.astype(np.int64)


# ---------------------------------------------------------------------------
# canonical record bytes (what the CRC sentinel certifies)
# ---------------------------------------------------------------------------


def canonical_bytes(record: Dict) -> bytes:
    """The record's one true serialization: sorted keys, no whitespace,
    shortest-round-trip floats.  Bitwise re-score = byte-equal output
    of this function — the property a torn-record repair relies on."""
    return json.dumps(record, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def record_crc(record: Dict) -> int:
    return zlib.crc32(canonical_bytes(record)) & 0xFFFFFFFF


def _r(x: float) -> float:
    """Canonical float rounding for record payloads: deterministic and
    readable; 6 decimals is far inside float64's round-trip band."""
    return round(float(x), 6)


# ---------------------------------------------------------------------------
# one delta -> one alert record
# ---------------------------------------------------------------------------


def alert_key(kind: str, series: str, seq: int) -> str:
    """The exactly-once dedup key: (kind, series, delta_seq).  Delivery
    may repeat after a kill; a sink consumer deduping on this key sees
    each alert exactly once."""
    return f"{kind}:{series}:{int(seq)}"


def score_delta(engine, dset_dir: str, seq: int, *,
                horizon: int = 1,
                quantiles: Sequence[float] = DEFAULT_QUANTILES,
                z: Optional[float] = None) -> Dict:
    """Score one landed delta's advanced rows against the active
    version's served forecast; returns the canonical alert record
    (sorted by plane row, floats canonically rounded — ready for
    :func:`canonical_bytes`).

    Raises ``ValueError`` when the delta's patch is unreadable (a torn
    patch is data-plane corruption, not an empty alert set)."""
    from tsspark_tpu_torch.data import plane
    from tsspark_tpu_torch.uncertainty import qplane

    z = default_z() if z is None else float(z)
    patch = plane.delta_patch(dset_dir, int(seq))
    if patch is None:
        raise ValueError(f"delta {seq} has no readable patch in "
                         f"{dset_dir!r}")
    spec_rec = plane.read_spec(dset_dir)
    if spec_rec is None:
        raise ValueError(f"{dset_dir!r} is not a plane dataset")
    all_ids = plane.series_ids(plane.DatasetSpec.from_dict(spec_rec))
    rows = np.asarray(patch["rows"], np.int64)
    order = np.argsort(rows, kind="stable")
    rows = rows[order]
    y_new, _pos = newest_observations(patch)
    y_new = y_new[order]
    sids = [str(all_ids[int(r)]) for r in rows]

    h = int(horizon)
    qlo, qhi = float(min(quantiles)), float(max(quantiles))

    def _covered(v: Optional[int]) -> bool:
        # Mode keys off the VERSION's published quantile plane, a
        # durable property — never off transient attach state, so a
        # successor's re-score makes the same decision.  The compute
        # fallback under engine.quantiles reproduces plane cells
        # bitwise, so interval numbers are identical either way.
        return v is not None and qplane.has_qplane(
            engine.registry.version_dir(int(v))
        )

    version = engine.served_version()
    if version is None:
        version = engine.registry.active_version()
    covered = _covered(version)
    for _attempt in range(2):
        if covered:
            res = engine.quantiles(sids, h, quantiles=(qlo, qhi))
            version = int(res.version)
            if not _covered(version) and _attempt == 0:
                covered = False   # flip landed mid-call: redo once
                continue
            lo = res.values[f"q{qplane.permille(qlo):03d}"][:, h - 1]
            hi = res.values[f"q{qplane.permille(qhi):03d}"][:, h - 1]
            fired, sev, mode = score_rows(y_new, lo=lo, hi=hi)
            bounds = [(_r(a), _r(b)) for a, b in zip(lo, hi)]
        else:
            fres = engine.forecast(sids, h)
            version = int(fres.version)
            if _covered(version) and _attempt == 0:
                covered = True
                continue
            yhat = fres.values["yhat"][:, h - 1]
            sigma = residual_scale(patch["y"], patch["mask"])[order]
            fired, sev, mode = score_rows(y_new, yhat=yhat,
                                          sigma=sigma, z=z)
            bounds = [(_r(a), _r(b)) for a, b in zip(yhat, sigma)]
        break

    alerts = []
    for i in range(len(rows)):
        if not fired[i]:
            continue
        a = {
            "key": alert_key("anomaly", sids[i], seq),
            "kind": "anomaly",
            "series": sids[i],
            "row": int(rows[i]),
            "seq": int(seq),
            "version": version,
            "mode": mode,
            "degraded": not covered,
            "y": _r(y_new[i]),
            "severity": _r(sev[i]),
        }
        if mode == "interval":
            a["lo"], a["hi"] = bounds[i]
        else:
            a["yhat"], a["sigma"] = bounds[i]
            a["z"] = _r(z)
        alerts.append(a)
    return {
        "kind": "alert-record",
        "schema": SCHEMA,
        "seq": int(seq),
        "version": version,
        "mode": mode,
        "degraded": not covered,
        "horizon": h,
        "quantiles": [_r(qlo), _r(qhi)],
        "z": _r(z),
        "n_scored": int(len(rows)),
        "n_fired": int(len(alerts)),
        "n_suppressed": int(len(rows) - len(alerts)),
        "alerts": alerts,
    }
