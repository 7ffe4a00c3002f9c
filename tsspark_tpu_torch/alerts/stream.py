"""The durable alert log and its exactly-once delivery watermark.

Layout (one directory per scored dataset, unified plane-protocol
discipline):

* ``alerts_spec.json``      — identity record, spec FIRST.
* ``alertrec_<seq>.json``   — one canonical alert record per delta,
  landed atomically through the durable layer (``io.atomic_write``).
* ``alertok_<seq>.json``    — CRC sentinel LAST: certifies the record's
  canonical bytes.  A record without its sentinel (killed scorer) or
  failing its CRC (torn bytes) reads as UNSCORED and is re-scored —
  bitwise the original, by the determinism contract of
  ``alerts.score``.
* ``alerts_watermark.json`` — delivery watermark: the highest seq whose
  alerts the sink has ALL acked, replaced atomically only after the
  acks.  A torn/absent watermark reads as 0 — redelivery is always
  safe because every alert carries its (kind, series, delta_seq) key
  and the sink's key set dedups it.
* ``alerts_queue.jsonl``    — durable overflow queue for loose
  (non-record) alerts an open breaker refused; drained on recovery,
  deduped by key.

The exactly-once argument: scoring is resumable (sentinel gate),
delivery is at-least-once (watermark advances only after sink ack), and
every alert is keyed — at-least-once + keyed dedup = exactly-once
effect.

Fault points (``resilience.faults``): ``alert_publish`` brackets every
step of the record protocol (a kill drill ends the scorer in each
window);
``alert_deliver`` fires before every sink emit attempt (kill
mid-delivery, brownout).
"""

from __future__ import annotations

import collections
import json
import os
import time
import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from tsspark_tpu_torch.alerts.score import (
    DEFAULT_QUANTILES,
    alert_key,
    canonical_bytes,
    score_delta,
)
from tsspark_tpu_torch.alerts.sink import AlertSink, SinkError
from tsspark_tpu_torch.io import (
    StorageError,
    append_line,
    atomic_write,
    current_state,
    is_missing,
    reraise_classified,
)
from tsspark_tpu_torch.obs import context as obs
from tsspark_tpu_torch.obs.metrics import DEFAULT as METRICS
from tsspark_tpu_torch.plane import protocol
from tsspark_tpu_torch.resilience import faults
from tsspark_tpu_torch.resilience.policy import (
    CircuitBreaker,
    CircuitOpen,
    RetryPolicy,
)

#: Fault point bracketing each step of the alert-record publish.
ALERT_PUBLISH = "alert_publish"
#: Fault point before every sink emit attempt.
ALERT_DELIVER = "alert_deliver"

SPEC_FILE = "alerts_spec.json"
WATERMARK_FILE = "alerts_watermark.json"
QUEUE_FILE = "alerts_queue.jsonl"
REC_PREFIX = "alertrec_"
OK_PREFIX = "alertok_"

#: Bounded land->alert freshness sample window (daemon runs forever).
FRESHNESS_WINDOW = 4096

#: Alert fields that survive disk-ladder detail shedding: identity and
#: routing only.  Alerts are NEVER dropped by the ladder — only their
#: scoring context is shed.
_CORE_FIELDS = ("key", "kind", "series", "row", "seq", "version",
                "mode", "severity")

#: Ladder states at which delivery sheds scoring detail (rung 2+: the
#: disk is the thing under pressure, and alert context is the cheapest
#: payload to shrink before anything load-bearing degrades).
_SHED_STATES = ("reap", "pause_ingest", "stale_serve")


def _default_retry() -> RetryPolicy:
    # Tight by default: an alert pipeline must shed to the durable
    # queue quickly, not stall the scorer behind 10 s sink sleeps.
    return RetryPolicy(max_attempts=3, base_delay_s=0.05, backoff=2.0,
                       max_delay_s=0.5)


class AlertStream:
    """One alert log + delivery pipeline over (dataset, engine, sink).

    Crash recovery is a NEW instance over the same ``alerts_dir``: the
    constructor repairs sink state, and :meth:`poll_once` re-scores any
    delta without a valid sentinel and re-delivers everything past the
    watermark (deduped by the sink's key set)."""

    def __init__(self, alerts_dir: str, dset_dir: str, engine,
                 sink: AlertSink, *,
                 horizon: int = 1,
                 quantiles: Sequence[float] = DEFAULT_QUANTILES,
                 z: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 overdue_k: float = 3.0,
                 clock=time.time):
        self.dir = str(alerts_dir)
        self.dset_dir = str(dset_dir)
        self.engine = engine
        self.sink = sink
        self.horizon = int(horizon)
        self.quantiles = tuple(float(q) for q in quantiles)
        self.z = z
        self.overdue_k = float(overdue_k)
        self.retry = retry if retry is not None else _default_retry()
        self.breaker = breaker if breaker is not None else \
            CircuitBreaker(failure_threshold=3, reset_timeout_s=1.0,
                           name="alert-sink")
        self._clock = clock
        os.makedirs(self.dir, exist_ok=True)
        self.sink.recover()

        self._records: Dict[int, Dict] = {}   # sentinel-verified cache
        self._land_unix: Dict[int, float] = {}
        self._row_last_seq: Dict[int, int] = {}
        self._arrivals = None                 # lazy sched.ArrivalModel
        self._ids: Optional[np.ndarray] = None
        self.freshness: "collections.deque" = collections.deque(
            maxlen=FRESHNESS_WINDOW
        )
        self._m_fired = METRICS.counter("tsspark_alerts_fired_total")
        self._m_supp = METRICS.counter(
            "tsspark_alerts_suppressed_total"
        )
        self._m_delivered = METRICS.counter(
            "tsspark_alerts_delivered_total"
        )
        self._m_dedup = METRICS.counter("tsspark_alerts_dedup_total")
        self._m_liveness = METRICS.counter(
            "tsspark_alerts_liveness_total"
        )
        self._m_queued = METRICS.gauge("tsspark_alerts_queued")
        self._m_breaker = METRICS.gauge("tsspark_alerts_breaker_open")
        self._m_watermark = METRICS.gauge(
            "tsspark_alerts_watermark_seq"
        )
        self._m_fresh = METRICS.gauge(
            "tsspark_alerts_freshness_last_seconds"
        )
        self._m_fresh_hist = METRICS.histogram(
            "tsspark_alerts_freshness_seconds"
        )

    # -- paths (readers; write sites build literals inline) --------------------

    def _spec_path(self) -> str:
        return os.path.join(self.dir, SPEC_FILE)

    def _rec_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{REC_PREFIX}{int(seq):06d}.json")

    def _ok_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{OK_PREFIX}{int(seq):06d}.json")

    def _queue_path(self) -> str:
        return os.path.join(self.dir, QUEUE_FILE)

    # -- the durable record protocol -------------------------------------------

    def record_ok(self, seq: int) -> Optional[Dict]:
        """The sentinel-certified record for ``seq``, or None when the
        record is absent, unsentineled, or fails its CRC — all of which
        read as UNSCORED (the re-score converges bitwise).  A real disk
        failure raises its typed storage error."""
        seq = int(seq)
        cached = self._records.get(seq)
        if cached is not None:
            return cached
        ok = protocol.read_json(self._ok_path(seq))
        if ok is None or not isinstance(ok.get("crc"), int):
            return None
        try:
            with open(self._rec_path(seq), "rb") as fh:
                raw = fh.read()
        except OSError as e:
            if is_missing(e):
                return None
            reraise_classified(e)
        if (zlib.crc32(raw) & 0xFFFFFFFF) != int(ok["crc"]):
            return None  # torn/corrupt record: sentinel rejects it
        try:
            rec = json.loads(raw.decode("utf-8"))
        except ValueError:
            return None
        if not isinstance(rec, dict) or int(rec.get("seq", -1)) != seq:
            return None
        self._records[seq] = rec
        return rec

    def _ensure_spec(self) -> None:
        if protocol.read_json(self._spec_path()) is not None:
            return
        protocol.write_spec(self._spec_path(), {
            "kind": "alerts-spec",
            "schema": 1,
            "dataset": os.path.basename(self.dset_dir.rstrip(os.sep)),
            "horizon": self.horizon,
            "quantiles": list(self.quantiles),
            "sink": self.sink.name,
        })

    def score_seq(self, seq: int) -> Dict:
        """Score delta ``seq`` and publish its alert record under the
        plane-protocol discipline: spec FIRST, atomic record payload,
        CRC sentinel LAST.  Idempotent — a re-publish lands byte-equal
        files."""
        seq = int(seq)
        self._ensure_spec()
        record = score_delta(self.engine, self.dset_dir, seq,
                             horizon=self.horizon,
                             quantiles=self.quantiles, z=self.z)
        payload = canonical_bytes(record)
        rec_path = os.path.join(self.dir,
                                f"alertrec_{seq:06d}.json")
        faults.inject(ALERT_PUBLISH, path=rec_path)
        atomic_write(rec_path, lambda fh: fh.write(payload))
        ok_path = os.path.join(self.dir, f"alertok_{seq:06d}.json")
        faults.inject(ALERT_PUBLISH, path=ok_path)
        protocol.write_sentinel(ok_path, {
            "kind": "alert-record-ok",
            "seq": seq,
            "crc": zlib.crc32(payload) & 0xFFFFFFFF,
            "n_alerts": int(record["n_fired"]),
        })
        faults.inject(ALERT_PUBLISH, path=ok_path)
        self._m_fired.inc(int(record["n_fired"]))
        self._m_supp.inc(int(record["n_suppressed"]))
        self._records[seq] = record
        return record

    def scored_seq(self) -> int:
        """Highest CONTIGUOUSLY certified record seq (resume frontier:
        the first gap or torn record is where re-scoring starts)."""
        seq = 0
        while self.record_ok(seq + 1) is not None:
            seq += 1
        return seq

    # -- the delivery watermark ------------------------------------------------

    def delivered_seq(self) -> int:
        """The delivery watermark: every alert of every record at or
        below it has been acked by the sink.  Torn/absent reads as 0 —
        redelivery is deduped, so the watermark is a fast-forward
        pointer, never a correctness input."""
        wm = protocol.read_json(os.path.join(self.dir, WATERMARK_FILE))
        if wm is None or not isinstance(wm.get("seq"), int):
            return 0
        return int(wm["seq"])

    def _advance_watermark(self, seq: int) -> None:
        atomic_write(
            os.path.join(self.dir, "alerts_watermark.json"),
            lambda fh: json.dump({
                "kind": "alert-watermark",
                "seq": int(seq),
                "unix": round(float(self._clock()), 3),
            }, fh),
            mode="w",
        )
        self._m_watermark.set(float(seq))

    # -- delivery ---------------------------------------------------------------

    def _shed(self, alert: Dict) -> Dict:
        st = current_state(self.dir)
        if st not in _SHED_STATES:
            return alert
        kept = {k: alert[k] for k in _CORE_FIELDS if k in alert}
        kept["shed"] = st
        return kept

    def _emit(self, alert: Dict) -> None:
        """One at-least-once emit under retry + breaker.  Raises
        ``CircuitOpen`` / ``SinkError`` / storage errors when the sink
        stays down — the caller leaves the alert durably queued."""
        payload = self._shed(alert)

        def attempt():
            faults.inject(ALERT_DELIVER, path=self.sink.name)
            self.sink.emit(payload)

        self.retry.call(attempt, retry_on=(SinkError, OSError),
                        breaker=self.breaker)
        self._m_delivered.inc()

    def deliver_pending(self) -> Dict:
        """Deliver every certified record past the watermark, in seq
        order, deduping against the sink's key set; advance the
        watermark only after a record's alerts ALL acked.  Stops (and
        leaves the rest durably queued in the record log) when the
        sink stays down."""
        wm = self.delivered_seq()
        known = self.sink.keys()
        out = {"delivered": 0, "deduped": 0, "records": 0,
               "stalled": False}
        seq = wm + 1
        while True:
            rec = self.record_ok(seq)
            if rec is None:
                break  # frontier: not yet scored (or torn -> re-score)
            try:
                for alert in rec["alerts"]:
                    if alert["key"] in known:
                        self._m_dedup.inc()
                        out["deduped"] += 1
                        continue
                    self._emit(alert)
                    known.add(alert["key"])
                    out["delivered"] += 1
            except (CircuitOpen, SinkError, StorageError, OSError) as e:
                obs.event("alerts.delivery_stalled", seq=seq,
                          error=repr(e),
                          breaker=self.breaker.state)
                out["stalled"] = True
                break
            self._advance_watermark(seq)
            out["records"] += 1
            self._note_freshness(seq, rec)
            seq += 1
        self._m_breaker.set(
            0.0 if self.breaker.state == CircuitBreaker.CLOSED else 1.0
        )
        return out

    def _note_freshness(self, seq: int, rec: Dict) -> None:
        t_land = self._land_unix.get(int(seq))
        if t_land is None:
            return  # resumed before poll learned the land time
        fr = max(0.0, float(self._clock()) - float(t_land))
        self.freshness.append((int(seq), fr))
        self._m_fresh.set(fr)
        self._m_fresh_hist.observe(fr)
        obs.record("alerts.freshness", t_land, fr, seq=int(seq),
                   version=int(rec["version"]),
                   n_alerts=int(rec["n_fired"]), mode=rec["mode"])

    # -- loose alerts (data-liveness) + the durable overflow queue -------------

    def _series_id(self, row: int) -> str:
        if self._ids is None:
            from tsspark_tpu_torch.data import plane

            spec_rec = plane.read_spec(self.dset_dir)
            if spec_rec is None:
                return str(row)
            self._ids = plane.series_ids(
                plane.DatasetSpec.from_dict(spec_rec)
            )
        if self._ids is None or row >= len(self._ids):
            return str(row)
        return str(self._ids[int(row)])

    def _note_arrivals(self, seq: int, unix: float, rows) -> None:
        if rows is None:
            return
        if self._arrivals is None:
            from tsspark_tpu_torch.sched import ArrivalModel

            self._arrivals = ArrivalModel()
        self._arrivals.note_delta(seq, unix, rows)
        for r in np.asarray(rows, np.int64).tolist():
            self._row_last_seq[int(r)] = int(seq)

    def liveness_alerts(self, now: Optional[float] = None) -> List[Dict]:
        """Data-liveness alerts off the arrival model: series whose
        learned cadence says a delta is overdue by more than
        ``overdue_k``x its EWMA inter-arrival.  Keyed by the series'
        LAST seen delta seq, so an overdue episode fires once and
        re-arms only when the series advances again."""
        if self._arrivals is None:
            return []
        now = float(self._clock()) if now is None else float(now)
        out = []
        overdue = self._arrivals.overdue_rows(now, k=self.overdue_k)
        for row in sorted(overdue):
            last_seq = self._row_last_seq.get(int(row))
            if last_seq is None:
                continue
            sid = self._series_id(int(row))
            out.append({
                "key": alert_key("data-liveness", sid, last_seq),
                "kind": "data-liveness",
                "series": sid,
                "row": int(row),
                "seq": int(last_seq),
                "mode": "liveness",
                "overdue_s": round(float(overdue[row]), 3),
            })
        return out

    def _queue_lines(self) -> List[Dict]:
        try:
            with open(self._queue_path(), "rb") as fh:
                raw = fh.read()
        except OSError as e:
            if is_missing(e):
                return []
            reraise_classified(e)
        out = []
        for line in raw.decode("utf-8", errors="replace").split("\n"):
            if not line.strip():
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue  # torn last line: its alert was re-queued or
                # re-derived; the fragment is inert
            if isinstance(d, dict) and d.get("key"):
                out.append(d)
        return out

    def _rewrite_queue(self, remaining: List[Dict]) -> None:
        if not remaining and not os.path.exists(self._queue_path()):
            return
        body = "".join(json.dumps(a, sort_keys=True) + "\n"
                       for a in remaining)
        atomic_write(self._queue_path(),
                     lambda fh: fh.write(body), mode="w")
        self._m_queued.set(float(len(remaining)))

    def deliver_loose(self, alerts: List[Dict]) -> Dict:
        """Deliver non-record alerts (liveness) plus whatever the
        durable queue holds: dedup by key, emit under retry/breaker,
        queue durably anything the sink refuses, drain on recovery.
        Exactly-once by the same argument as records — the queue file
        is the durable at-least-once side, the key set the dedup."""
        known = self.sink.keys()
        pending: List[Dict] = []
        seen: Set[str] = set()
        for a in self._queue_lines() + list(alerts):
            if a["key"] in known or a["key"] in seen:
                continue
            seen.add(a["key"])
            pending.append(a)
        delivered = 0
        remaining: List[Dict] = []
        stalled = False
        for i, a in enumerate(pending):
            if stalled:
                remaining.append(a)
                continue
            try:
                self._emit(a)
                if a["kind"] == "data-liveness":
                    self._m_liveness.inc()
                delivered += 1
            except (CircuitOpen, SinkError, StorageError, OSError) as e:
                obs.event("alerts.queue_stalled", error=repr(e),
                          breaker=self.breaker.state)
                stalled = True
                remaining.append(a)
        self._rewrite_queue(remaining)
        self._m_breaker.set(
            0.0 if self.breaker.state == CircuitBreaker.CLOSED else 1.0
        )
        return {"delivered": delivered, "queued": len(remaining),
                "stalled": stalled}

    # -- the poll loop ----------------------------------------------------------

    def poll_once(self, now: Optional[float] = None) -> Dict:
        """One cycle: fold new deltas into the arrival model, score
        every delta without a certified record (resume + fresh work in
        one motion), deliver past the watermark, then the liveness/
        queue path.  Safe to call from a fresh process at any time —
        this IS the crash recovery (the reference's name, kept)."""
        from tsspark_tpu_torch.data import plane

        now = float(self._clock()) if now is None else float(now)
        scored = 0
        for rec in plane.delta_records(self.dset_dir):
            seq = int(rec["seq"])
            unix = float(rec.get("unix") or now)
            self._land_unix.setdefault(seq, unix)
            if self._arrivals is None \
                    or seq > self._arrivals.seen_seq():
                self._note_arrivals(
                    seq, unix, plane.delta_rows(self.dset_dir, seq)
                )
            if self.record_ok(seq) is None:
                # Crash-safe open/close pair, not a context span: a
                # scorer killed INSIDE score_seq leaves engine spans
                # that must still resolve their parent in the ledger
                # after the process dies.
                t_sp = time.time()
                sid = obs.open_span("alerts.score", seq=seq)
                try:
                    self.score_seq(seq)
                finally:
                    obs.close_span(sid, "alerts.score", t_sp, seq=seq)
                scored += 1
        dres = self.deliver_pending()
        lres = self.deliver_loose(self.liveness_alerts(now))
        return {
            "scored": scored,
            "delivered": dres["delivered"] + lres["delivered"],
            "deduped": dres["deduped"],
            "records": dres["records"],
            "queued": lres["queued"],
            "stalled": dres["stalled"] or lres["stalled"],
            "watermark": self.delivered_seq(),
        }

    # -- telemetry ---------------------------------------------------------------

    def freshness_summary(self) -> Dict:
        vals = [fr for _seq, fr in self.freshness]
        arr = np.asarray(vals, np.float64)
        return {
            "n": len(vals),
            "p50_s": (round(float(np.percentile(arr, 50)), 4)
                      if vals else None),
            "p95_s": (round(float(np.percentile(arr, 95)), 4)
                      if vals else None),
            "mean_s": (round(float(arr.mean()), 4) if vals else None),
            "max_s": (round(float(arr.max()), 4) if vals else None),
        }

    def snapshot(self) -> Dict:
        return {
            "scored_seq": self.scored_seq(),
            "delivered_seq": self.delivered_seq(),
            "queued": len(self._queue_lines()),
            "breaker": self.breaker.snapshot(),
            "freshness": self.freshness_summary(),
            "disk_ladder": current_state(self.dir),
        }
