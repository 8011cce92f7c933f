"""Request-level tracing and the SLO plane (port of
``horovod_tpu/tracing.py``: the same span records, SLO math, documents,
Chrome conversion and report).

The other planes are step- or process-centric: metrics aggregate, the
flight recorder keeps crash-time evidence, the step profiler attributes one
training step. None of them answers "where did request X's p99 go": queue
wait, the KV-transport hop, admission delay, prefill, decode-block
contention, or a requeue after a replica died. This module does:

* **Trace context.** Every request gets a ``trace_id`` at submit
  (:func:`new_trace_id`); it rides the request through both queue
  transports (``Request.trace_id`` is part of the KV wire format) and into
  every flight-recorder event on the serve path.
* **Spans.** Each phase of a request (submit, queue wait, prefill, decode
  block, serve, response) and each collective of the enqueue runtime
  (``runtime/executor.py``) records one span: a small dict appended to a
  ``maxlen``-bounded deque (one append under the GIL, no lock), recorded
  when the phase ends. Spans ride the profiler's dump (``request_spans``)
  and ``profiler.merge_profile_dir`` lays them out as per-rank request
  lanes, joining one ``trace_id`` across ranks with flow arrows.
* **SLOs.** ``HOROVOD_SLO_TTFT_MS``, ``HOROVOD_SLO_LATENCY_MS`` and
  ``HOROVOD_SLO_AVAILABILITY`` are tracked as rolling good/bad windows
  with error-budget and burn-rate gauges (``horovod_slo_*``), the ``GET
  /slo`` route (``metrics.py``), one ``slo_burn_rate`` flight event per
  upward crossing of ``HOROVOD_SLO_BURN_ALERT``, and the slowest requests
  kept as exemplars with their phases.

``/healthz`` reads :func:`healthz_state`: ready once ``hvd.init()`` ran
(:func:`configure`) and, while this process serves, once a replica has
shown it is alive (:func:`note_replica_heartbeat`).

Knobs (``utils/env.py``): ``HOROVOD_TRACE`` (on; ``0`` turns it off, an
integer > 1 is the ring's capacity, default 4096), ``HOROVOD_SLO_TTFT_MS``
(1000), ``HOROVOD_SLO_LATENCY_MS`` (10000), ``HOROVOD_SLO_AVAILABILITY``
(0.999), ``HOROVOD_SLO_WINDOW`` (512 requests), ``HOROVOD_SLO_BURN_ALERT``
(14).
"""

from __future__ import annotations

import os
import threading
import uuid
from collections import deque
from typing import Dict, List, Optional

from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils.env import (DEFAULT_SLO_WINDOW, HOROVOD_RANK,
                                         HOROVOD_SLO_AVAILABILITY,
                                         HOROVOD_SLO_BURN_ALERT,
                                         HOROVOD_SLO_LATENCY_MS,
                                         HOROVOD_SLO_TTFT_MS,
                                         HOROVOD_SLO_WINDOW, HOROVOD_TRACE,
                                         _get_float, _get_int, parse_trace)

SCHEMA = "horovod-tracing-v1"
OBJECTIVES = ("ttft", "latency", "availability")
# slowest-request exemplars kept, each with its phases
_EXEMPLARS_MAX = 8

_SPANS_TOTAL = _metrics().counter(
    "horovod_trace_spans_total",
    "Spans recorded into the tracing ring buffer.")
_SLO_EVENTS = _metrics().counter(
    "horovod_slo_events_total",
    "Requests scored against each SLO objective, by verdict.",
    labelnames=("objective", "verdict"))
_SLO_BURN = _metrics().gauge(
    "horovod_slo_burn_rate",
    "Observed bad-event rate over the rolling window divided by the "
    "rate the objective allows (1.0 = burning budget exactly at the "
    "sustainable rate).",
    labelnames=("objective",))
_SLO_BUDGET = _metrics().gauge(
    "horovod_slo_error_budget_remaining",
    "Fraction of the rolling window's error budget still unspent "
    "(1.0 = clean window, 0.0 = budget exhausted).",
    labelnames=("objective",))
_SLO_ALERTS = _metrics().counter(
    "horovod_slo_burn_alerts_total",
    "Burn-rate threshold crossings (HOROVOD_SLO_BURN_ALERT).",
    labelnames=("objective",))


def new_trace_id() -> str:
    """A fresh 16-hex-character trace id (the wire format everywhere)."""
    return uuid.uuid4().hex[:16]


class Tracer:
    """Bounded span ring. ``record`` builds one small dict and appends it
    to a maxlen deque (atomic under the GIL; the oldest span goes)."""

    def __init__(self) -> None:
        enabled, capacity = parse_trace(os.environ.get(HOROVOD_TRACE))
        self.enabled = enabled
        self.capacity = capacity
        self.rank = int(os.environ.get(HOROVOD_RANK, "0") or 0)
        self._spans: deque = deque(maxlen=capacity)

    def configure(self, rank: Optional[int] = None) -> None:
        """Re-read the knobs (``hvd.init()``, an elastic re-init included,
        where the rank may have changed)."""
        enabled, capacity = parse_trace(os.environ.get(HOROVOD_TRACE))
        self.enabled = enabled
        if capacity != self.capacity:
            self._spans = deque(self._spans, maxlen=capacity)
            self.capacity = capacity
        if rank is not None:
            self.rank = rank

    def record(self, name: str, t0: float, dur: float,
               trace_id: str = "", **attrs) -> None:
        """Record one finished span: ``t0`` in epoch seconds (the trace
        clock, corrected by the rendezvous ``/_time`` offset at merge),
        ``dur`` in seconds."""
        if not self.enabled:
            return
        span = {"trace_id": trace_id, "name": name, "t": t0,
                "dur": dur, "rank": self.rank}
        span.update(attrs)
        self._spans.append(span)
        _SPANS_TOTAL.inc()

    def spans(self) -> List[dict]:
        return list(self._spans)

    def spans_recorded(self) -> int:
        return int(_SPANS_TOTAL.value)


class SLOTracker:
    """Rolling good/bad windows per objective and burn-rate alerting.

    One window per objective, ``HOROVOD_SLO_WINDOW`` requests deep. The
    compliance target of every objective is ``HOROVOD_SLO_AVAILABILITY``,
    so the allowed bad fraction (the error budget) is ``1 - target``. The
    burn rate is the observed bad fraction over the allowed one: 1.0
    spends the budget exactly at the sustainable rate. Crossing
    ``HOROVOD_SLO_BURN_ALERT`` upward emits one ``slo_burn_rate`` flight
    event, re-armed once the rate falls back under it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.configure()

    def configure(self) -> None:
        window = max(1, _get_int(HOROVOD_SLO_WINDOW, DEFAULT_SLO_WINDOW))
        with self._lock:
            self.ttft_ms = _get_float(HOROVOD_SLO_TTFT_MS, 1000.0)
            self.latency_ms = _get_float(HOROVOD_SLO_LATENCY_MS, 10000.0)
            self.target = min(1.0 - 1e-9, max(
                0.0, _get_float(HOROVOD_SLO_AVAILABILITY, 0.999)))
            self.burn_alert = _get_float(HOROVOD_SLO_BURN_ALERT, 14.0)
            self.window = window
            self._windows: Dict[str, deque] = {
                obj: deque(maxlen=window) for obj in OBJECTIVES}
            self._alerting: Dict[str, bool] = {
                obj: False for obj in OBJECTIVES}
            self._latencies: deque = deque(maxlen=window)   # ms
            self._ttfts: deque = deque(maxlen=window)       # ms
            self._exemplars: List[dict] = []
            self._requests = 0
            self._bad = {obj: 0 for obj in OBJECTIVES}  # cumulative

    def record_request(self, ttft_s: float, latency_s: float,
                       ok: bool = True, trace_id: str = "", rank: int = 0,
                       requeues: int = 0,
                       phases: Optional[Dict[str, float]] = None) -> None:
        """Score one finished request against every objective.
        ``ok=False`` (rejected, never served) is an availability bad event
        and skips the latency objectives; ``phases`` (name -> seconds)
        names the slowest phase of a slow-request exemplar."""
        verdicts = {"availability": ok}
        if ok:
            verdicts["ttft"] = ttft_s * 1000.0 <= self.ttft_ms
            verdicts["latency"] = latency_s * 1000.0 <= self.latency_ms
        alerts = []
        with self._lock:
            self._requests += 1
            for obj, good in verdicts.items():
                self._windows[obj].append(good)
                if not good:
                    self._bad[obj] += 1
                burn = self._burn_rate_locked(obj)
                if burn >= self.burn_alert and not self._alerting[obj]:
                    self._alerting[obj] = True
                    alerts.append((obj, burn))
                elif burn < self.burn_alert:
                    self._alerting[obj] = False
            if ok:
                self._latencies.append(latency_s * 1000.0)
                self._ttfts.append(ttft_s * 1000.0)
                self._note_exemplar_locked(
                    trace_id, ttft_s, latency_s, rank, requeues, phases)
        for obj, good in verdicts.items():
            _SLO_EVENTS.labels(objective=obj,
                               verdict="good" if good else "bad").inc()
            _SLO_BURN.labels(objective=obj).set(self.burn_rate(obj))
            _SLO_BUDGET.labels(objective=obj).set(
                self.error_budget_remaining(obj))
        for obj, burn in alerts:
            _SLO_ALERTS.labels(objective=obj).inc()
            from horovod_tpu_torch import flight_recorder

            flight_recorder.emit(
                "slo_burn_rate", objective=obj, burn_rate=round(burn, 2),
                threshold=self.burn_alert, window=self.window,
                trace_id=trace_id)

    def _note_exemplar_locked(self, trace_id: str, ttft_s: float,
                              latency_s: float, rank: int, requeues: int,
                              phases: Optional[Dict[str, float]]) -> None:
        slowest_phase = None
        if phases:
            slowest_phase = max(phases, key=lambda k: phases[k])
        self._exemplars.append({
            "trace_id": trace_id,
            "latency_ms": round(latency_s * 1000.0, 3),
            "ttft_ms": round(ttft_s * 1000.0, 3),
            "rank": rank,
            "requeues": requeues,
            "slowest_phase": slowest_phase,
            "phases_ms": {k: round(v * 1000.0, 3)
                          for k, v in (phases or {}).items()},
        })
        self._exemplars.sort(key=lambda e: e["latency_ms"], reverse=True)
        del self._exemplars[_EXEMPLARS_MAX:]

    def _bad_fraction_locked(self, objective: str) -> float:
        window = self._windows[objective]
        if not window:
            return 0.0
        return sum(1 for good in window if not good) / len(window)

    def _burn_rate_locked(self, objective: str) -> float:
        return self._bad_fraction_locked(objective) / (1.0 - self.target)

    def burn_rate(self, objective: str) -> float:
        with self._lock:
            return self._burn_rate_locked(objective)

    def error_budget_remaining(self, objective: str) -> float:
        with self._lock:
            return max(0.0, 1.0 - self._burn_rate_locked(objective))

    @staticmethod
    def _percentile(values: List[float], q: float) -> Optional[float]:
        if not values:
            return None
        values = sorted(values)
        idx = min(len(values) - 1, int(round(q * (len(values) - 1))))
        return values[idx]

    def state(self) -> dict:
        """The ``GET /slo`` document."""
        with self._lock:
            lat = list(self._latencies)
            ttft = list(self._ttfts)
            doc = {
                "schema": SCHEMA,
                "objectives": {
                    "ttft_ms": self.ttft_ms,
                    "latency_ms": self.latency_ms,
                    "availability": self.target,
                },
                "window_requests": self.window,
                "requests_scored": self._requests,
                "burn_alert_threshold": self.burn_alert,
                "slo": {
                    obj: {
                        "window_observed": len(self._windows[obj]),
                        "bad_fraction": round(
                            self._bad_fraction_locked(obj), 6),
                        "burn_rate": round(self._burn_rate_locked(obj), 4),
                        "error_budget_remaining": round(max(
                            0.0, 1.0 - self._burn_rate_locked(obj)), 4),
                        "alerting": self._alerting[obj],
                        "bad_total": self._bad[obj],
                    } for obj in OBJECTIVES},
                "latency_ms_percentiles": {
                    "p50": self._percentile(lat, 0.50),
                    "p99": self._percentile(lat, 0.99)},
                "ttft_ms_percentiles": {
                    "p50": self._percentile(ttft, 0.50),
                    "p99": self._percentile(ttft, 0.99)},
                "slow_request_exemplars": list(self._exemplars),
            }
        doc["spans_recorded"] = _tracer.spans_recorded()
        doc["rank"] = _tracer.rank
        return doc


_tracer = Tracer()
_slo = SLOTracker()

# /healthz readiness: hvd.init() marks initialized; the serve plane marks
# started (a handle or replica worker exists) and heartbeat-seen (the
# first replica heartbeat), so a load balancer routes to a serving worker
# only once its replicas came up
_init_ready = False
_serve_started = False
_serve_heartbeat_seen = False


def tracer() -> Tracer:
    return _tracer


def slo() -> SLOTracker:
    return _slo


def enabled() -> bool:
    return _tracer.enabled


def record(name: str, t0: float, dur: float, trace_id: str = "",
           **attrs) -> None:
    """Record one finished span (see :meth:`Tracer.record`)."""
    _tracer.record(name, t0, dur, trace_id=trace_id, **attrs)


def spans() -> List[dict]:
    return _tracer.spans()


def configure(rank: Optional[int] = None) -> None:
    """Adopt the rank, re-read the knobs, register the flight recorder's
    ``slo`` state provider and mark the process initialized (called from
    ``hvd.init()``)."""
    global _init_ready
    _tracer.configure(rank=rank)
    _slo.configure()
    _init_ready = True
    from horovod_tpu_torch import flight_recorder

    flight_recorder.set_state_provider("slo", slo_state)


def mark_initialized(ready: bool = True) -> None:
    global _init_ready
    _init_ready = ready


def note_serve_started() -> None:
    global _serve_started
    _serve_started = True


def note_replica_heartbeat() -> None:
    global _serve_heartbeat_seen
    _serve_heartbeat_seen = True


def slo_state() -> dict:
    """The ``GET /slo`` document (also the flight recorder's ``slo``
    state provider, so every dump carries the SLO posture)."""
    return _slo.state()


def healthz_state() -> dict:
    """The ``GET /healthz`` document: ``ready`` (200, else 503) once
    ``hvd.init()`` ran and, when this process serves, once the first
    replica heartbeat came."""
    ready = _init_ready and (not _serve_started or _serve_heartbeat_seen)
    return {"ready": ready,
            "initialized": _init_ready,
            "serving": _serve_started,
            "first_replica_heartbeat": _serve_heartbeat_seen}


# ---------------------------------------------------------------------------
# Chrome-trace conversion (profiler.merge_profile_dir)
# ---------------------------------------------------------------------------

def spans_to_chrome(span_list: List[dict], tid: int = 2) -> List[dict]:
    """Request spans as Chrome duration ("X") events on their own lane
    (tid 2, clear of the step markers' tid 0 and the flight instants' tid
    1), epoch-us clock; ``merge_profile_dir`` shifts them onto the merged
    clock rank by rank."""
    out = []
    for span in span_list:
        t = span.get("t")
        dur = span.get("dur")
        if not isinstance(t, (int, float)) or \
                not isinstance(dur, (int, float)):
            continue
        args = {k: v for k, v in span.items()
                if k not in ("t", "dur", "name")}
        out.append({"ph": "X", "pid": 0, "tid": tid, "ts": t * 1e6,
                    "dur": max(dur, 0.0) * 1e6,
                    "name": str(span.get("name", "span")),
                    "cat": "request", "args": args})
    return out


def flow_events(anchors: List[dict]) -> List[dict]:
    """Perfetto flow arrows joining one ``trace_id``'s spans across lanes.
    ``anchors`` carry ``trace_id``, ``pid``, ``tid``, ``ts`` (merged-clock
    us) and ``dur``. Per trace the earliest span starts the flow ("s", at
    its end: the hand-off), the latest finishes it ("f", bound to the
    enclosing slice), the rest are steps ("t")."""
    by_trace: Dict[str, List[dict]] = {}
    for a in anchors:
        tid = a.get("trace_id")
        if tid:
            by_trace.setdefault(tid, []).append(a)
    out = []
    for trace_id, group in by_trace.items():
        if len(group) < 2:
            continue  # a single-span trace has nothing to join
        group.sort(key=lambda a: a["ts"])
        last = len(group) - 1
        for i, a in enumerate(group):
            ph = "s" if i == 0 else ("f" if i == last else "t")
            ev = {"ph": ph, "id": trace_id, "cat": "request",
                  "name": "request", "pid": a["pid"], "tid": a["tid"],
                  "ts": a["ts"] + (a.get("dur", 0.0) if i == 0 else 0.0)}
            if ph == "f":
                ev["bp"] = "e"
            out.append(ev)
    return out


def format_slo_report(dumps: List[dict]) -> str:
    """The postmortem's cross-rank SLO section: each rank's burn rates and
    budgets from its dump's ``slo`` state and its slowest requests; ""
    when no dump carries one."""
    rows = []
    for d in sorted(dumps, key=lambda d: d.get("launch_rank", 0)):
        state = (d.get("state") or {}).get("slo")
        if not isinstance(state, dict) or not state.get("slo"):
            continue
        rank = d.get("launch_rank", d.get("rank", "?"))
        parts = []
        for obj in OBJECTIVES:
            rec = state["slo"].get(obj) or {}
            parts.append("%s burn=%.2f budget=%.0f%%%s" % (
                obj, rec.get("burn_rate", 0.0),
                100.0 * rec.get("error_budget_remaining", 1.0),
                " ALERT" if rec.get("alerting") else ""))
        rows.append("rank %s: %d scored  %s" % (
            rank, state.get("requests_scored", 0), "  ".join(parts)))
        for ex in (state.get("slow_request_exemplars") or ())[:3]:
            rows.append(
                "  slow request %s: %.1f ms (ttft %.1f ms, slowest "
                "phase %s, %d requeue%s)" % (
                    ex.get("trace_id", "?"), ex.get("latency_ms", 0.0),
                    ex.get("ttft_ms", 0.0),
                    ex.get("slowest_phase") or "?",
                    ex.get("requeues", 0),
                    "" if ex.get("requeues", 0) == 1 else "s"))
    if not rows:
        return ""
    return "\n".join(["=== SLO report ==="] + rows)
