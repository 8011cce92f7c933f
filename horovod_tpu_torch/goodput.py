"""Goodput ledger: the productive share of wall-clock since ``hvd.init()``,
what took the rest, and a record of each disruption (port of
``horovod_tpu/goodput.py``: the same knobs, categories, metric families,
ledger keys, incident records and report).

One process-wide :class:`GoodputTracker` splits each rank's wall-clock
into ``productive`` time (optimizer steps, from the profiler's records and
from ``elastic.State.commit``) and the badput categories of
:data:`BADPUT_CATEGORIES`, fed by hooks in the port:

* ``startup_compile``: the gap between ``hvd.init()`` and the first
  attributed work;
* ``ckpt_stall``: the training thread's seconds inside
  ``CheckpointManager.commit`` (``ckpt/writer.py``);
* ``rollback``: the restore and the replayed steps of an integrity
  rollback (``integrity/rollback.py``);
* ``elastic_reform``: the re-form of ``@elastic.run``
  (``elastic/runner.py``);
* ``collective_stall``: the retry policy's backoff sleeps
  (``utils/resilience.py``);
* ``straggler_wait`` and ``exposed_comm``: the coordinator's arrival skew
  (``stall.py``), the profiler's exposed communication and ZeRO stage 3's
  gather stalls (``parallel/zero.py``);
* ``input_idle``: the rest, so that the categories sum to the wall-clock
  exactly (an over-attribution is scaled down).

``serve_queue_idle`` and ``serve_preempted`` keep their names, and
:func:`record_serve_step` and :func:`note_serve_preempted` exist, for the
serving plane the port does not have yet.

Each disruption is an incident record (cause, generation, seconds, steps
replayed, culprit rank when one is named, linked flight-event kinds) in a
bounded ledger (``HOROVOD_GOODPUT_INCIDENTS``). One that replays N steps
arms a countdown: the next N steps are badput charged to its cause. The
ledger's epoch is pinned at the first ``configure`` (the first
``hvd.init()``) and kept across ``reinit()``, so a re-form's downtime
lands in the ledger it disrupted.

Surfaces: the ``horovod_goodput_*`` families and ``GET /goodput``; the
``goodput`` state provider of every flight-recorder dump; the profiler's
goodput counter track and incident lane; and :func:`format_goodput_report`,
the postmortem's section naming the ranks' goodput, the dominant badput
and the costliest incident.

Knobs: ``HOROVOD_GOODPUT`` (accounting on/off, default on),
``HOROVOD_GOODPUT_INCIDENTS`` (incident ledger capacity, default 64),
``HOROVOD_GOODPUT_REPORT_SECONDS`` (a periodic log line, default 0: none).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils import logging as log

HOROVOD_GOODPUT = env.HOROVOD_GOODPUT
HOROVOD_GOODPUT_INCIDENTS = env.HOROVOD_GOODPUT_INCIDENTS
HOROVOD_GOODPUT_REPORT_SECONDS = env.HOROVOD_GOODPUT_REPORT_SECONDS

DEFAULT_INCIDENT_CAPACITY = 64
DEFAULT_REPORT_SECONDS = 0.0
_SAMPLE_RING = 512  # bounded fraction trail for the trace counter track

PRODUCTIVE = "productive"
BADPUT_CATEGORIES = (
    "startup_compile",
    "ckpt_stall",
    "rollback",
    "elastic_reform",
    "collective_stall",
    "straggler_wait",
    "exposed_comm",
    "input_idle",
    "serve_queue_idle",
    "serve_preempted",
)
CATEGORIES = (PRODUCTIVE,) + BADPUT_CATEGORIES

_FRACTION = _metrics().gauge(
    "horovod_goodput_fraction",
    "Productive fraction of wall-clock since hvd.init() on this rank "
    "(committed step + served decode time / total).")
_SECONDS = _metrics().counter(
    "horovod_goodput_seconds_total",
    "Wall-clock seconds attributed per goodput category on this rank.",
    labelnames=("category",))
_STEPS = _metrics().counter(
    "horovod_goodput_steps_total",
    "Optimizer steps accounted by kind: productive (committed once) or "
    "replayed (re-run after a rollback/re-form, charged as badput).",
    labelnames=("kind",))
_INCIDENTS = _metrics().counter(
    "horovod_goodput_incidents_total",
    "Disruption incidents recorded in the goodput ledger, per cause.",
    labelnames=("cause",))


class GoodputTracker:
    """Process-wide productive-time ledger.

    Hot-path cost per record is one short lock: a few float adds and a
    deque append; metric updates and flight events happen AFTER the
    tracker lock is released (lock hygiene: emit paths take the
    recorder's own lock). The epoch is pinned at the FIRST
    ``configure()`` (the first ``hvd.init()``) and survives elastic
    ``reinit()`` — re-form downtime must land in the same ledger it
    disrupted."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._epoch: Optional[float] = None       # guarded-by: _lock
        self._epoch_wall: Optional[float] = None  # guarded-by: _lock
        self._cat: Dict[str, float] = {}          # guarded-by: _lock
        # monotonic start of the first attributed work (startup boundary)
        self._first_mark: Optional[float] = None  # guarded-by: _lock
        # monotonic frontier of step attribution (double-count guard
        # between the profiler and State.commit step sources)
        self._step_mark: Optional[float] = None   # guarded-by: _lock
        # non-step seconds attributed since _step_mark: a commit-style
        # step claims its inter-commit gap MINUS these, so a re-form or
        # ckpt stall inside the gap is not double-counted as productive
        self._other_since_step = 0.0              # guarded-by: _lock
        self._steps_productive = 0                # guarded-by: _lock
        self._steps_replayed = 0                  # guarded-by: _lock
        self._serve_blocks = 0                    # guarded-by: _lock
        self._serve_token_cost: Optional[float] = None  # guarded-by: _lock
        self._replay_remaining = 0                # guarded-by: _lock
        self._replay_incident: Optional[dict] = None  # guarded-by: _lock
        self._incidents: deque = deque(
            maxlen=DEFAULT_INCIDENT_CAPACITY)     # guarded-by: _lock
        self._incident_counts: Dict[str, int] = {}  # guarded-by: _lock
        self._samples: deque = deque(maxlen=_SAMPLE_RING)  # guarded-by: _lock
        self._last_report = 0.0                   # guarded-by: _lock
        self.enabled = True
        self.rank = env._get_int(env.HOROVOD_RANK, 0)
        self.world = env._get_int(env.HOROVOD_SIZE, 1) or 1
        self.report_seconds = DEFAULT_REPORT_SECONDS

    # -- epoch -------------------------------------------------------------
    def start_epoch(self) -> None:
        """Pin the ledger epoch to now — idempotent, so elastic
        ``reinit()`` keeps the original clock."""
        with self._lock:
            if self._epoch is None:
                self._epoch = time.monotonic()
                self._epoch_wall = time.time()

    def _fraction_locked(self, now: float) -> Optional[float]:
        if self._epoch is None:
            return None
        wall = now - self._epoch
        if wall <= 0:
            return None
        return min(1.0, self._cat.get(PRODUCTIVE, 0.0) / wall)

    def _first_mark_start(self, now: float, seconds: float) -> float:
        """Monotonic start of the first attributed work — callers assign
        the result to ``_first_mark`` while holding ``_lock``."""
        if self._first_mark is not None:
            return self._first_mark
        start = now - max(seconds, 0.0)
        if self._epoch is not None:
            start = max(start, self._epoch)
        return start

    # -- recording ---------------------------------------------------------
    def record_span(self, category: str, seconds: float) -> None:
        """Attribute ``seconds`` of wall-clock to one category. Unknown
        categories are dropped (a stale hook must not corrupt the sum)."""
        if not self.enabled:
            return
        seconds = float(seconds)
        if seconds <= 0 or category not in CATEGORIES:
            return
        now = time.monotonic()
        with self._lock:
            self._first_mark = self._first_mark_start(now, seconds)
            self._cat[category] = self._cat.get(category, 0.0) + seconds
            if category != PRODUCTIVE:
                self._other_since_step += seconds
        _SECONDS.labels(category=category).inc(seconds)

    def record_step(self, seconds: Optional[float] = None,
                    exposed_comm: float = 0.0,
                    step: Optional[int] = None) -> None:
        """Account one optimizer step.

        ``seconds`` is the measured step wall (profiler source); pass
        ``None`` for the commit source (``elastic.State.commit``), which
        claims the whole gap since the last accounted step minus any
        badput spans recorded inside it. Either way the claim is clamped
        to the unattributed gap, so BOTH sources can feed the same
        process without exceeding elapsed time. While a replay countdown
        is armed (see :meth:`note_incident`), the step is charged to the
        arming incident's cause instead of productive time."""
        if not self.enabled:
            return
        now = time.monotonic()
        sample = None
        report = None
        with self._lock:
            ref = self._step_mark
            if ref is None:
                ref = self._epoch if seconds is None else now
            gap = max(0.0, now - ref - self._other_since_step) \
                if ref is not None else 0.0
            if seconds is None:
                claimed = gap
            else:
                claimed = max(0.0, float(seconds))
                if self._step_mark is not None:
                    claimed = min(claimed, gap)
            self._step_mark = now
            self._other_since_step = 0.0
            if claimed <= 0:
                return
            self._first_mark = self._first_mark_start(now, claimed)
            exposed = min(max(float(exposed_comm), 0.0), claimed)
            if self._replay_remaining > 0:
                cause = "rollback"
                if self._replay_incident is not None:
                    cause = self._replay_incident.get("cause", cause)
                    self._replay_incident["steps_replayed"] = \
                        self._replay_incident.get("steps_replayed", 0) + 1
                    self._replay_incident["replayed_seconds"] = round(
                        self._replay_incident.get("replayed_seconds", 0.0)
                        + claimed, 6)
                if cause not in CATEGORIES:
                    cause = "rollback"
                self._replay_remaining -= 1
                if self._replay_remaining <= 0:
                    self._replay_incident = None
                self._steps_replayed += 1
                self._cat[cause] = self._cat.get(cause, 0.0) + claimed
                kind, cat, amount = "replayed", cause, claimed
            else:
                self._steps_productive += 1
                self._cat[PRODUCTIVE] = \
                    self._cat.get(PRODUCTIVE, 0.0) + (claimed - exposed)
                if exposed > 0:
                    self._cat["exposed_comm"] = \
                        self._cat.get("exposed_comm", 0.0) + exposed
                kind, cat, amount = PRODUCTIVE, PRODUCTIVE, claimed - exposed
            frac = self._fraction_locked(now)
            if frac is not None:
                self._samples.append((time.time(), round(frac, 6)))
                sample = frac
            report = self._maybe_report_locked(now)
            if report:
                self._last_report = now
        _STEPS.labels(kind=kind).inc()
        _SECONDS.labels(category=cat).inc(amount)
        if kind == PRODUCTIVE and exposed > 0:
            _SECONDS.labels(category="exposed_comm").inc(exposed)
        if sample is not None:
            _FRACTION.set(round(sample, 6))
        if report:
            log.info("%s", report)

    def record_serve_step(self, seconds: float, tokens: int = 0) -> None:
        """Account one serve-plane decode block as productive time and
        refresh the EWMA per-token decode cost (the exchange rate
        :meth:`note_serve_preempted` uses to price discarded work)."""
        if not self.enabled:
            return
        seconds = float(seconds)
        if seconds <= 0:
            return
        now = time.monotonic()
        sample = None
        with self._lock:
            self._first_mark = self._first_mark_start(now, seconds)
            self._cat[PRODUCTIVE] = \
                self._cat.get(PRODUCTIVE, 0.0) + seconds
            self._serve_blocks += 1
            if tokens and tokens > 0:
                cost = seconds / float(tokens)
                prev = self._serve_token_cost
                self._serve_token_cost = cost if prev is None \
                    else 0.75 * prev + 0.25 * cost
            frac = self._fraction_locked(now)
            if frac is not None:
                self._samples.append((time.time(), round(frac, 6)))
                sample = frac
        _STEPS.labels(kind=PRODUCTIVE).inc()
        _SECONDS.labels(category=PRODUCTIVE).inc(seconds)
        if sample is not None:
            _FRACTION.set(round(sample, 6))

    def note_serve_preempted(self, tokens: int) -> None:
        """Re-attribute a preempted slot's already-decoded tokens from
        productive to ``serve_preempted`` — net zero on the wall-clock
        sum: the seconds were spent, they just bought nothing."""
        if not self.enabled or tokens <= 0:
            return
        with self._lock:
            cost = self._serve_token_cost
            if not cost:
                return
            wasted = min(self._cat.get(PRODUCTIVE, 0.0),
                         float(tokens) * cost)
            if wasted <= 0:
                return
            self._cat[PRODUCTIVE] -= wasted
            self._cat["serve_preempted"] = \
                self._cat.get("serve_preempted", 0.0) + wasted
        _SECONDS.labels(category="serve_preempted").inc(wasted)

    def note_incident(self, cause: str, seconds: float,
                      generation: Optional[int] = None,
                      culprit_rank: Optional[int] = None,
                      replay_steps: int = 0,
                      linked_events: Optional[List[str]] = None,
                      detail: Optional[str] = None) -> None:
        """Record one disruption: its downtime lands in the ``cause``
        category, a record enters the bounded incident ledger, and — when
        the disruption forces ``replay_steps`` steps to be re-run — the
        countdown arms so those steps are charged to this incident."""
        if not self.enabled:
            return
        seconds = max(float(seconds), 0.0)
        cause = cause if cause in BADPUT_CATEGORIES else "rollback"
        now = time.monotonic()
        record = {
            "cause": cause,
            "wall_time": time.time(),
            "duration_s": round(seconds, 6),
            "generation": generation,
            "culprit_rank": culprit_rank,
            "steps_replayed": 0,
            "replayed_seconds": 0.0,
            "linked_events": list(linked_events or ()),
            "detail": detail,
        }
        with self._lock:
            self._first_mark = self._first_mark_start(now, seconds)
            if seconds > 0:
                self._cat[cause] = self._cat.get(cause, 0.0) + seconds
                self._other_since_step += seconds
            self._incidents.append(record)
            self._incident_counts[cause] = \
                self._incident_counts.get(cause, 0) + 1
            if replay_steps > 0:
                self._replay_remaining = int(replay_steps)
                self._replay_incident = record
        _INCIDENTS.labels(cause=cause).inc()
        if seconds > 0:
            _SECONDS.labels(category=cause).inc(seconds)
        from horovod_tpu_torch import flight_recorder

        flight_recorder.emit(
            "goodput_incident", cause=cause, seconds=round(seconds, 4),
            generation=generation, culprit_rank=culprit_rank,
            replay_steps=int(replay_steps))

    def _maybe_report_locked(self, now: float) -> Optional[str]:
        if self.report_seconds <= 0 or self._epoch is None:
            return None
        if now - self._last_report < self.report_seconds:
            return None
        frac = self._fraction_locked(now)
        if frac is None:
            return None
        badput = {c: s for c, s in self._cat.items()
                  if c != PRODUCTIVE and s > 0}
        top = max(badput, key=badput.get) if badput else "none"
        return ("goodput: %.1f%% productive over %.0fs; top badput %s; "
                "%d incident(s)" % (
                    100.0 * frac, now - self._epoch, top,
                    sum(self._incident_counts.values())))

    # -- snapshots ---------------------------------------------------------
    def ledger(self) -> dict:
        """Full accounting snapshot — the payload of the flight-recorder
        ``goodput`` state provider, so every dump carries it. Categories
        sum to wall-clock EXACTLY: derived startup + explicit spans are
        proportionally scaled down if they over-claim (clock skew between
        hook sites), and the remainder lands in ``input_idle``."""
        now = time.monotonic()
        with self._lock:
            wall = max(0.0, now - self._epoch) \
                if self._epoch is not None else 0.0
            cats = {c: s for c, s in self._cat.items() if s > 0}
            startup = 0.0
            if self._epoch is not None:
                if self._first_mark is not None:
                    startup = max(0.0, self._first_mark - self._epoch)
                elif not cats:
                    startup = wall  # nothing attributed yet: all warmup
            if startup > 0:
                cats["startup_compile"] = \
                    cats.get("startup_compile", 0.0) + startup
            attributed = sum(cats.values())
            if attributed > wall > 0:
                scale = wall / attributed
                cats = {c: s * scale for c, s in cats.items()}
                attributed = wall
            idle = max(0.0, wall - attributed)
            if idle > 0:
                cats["input_idle"] = cats.get("input_idle", 0.0) + idle
            productive = cats.get(PRODUCTIVE, 0.0)
            goodput = (productive / wall) if wall > 0 else 0.0
            accounted = ((wall - idle) / wall) if wall > 0 else 0.0
            badput = {c: round(s, 6) for c, s in cats.items()
                      if c != PRODUCTIVE}
            return {
                "rank": self.rank,
                "world": self.world,
                "wall_time": time.time(),
                "epoch_wall_time": self._epoch_wall,
                "enabled": self.enabled,
                "wall_seconds": round(wall, 6),
                "goodput_fraction": round(goodput, 6),
                "accounted_fraction": round(accounted, 6),
                "productive_seconds": round(productive, 6),
                "badput_seconds": badput,
                "steps_productive": self._steps_productive,
                "steps_replayed": self._steps_replayed,
                "serve_blocks": self._serve_blocks,
                "incident_counts": dict(self._incident_counts),
                "incidents": [dict(i) for i in self._incidents],
            }

    def samples(self) -> List[list]:
        """The [wall_time, goodput_fraction] trail — the merged-trace
        "goodput fraction" counter track reads this."""
        with self._lock:
            return [list(s) for s in self._samples]

    def incidents(self) -> List[dict]:
        with self._lock:
            return [dict(i) for i in self._incidents]

    def set_incident_capacity(self, capacity: int) -> None:
        capacity = max(1, int(capacity))
        with self._lock:
            if self._incidents.maxlen != capacity:
                self._incidents = deque(self._incidents, maxlen=capacity)

    def reset(self) -> None:
        """Drop all accumulated state (tests and bench A/B harnesses)."""
        with self._lock:
            self._epoch = None
            self._epoch_wall = None
            self._cat.clear()
            self._first_mark = None
            self._step_mark = None
            self._other_since_step = 0.0
            self._steps_productive = 0
            self._steps_replayed = 0
            self._serve_blocks = 0
            self._serve_token_cost = None
            self._replay_remaining = 0
            self._replay_incident = None
            self._incidents.clear()
            self._incident_counts.clear()
            self._samples.clear()
            self._last_report = 0.0


_tracker = GoodputTracker()


def tracker() -> GoodputTracker:
    return _tracker


def record_span(category: str, seconds: float) -> None:
    """Module-level shorthand for instrumentation points; no-op when the
    tracker is disabled."""
    _tracker.record_span(category, seconds)


def record_step(seconds: Optional[float] = None, exposed_comm: float = 0.0,
                step: Optional[int] = None) -> None:
    _tracker.record_step(seconds, exposed_comm=exposed_comm, step=step)


def record_serve_step(seconds: float, tokens: int = 0) -> None:
    _tracker.record_serve_step(seconds, tokens=tokens)


def note_serve_preempted(tokens: int) -> None:
    _tracker.note_serve_preempted(tokens)


def note_incident(cause: str, seconds: float, **fields) -> None:
    _tracker.note_incident(cause, seconds, **fields)


def configure(rank: Optional[int] = None,
              world: Optional[int] = None) -> None:
    """Adopt the rank/world, parse the ``HOROVOD_GOODPUT_*`` knobs, pin
    the ledger epoch (first call only — elastic re-inits keep the
    original clock), and register the flight-recorder ``goodput`` state
    provider. Called from ``hvd.init()``."""
    t = _tracker
    if rank is not None:
        t.rank = int(rank)
    if world is not None:
        t.world = int(world)
    t.enabled = env._get_bool(HOROVOD_GOODPUT, True)
    t.report_seconds = max(0.0, env._get_float(
        HOROVOD_GOODPUT_REPORT_SECONDS, DEFAULT_REPORT_SECONDS))
    t.set_incident_capacity(env._get_int(
        HOROVOD_GOODPUT_INCIDENTS, DEFAULT_INCIDENT_CAPACITY))
    if t.enabled:
        t.start_epoch()
    from horovod_tpu_torch import flight_recorder

    if t.enabled:
        flight_recorder.set_state_provider("goodput", t.ledger)
    else:
        flight_recorder.set_state_provider("goodput", None)


def goodput_state() -> dict:
    """Document for the metrics server's ``GET /goodput`` route: the
    ledger + the recent goodput-fraction sample trail."""
    state = _tracker.ledger()
    state["samples"] = _tracker.samples()[-64:]
    return state


# -- cross-rank postmortem ----------------------------------------------------

def format_goodput_report(dumps: List[dict]) -> str:
    """Cross-rank goodput report from flight-recorder dumps' ``goodput``
    state: per-rank goodput and top badput, the fleet time-weighted
    goodput %, the dominant badput category, and the costliest incident
    (with its culprit rank when attribution named one). Empty string
    when no dump carries a goodput ledger (pre-goodput-plane dumps)."""
    ranks = []
    for d in dumps:
        gp = (d.get("state") or {}).get("goodput")
        if not isinstance(gp, dict) or not gp.get("wall_seconds"):
            continue
        ranks.append((d.get("launch_rank", d.get("rank", "?")), gp))
    if not ranks:
        return ""
    lines = ["=== goodput report (%d rank%s) ==="
             % (len(ranks), "" if len(ranks) == 1 else "s")]
    fleet_wall = fleet_productive = 0.0
    fleet_badput: Dict[str, float] = {}
    costliest = None  # (seconds, rank, incident)
    for rank, gp in sorted(ranks, key=lambda r: str(r[0])):
        wall = float(gp.get("wall_seconds", 0.0))
        productive = float(gp.get("productive_seconds", 0.0))
        fleet_wall += wall
        fleet_productive += productive
        badput = gp.get("badput_seconds") or {}
        top = max(badput, key=badput.get) if badput else None
        for cat, secs in badput.items():
            fleet_badput[cat] = fleet_badput.get(cat, 0.0) + float(secs)
        replayed = int(gp.get("steps_replayed", 0))
        lines.append(
            "rank %s: goodput %.1f%% of %.1fs (accounted %.1f%%)%s%s" % (
                rank, 100.0 * float(gp.get("goodput_fraction", 0.0)),
                wall, 100.0 * float(gp.get("accounted_fraction", 0.0)),
                ("; top badput %s %.1fs" % (top, badput[top]))
                if top else "",
                ("; %d step(s) replayed" % replayed) if replayed else ""))
        for inc in gp.get("incidents") or ():
            if not isinstance(inc, dict):
                continue
            cost = float(inc.get("duration_s", 0.0)) \
                + float(inc.get("replayed_seconds", 0.0))
            if costliest is None or cost > costliest[0]:
                costliest = (cost, rank, inc)
    if fleet_wall > 0:
        lines.append("fleet goodput: %.1f%% (time-weighted across %d "
                     "rank%s)" % (100.0 * fleet_productive / fleet_wall,
                                  len(ranks),
                                  "" if len(ranks) == 1 else "s"))
    if fleet_badput:
        dominant = max(fleet_badput, key=fleet_badput.get)
        lines.append("dominant badput: %s (%.1fs, %.1f%% of fleet wall)"
                     % (dominant, fleet_badput[dominant],
                        100.0 * fleet_badput[dominant] / fleet_wall
                        if fleet_wall > 0 else 0.0))
    if costliest is not None:
        cost, rank, inc = costliest
        extras = []
        if inc.get("generation") is not None:
            extras.append("gen %s" % inc["generation"])
        if inc.get("steps_replayed"):
            extras.append("%d step(s) replayed" % inc["steps_replayed"])
        if inc.get("culprit_rank") is not None:
            extras.append("culprit rank %s" % inc["culprit_rank"])
        lines.append("costliest incident: %s on rank %s — %.1fs%s" % (
            inc.get("cause", "?"), rank, cost,
            (" (%s)" % ", ".join(extras)) if extras else ""))
    return "\n".join(lines)
