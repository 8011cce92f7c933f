"""Collective transport observatory: algbw and busbw of each collective,
utilization against a roofline, and degradation alerts (port of
``horovod_tpu/comms.py``: the same knobs, lanes, metric families, ledger
keys, EWMA, detector and report).

One process-wide :class:`CommsTracker` takes ``(op, lane, nbytes,
seconds)`` records from each lane that moves bytes. The port records:

* ``device``: the executor's data plane (``runtime/executor.py``), every
  collective of the API, recorded once there (the JAX package also
  records eager collectives in ``ops/collectives.py``; the port's all go
  through the executor);
* ``zero``: ZeRO's reduce-scatter and allgather phases
  (``parallel/zero.py``), the end-to-end view of the phase beside the
  ``device`` records of the collectives it rode;
* ``kv``: the rendezvous KV store's round trips (``run/rendezvous.py``).

* ``hier_intra`` and ``hier_cross``: the two-level collectives' hops
  (``runtime/hierarchy.py``), each hop's call on its own group.

``host_ring``, ``spmd`` and ``bucket_wire`` keep their names in
:data:`LANES`; the port has no path for them. ``configure`` seeds the
``device``, ``hier_intra`` and ``hier_cross`` rooflines from the probe
cache (``HOROVOD_PROBE_CACHE``, ``autotune/probe.py``) probed at this
world size.

**The seconds on the card are the device's.** NCCL runs asynchronously on
the runtime's comm stream, so a host interval from dispatch to drain is
the time of queueing the work, not of the collective. On the card the
executor records an ``enable_timing`` CUDA event pair on its comm stream
around each dispatched collective, and ZeRO one on the caller's stream
around each phase (:func:`stamp`, from a pool of events whose readings
were taken); a collective's :func:`span` runs from its start, or from the
previous collective's end on the same stream when that came later, to its
end, and is read once the card has passed the end (``Event.query``:
nothing synchronizes for it): by the executor when a bin's ``done`` event
has passed, by :meth:`CommsTracker.sweep` for ZeRO's spans
(:meth:`CommsTracker.record_span`). On the CPU (gloo) and for
``kv`` the seconds are the host's wall time, as in the JAX package.

Two bandwidths a record (the NCCL-tests convention): ``algbw =
payload_bytes / seconds``, and ``busbw = algbw * factor(op, N)``, with
``2(N-1)/N`` for allreduce, ``(N-1)/N`` for reduce-scatter, allgather and
alltoall, 1 for broadcast and point-to-point, and 0 at ``N == 1``.

Records are keyed by ``(op, lane, size_bucket)`` (power-of-two byte
buckets) into bounded windows; each lane's busbw is EWMA-smoothed and held
against a roofline (its peak smoothed busbw, or a seeded one) as
``horovod_comms_utilization_fraction{lane}``. After ``_WARMUP_OPS`` records
a lane's detector emits one ``comms_degraded`` flight event a downward
crossing of ``HOROVOD_COMMS_DEGRADED_FRACTION`` and re-arms when the lane
recovers.

Surfaces: the ``horovod_comms_*`` families and ``GET /comms``; the
``comms`` state provider of every flight-recorder dump; the profiler's
bus-bandwidth counter track; and :func:`format_comms_report`, the
postmortem's section naming the slowest lane and the rank furthest below
its roofline.

Knobs: ``HOROVOD_COMMS`` (accounting on/off, default on; off, the executor
records no events), ``HOROVOD_COMMS_WINDOW`` (records a key, default 128),
``HOROVOD_COMMS_EWMA_ALPHA`` (default 0.25),
``HOROVOD_COMMS_DEGRADED_FRACTION`` (default 0.5).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import env

HOROVOD_COMMS = env.HOROVOD_COMMS
HOROVOD_COMMS_WINDOW = env.HOROVOD_COMMS_WINDOW
HOROVOD_COMMS_EWMA_ALPHA = env.HOROVOD_COMMS_EWMA_ALPHA
HOROVOD_COMMS_DEGRADED_FRACTION = env.HOROVOD_COMMS_DEGRADED_FRACTION

DEFAULT_WINDOW = 128
DEFAULT_EWMA_ALPHA = 0.25
DEFAULT_DEGRADED_FRACTION = 0.5
_SAMPLE_RING = 512   # bounded per-record trail for the trace counter track
_WARMUP_OPS = 8      # lane records before the degradation detector arms
_TOP_KEYS = 32       # (op, lane, bucket) rows surfaced in the ledger

LANES = ("device", "host_ring", "spmd", "zero", "bucket_wire", "kv",
         "hier_intra", "hier_cross")

_ALGBW = _metrics().gauge(
    "horovod_comms_algbw_gbs",
    "Rolling algorithm bandwidth (payload bytes / wall seconds, GB/s) "
    "per collective op and transport lane.",
    labelnames=("op", "lane"))
_BUSBW = _metrics().gauge(
    "horovod_comms_busbw_gbs",
    "Rolling bus bandwidth (algbw x op ring factor, GB/s) per collective "
    "op and transport lane — comparable across ops and world sizes.",
    labelnames=("op", "lane"))
_BYTES = _metrics().counter(
    "horovod_comms_bytes_total",
    "Cumulative payload bytes moved per collective op and lane.",
    labelnames=("op", "lane"))
_OPS = _metrics().counter(
    "horovod_comms_ops_total",
    "Collective operations recorded per op and lane.",
    labelnames=("op", "lane"))
_UTIL = _metrics().gauge(
    "horovod_comms_utilization_fraction",
    "Smoothed per-lane bus bandwidth as a fraction of the lane roofline "
    "(probe-seeded where available, peak-observed otherwise).",
    labelnames=("lane",))
_DEGRADED = _metrics().counter(
    "horovod_comms_degraded_total",
    "Downward HOROVOD_COMMS_DEGRADED_FRACTION crossings per lane (one "
    "per sustained degradation; re-armed on recovery).",
    labelnames=("lane",))


class Stamp(NamedTuple):
    """A timing event recorded on a stream, and its place in the order in
    which this process recorded its stamps (the stream's order, for stamps
    of one stream)."""

    event: Any
    seq: int


class Span(NamedTuple):
    """A collective's timing: from ``begin`` (its start, or the previous
    collective's end of the same stream when that came later) to ``end``;
    ``spent`` are the events no later reading needs once this one's is
    taken (``end`` is the next span's previous end)."""

    begin: Any
    end: Any
    spent: tuple


# timing events whose readings were taken, recorded again by ``stamp`` in
# place of new ones (a new event a dispatch costs the cycle thread more)
_free_events: deque = deque()
_stamp_seq = itertools.count()


def stamp(stream) -> Optional[Stamp]:
    """A timing event recorded on ``stream`` now; None with the plane
    off."""
    if not _tracker.enabled:
        return None
    try:
        event = _free_events.pop()
    except IndexError:
        import torch

        event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return Stamp(event, next(_stamp_seq))


def span(start: Stamp, end: Stamp, after: Optional[Stamp] = None) -> Span:
    """The span of a collective stamped ``start`` before its call and
    ``end`` after its wait, ``after`` the previous collective's ``end`` on
    the same stream: a collective queued behind another is not charged
    the other's time."""
    if after is None:
        return Span(start.event, end.event, (start.event,))
    begin = after if after.seq > start.seq else start
    return Span(begin.event, end.event, (start.event, after.event))


def span_seconds(s: Span) -> float:
    """Seconds of a span whose ``end`` the device has passed; its spent
    events go back to the pool."""
    ms = s.begin.elapsed_time(s.end)
    _free_events.extend(s.spent)
    return max(ms, 0.0) / 1e3


def bus_factor(op: str, world: int) -> float:
    """Bus-traffic factor mapping algorithm bandwidth to bus bandwidth
    (the NCCL-tests convention). ``world <= 1`` degenerates to 0 for
    every op: a one-rank collective moves nothing across any bus."""
    n = int(world)
    if n <= 1:
        return 0.0
    op = op.lower()
    if op == "allreduce":
        return 2.0 * (n - 1) / n
    if op in ("reducescatter", "allgather", "alltoall"):
        return float(n - 1) / n
    # broadcast and point-to-point (kv get/put): every payload byte
    # crosses the bus exactly once
    return 1.0


def size_bucket(nbytes: int) -> int:
    """Power-of-two byte bucket (the ceiling), so steady-state keys are
    bounded: a 3 MiB and a 3.5 MiB allreduce share the 4 MiB bucket."""
    n = max(int(nbytes), 1)
    return 1 << (n - 1).bit_length()


def _fmt_bucket(bucket: int) -> str:
    n = float(bucket)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024.0 or unit == "GiB":
            return ("%d%s" % (n, unit)) if n == int(n) else \
                ("%.1f%s" % (n, unit))
        n /= 1024.0
    return "%dB" % bucket


class CommsTracker:
    """Process-wide per-collective bandwidth ledger.

    Hot-path cost per record is one short lock: a deque append, a few
    dict stores and an EWMA multiply; gauge updates happen outside any
    subsystem lock. Flight events are emitted AFTER the tracker lock is
    released (lock hygiene: emit paths take the recorder's own lock)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (op, lane, bucket) -> deque[(wall_time, nbytes, seconds, busbw)]
        self._windows: Dict[Tuple[str, str, int], deque] = {}  # guarded-by: _lock
        self._key_ewma: Dict[Tuple[str, str, int], float] = {}  # guarded-by: _lock
        # (op, lane) -> [bytes_total, ops_total, seconds_total]
        self._totals: Dict[Tuple[str, str], List[float]] = {}  # guarded-by: _lock
        self._lane_ewma: Dict[str, float] = {}       # guarded-by: _lock
        self._lane_peak: Dict[str, float] = {}       # guarded-by: _lock
        self._lane_ops: Dict[str, int] = {}          # guarded-by: _lock
        self._roofline: Dict[str, float] = {}        # guarded-by: _lock
        self._roofline_source: Dict[str, str] = {}   # guarded-by: _lock
        self._alerting: Dict[str, bool] = {}         # guarded-by: _lock
        self._last_degraded: Dict[str, dict] = {}    # guarded-by: _lock
        self._degraded_count: Dict[str, int] = {}    # guarded-by: _lock
        self._samples: deque = deque(maxlen=_SAMPLE_RING)  # guarded-by: _lock
        self.enabled = True
        self.rank = env._get_int(env.HOROVOD_RANK, 0)
        self.world = env._get_int(env.HOROVOD_SIZE, 1) or 1
        # spans whose collectives the card has not passed yet
        self._spans: deque = deque()  # guarded-by: _spans_lock
        self._spans_lock = threading.Lock()
        # (op, lane) -> the metric children a record sets
        self._children: Dict[Tuple[str, str], tuple] = {}
        self.window = DEFAULT_WINDOW
        self.ewma_alpha = DEFAULT_EWMA_ALPHA
        self.degraded_fraction = DEFAULT_DEGRADED_FRACTION

    # -- roofline ----------------------------------------------------------
    def seed_roofline(self, lane: str, busbw_gbs: float,
                      source: str = "probe") -> None:
        """Pin a lane's roofline (GB/s of bus bandwidth) from an external
        measurement. Unseeded lanes fall back to their peak observed busbw
        (the JAX package also seeds from its probe cache, which waits for
        the port's ``autotune/probe.py``)."""
        busbw_gbs = float(busbw_gbs)
        if busbw_gbs <= 0:
            return
        with self._lock:
            self._roofline[lane] = busbw_gbs
            self._roofline_source[lane] = source

    def _roofline_locked(self, lane: str) -> Tuple[Optional[float], str]:
        seeded = self._roofline.get(lane)
        if seeded:
            return seeded, self._roofline_source.get(lane, "probe")
        peak = self._lane_peak.get(lane)
        if peak:
            return peak, "peak_observed"
        return None, "none"

    # -- recording ---------------------------------------------------------
    def record(self, op: str, lane: str, nbytes: int, seconds: float,
               world: Optional[int] = None) -> None:
        """Ingest one completed collective: compute algbw/busbw, roll the
        (op, lane, bucket) window, update the lane EWMA + utilization,
        and run the degradation detector."""
        if not self.enabled:
            return
        nbytes = int(nbytes)
        seconds = float(seconds)
        if nbytes <= 0 or seconds <= 0:
            return
        op = str(op).lower()
        n = int(world) if world else self.world
        algbw = nbytes / seconds / 1e9
        busbw = algbw * bus_factor(op, n)
        bucket = size_bucket(nbytes)
        now = time.time()
        key = (op, lane, bucket)
        alert = None  # (lane, op, bucket, busbw, roofline, util) after lock
        recovered = False
        with self._lock:
            win = self._windows.get(key)
            if win is None or win.maxlen != self.window:
                win = deque(win or (), maxlen=self.window)
                self._windows[key] = win
            win.append((now, nbytes, seconds, busbw))
            prev = self._key_ewma.get(key)
            a = self.ewma_alpha
            self._key_ewma[key] = busbw if prev is None \
                else (1.0 - a) * prev + a * busbw
            tot = self._totals.setdefault((op, lane), [0, 0, 0.0])
            tot[0] += nbytes
            tot[1] += 1
            tot[2] += seconds
            lane_prev = self._lane_ewma.get(lane)
            lane_ewma = busbw if lane_prev is None \
                else (1.0 - a) * lane_prev + a * busbw
            self._lane_ewma[lane] = lane_ewma
            if lane_ewma > self._lane_peak.get(lane, 0.0):
                self._lane_peak[lane] = lane_ewma
            ops_seen = self._lane_ops.get(lane, 0) + 1
            self._lane_ops[lane] = ops_seen
            roofline, _src = self._roofline_locked(lane)
            util = (lane_ewma / roofline) if roofline else None
            if util is not None and ops_seen >= _WARMUP_OPS:
                if util < self.degraded_fraction \
                        and not self._alerting.get(lane, False):
                    self._alerting[lane] = True
                    self._degraded_count[lane] = \
                        self._degraded_count.get(lane, 0) + 1
                    self._last_degraded[lane] = {
                        "wall_time": now, "op": op,
                        "size_bucket": _fmt_bucket(bucket),
                        "busbw_gbs": round(lane_ewma, 4),
                        "roofline_gbs": round(roofline, 4),
                        "utilization": round(util, 4),
                    }
                    alert = (lane, op, bucket, lane_ewma, roofline, util)
                elif util >= self.degraded_fraction \
                        and self._alerting.get(lane, False):
                    self._alerting[lane] = False  # re-arm
                    recovered = True
            self._samples.append((now, round(busbw, 4), lane))
        # metrics + flight events outside the tracker lock
        children = self._children.get((op, lane))
        if children is None:
            children = self._children.setdefault((op, lane), tuple(
                fam.labels(op=op, lane=lane)
                for fam in (_ALGBW, _BUSBW, _BYTES, _OPS)))
        children[0].set(round(algbw, 4))
        children[1].set(round(busbw, 4))
        children[2].inc(nbytes)
        children[3].inc()
        if util is not None:
            _UTIL.labels(lane=lane).set(round(util, 4))
        if alert is not None:
            lane_a, op_a, bucket_a, bw, roof, u = alert
            _DEGRADED.labels(lane=lane_a).inc()
            from horovod_tpu_torch import flight_recorder

            flight_recorder.emit(
                "comms_degraded", lane=lane_a, op=op_a,
                size_bucket=_fmt_bucket(bucket_a),
                busbw_gbs=round(bw, 4), roofline_gbs=round(roof, 4),
                utilization=round(u, 4),
                threshold=self.degraded_fraction)
        elif recovered:
            from horovod_tpu_torch import flight_recorder

            flight_recorder.emit("comms_recovered", lane=lane)

    # -- snapshots ---------------------------------------------------------
    def ledger(self) -> dict:
        """Per-lane bandwidth state + the busiest (op, lane, bucket) keys
        — the payload of the flight-recorder ``comms`` state provider, so
        every dump carries it. Collectives the card has passed since the
        last sweep are recorded first."""
        self.sweep()
        with self._lock:
            lanes = {}
            for lane in sorted(set(self._lane_ewma) | set(self._roofline)):
                roofline, src = self._roofline_locked(lane)
                ewma = self._lane_ewma.get(lane)
                util = (ewma / roofline) if (ewma and roofline) else None
                bytes_total = sum(
                    t[0] for (o, ln), t in self._totals.items()
                    if ln == lane)
                ops_total = sum(
                    t[1] for (o, ln), t in self._totals.items()
                    if ln == lane)
                lanes[lane] = {
                    "busbw_gbs": round(ewma, 4) if ewma else None,
                    "peak_busbw_gbs": round(
                        self._lane_peak.get(lane, 0.0), 4) or None,
                    "roofline_gbs": round(roofline, 4) if roofline
                    else None,
                    "roofline_source": src,
                    "utilization": round(util, 4) if util is not None
                    else None,
                    "bytes_total": int(bytes_total),
                    "ops_total": int(ops_total),
                    "alerting": self._alerting.get(lane, False),
                    "degraded_count": self._degraded_count.get(lane, 0),
                    "last_degraded": self._last_degraded.get(lane),
                }
            keys = []
            for (op, lane, bucket), win in self._windows.items():
                if not win:
                    continue
                w_bytes = sum(r[1] for r in win)
                w_secs = sum(r[2] for r in win)
                algbw = (w_bytes / w_secs / 1e9) if w_secs > 0 else 0.0
                # per-record busbw already folded in each record's own
                # world size; time-weighting recovers the windowed rate
                busbw = (sum(r[3] * r[2] for r in win) / w_secs) \
                    if w_secs > 0 else 0.0
                keys.append({
                    "op": op, "lane": lane,
                    "size_bucket": _fmt_bucket(bucket),
                    "algbw_gbs": round(algbw, 4),
                    "busbw_gbs": round(busbw, 4),
                    "ewma_busbw_gbs": round(
                        self._key_ewma.get((op, lane, bucket), 0.0), 4),
                    "ops": len(win),
                    "window_bytes": int(w_bytes),
                })
            keys.sort(key=lambda k: -k["window_bytes"])
        return {
            "rank": self.rank,
            "world": self.world,
            "wall_time": time.time(),
            "degraded_fraction": self.degraded_fraction,
            "lanes": lanes,
            "keys": keys[:_TOP_KEYS],
        }

    def samples(self) -> List[list]:
        """The per-record trail: [wall_time, busbw_gbs, lane] rows — the
        merged-trace "bus bandwidth (GB/s)" counter track reads this."""
        with self._lock:
            return [list(s) for s in self._samples]

    # -- device-timed records ---------------------------------------------
    def record_span(self, op: str, lane: str, nbytes: int, s: Span,
                    world: Optional[int] = None) -> None:
        """Record a collective timed on the card by ``s`` (see
        :func:`span`) once the device has passed its end (a later
        :meth:`sweep`); nothing here waits for the device."""
        if not self.enabled:
            return
        with self._spans_lock:
            self._spans.append((op, lane, int(nbytes), s, world))
        self.sweep()

    def sweep(self) -> int:
        """Record every queued event pair whose ``end`` the card has
        passed, oldest first, stopping at the first that has not
        (``Event.query``, never a synchronize). Returns the records
        made."""
        done = []
        with self._spans_lock:
            while self._spans and self._spans[0][3].end.query():
                done.append(self._spans.popleft())
        for op, lane, nbytes, s, world in done:
            self.record(op, lane, nbytes, span_seconds(s), world=world)
        return len(done)

    def pending_spans(self) -> int:
        with self._spans_lock:
            return len(self._spans)

    def reset(self) -> None:
        """Drop all accumulated state (tests and bench A/B harnesses)."""
        with self._spans_lock:
            self._spans.clear()
        with self._lock:
            self._windows.clear()
            self._key_ewma.clear()
            self._totals.clear()
            self._lane_ewma.clear()
            self._lane_peak.clear()
            self._lane_ops.clear()
            self._alerting.clear()
            self._last_degraded.clear()
            self._degraded_count.clear()
            self._samples.clear()


_tracker = CommsTracker()


def tracker() -> CommsTracker:
    return _tracker


def record(op: str, lane: str, nbytes: int, seconds: float,
           world: Optional[int] = None) -> None:
    """Module-level shorthand for instrumentation points; no-op when the
    tracker is disabled."""
    _tracker.record(op, lane, nbytes, seconds, world=world)


def record_span(op: str, lane: str, nbytes: int, s: Span,
                world: Optional[int] = None) -> None:
    _tracker.record_span(op, lane, nbytes, s, world=world)


def configure(rank: Optional[int] = None,
              world: Optional[int] = None) -> None:
    """Take the rank and world, parse the ``HOROVOD_COMMS_*`` knobs, seed
    the lanes' rooflines from the probe cache and register the flight
    recorder's ``comms`` provider. From ``hvd.init()`` (again at each
    elastic re-init)."""
    t = _tracker
    if rank is not None:
        t.rank = int(rank)
    if world is not None:
        t.world = int(world)
    t.enabled = env._get_bool(HOROVOD_COMMS, True)
    t.window = max(1, env._get_int(HOROVOD_COMMS_WINDOW, DEFAULT_WINDOW))
    t.ewma_alpha = min(1.0, max(0.0, env._get_float(
        HOROVOD_COMMS_EWMA_ALPHA, DEFAULT_EWMA_ALPHA)))
    t.degraded_fraction = env._get_float(HOROVOD_COMMS_DEGRADED_FRACTION,
                                         DEFAULT_DEGRADED_FRACTION)
    _seed_from_probe_cache(t)
    from horovod_tpu_torch import flight_recorder

    if t.enabled:
        flight_recorder.set_state_provider("comms", t.ledger)
    else:
        flight_recorder.set_state_provider("comms", None)


def _seed_from_probe_cache(t: "CommsTracker") -> None:
    """Seed lane rooflines from the probe cache (``HOROVOD_PROBE_CACHE``,
    ``autotune/probe.py``) when it matches this world: the data group's
    allreduce bus bandwidth bounds the ``device`` lane (the port has no
    ``spmd`` lane), the hierarchy's hops their own lanes. A corrupt value
    seeds nothing."""
    from horovod_tpu_torch.autotune import probe

    roofline = probe.load_cached_roofline(world=t.world)
    if not roofline:
        return
    for lane, key in (("device", "allreduce_busbw_gbps"),
                      ("hier_intra", "hier_intra_busbw_gbps"),
                      ("hier_cross", "hier_cross_busbw_gbps")):
        try:
            value = float(roofline.get(key) or 0.0)
        except (TypeError, ValueError):
            continue
        if value > 0:
            t.seed_roofline(lane, value, source="probe_cache")


_DATA_LANES = frozenset(("device", "host_ring", "spmd", "zero",
                         "bucket_wire", "hier_intra", "hier_cross"))


def data_lane_busbw_gbs() -> Optional[float]:
    """Byte-weighted smoothed bus bandwidth (GB/s) across the training
    data-plane lanes (the serving ``kv`` lane is excluded). This is the
    autotuner's wire-utilization score component; ``None`` until a
    data-plane collective has been recorded."""
    t = _tracker
    t.sweep()
    with t._lock:
        lane_bytes: Dict[str, float] = {}
        for (op, lane), tot in t._totals.items():
            if lane in _DATA_LANES:
                lane_bytes[lane] = lane_bytes.get(lane, 0.0) + tot[0]
        num = den = 0.0
        for lane, nbytes in lane_bytes.items():
            ewma = t._lane_ewma.get(lane)
            if ewma and nbytes > 0:
                num += ewma * nbytes
                den += nbytes
    return (num / den) if den > 0 else None


def comms_state() -> dict:
    """Document for the metrics server's ``GET /comms`` route: the
    ledger + the recent busbw sample trail."""
    state = _tracker.ledger()
    state["samples"] = _tracker.samples()[-64:]
    state["enabled"] = _tracker.enabled
    return state


# -- cross-rank postmortem ----------------------------------------------------

def format_comms_report(dumps: List[dict]) -> str:
    """Cross-rank comms report from flight-recorder dumps' ``comms``
    state: per-rank lane busbw vs roofline, the slowest lane across the
    fleet, and the rank furthest below its roofline. Empty string when
    no dump carries a comms ledger (pre-comms-plane dumps)."""
    ranks = []
    for d in dumps:
        comms = (d.get("state") or {}).get("comms")
        if not isinstance(comms, dict):
            continue
        ranks.append((d.get("launch_rank", d.get("rank", "?")), comms))
    if not ranks:
        return ""
    lines = ["=== comms report (%d rank%s) ==="
             % (len(ranks), "" if len(ranks) == 1 else "s")]
    lane_utils: Dict[str, List[float]] = {}
    worst = None  # (rank, lane, utilization, busbw, roofline)
    for rank, comms in sorted(ranks, key=lambda r: str(r[0])):
        lanes = comms.get("lanes", {})
        parts = []
        for lane, rec in sorted(lanes.items()):
            if not isinstance(rec, dict) or rec.get("busbw_gbs") is None:
                continue
            util = rec.get("utilization")
            parts.append("%s %.2f GB/s%s%s" % (
                lane, rec["busbw_gbs"],
                ("/%.2f (%.0f%%)" % (rec["roofline_gbs"], 100.0 * util))
                if isinstance(util, (int, float)) else "",
                " DEGRADED" if rec.get("alerting") else ""))
            if isinstance(util, (int, float)):
                lane_utils.setdefault(lane, []).append(util)
                if worst is None or util < worst[2]:
                    worst = (rank, lane, util, rec["busbw_gbs"],
                             rec.get("roofline_gbs"))
        lines.append("rank %s: %s" % (
            rank, "; ".join(parts) if parts else "no traffic recorded"))
        for lane, rec in sorted(lanes.items()):
            last = rec.get("last_degraded") if isinstance(rec, dict) \
                else None
            if isinstance(last, dict):
                lines.append(
                    "rank %s: degraded %s %s %s — %.2f GB/s vs %.2f "
                    "roofline (%.0f%% < threshold)" % (
                        rank, lane, last.get("op", "?"),
                        last.get("size_bucket", "?"),
                        last.get("busbw_gbs", 0.0),
                        last.get("roofline_gbs", 0.0),
                        100.0 * last.get("utilization", 0.0)))
    if lane_utils:
        slowest = min(lane_utils,
                      key=lambda ln: sum(lane_utils[ln])
                      / len(lane_utils[ln]))
        mean_util = sum(lane_utils[slowest]) / len(lane_utils[slowest])
        lines.append("slowest lane: %s (%.0f%% of roofline across %d "
                     "rank%s)" % (slowest, 100.0 * mean_util,
                                  len(lane_utils[slowest]),
                                  "" if len(lane_utils[slowest]) == 1
                                  else "s"))
    if worst is not None:
        rank, lane, util, busbw, roof = worst
        lines.append(
            "furthest below roofline: rank %s %s (%.2f of %s GB/s, "
            "%.0f%%)" % (rank, lane, busbw,
                         ("%.2f" % roof) if isinstance(roof, (int, float))
                         else "?", 100.0 * util))
    return "\n".join(lines)
