"""Flight recorder: the events of the seconds before a process died (port
of ``horovod_tpu/flight_recorder.py``: the same knobs, metric families,
event kinds, dump schema and JSON keys, so each package's readers read the
other's dumps).

Live metrics (``metrics.py``) and the Chrome trace (``timeline.py``) say
how the job is doing now; the flight recorder says what the runtime did
just before it stopped. It is a bounded ring of structured events emitted
by every plane (negotiation begin and end, each rank's request, cache
invalidations, each dispatch, completion and failure with its bytes, the
pipeline depth, ZeRO's phases, checkpoint commits and restores, elastic
re-forms, integrity verdicts, injected faults) and a dumper that writes the
ring, every registered state provider (the runtime's in-flight ops and the
memory, comms and goodput ledgers) and the metrics snapshot as JSON when
the process is about to become unreadable: a fatal signal, a stall
shutdown, a lost or stalled worker, a cycle abort, an OOM, a rollback; and
on demand (:func:`dump_debug_state`, ``GET /debug`` on the metrics
endpoint).

``emit`` is one ``deque.append`` on a ``maxlen`` deque: atomic under the
GIL, no lock, the oldest event overwritten in O(1). Everything else
(providers, the snapshot, the clock offset, files, shipping) runs only at
dump time.

A dump is also shipped to the launcher's rendezvous KV store (scope
``flight``, ``run/rendezvous.py``) when ``HOROVOD_RENDEZVOUS_HTTP_ADDR``
and ``_PORT`` name one, within the client's deadline, so a merged
postmortem covers a worker whose disk went with it. Events carry
``time.time()`` epoch seconds; at dump time the rank estimates its clock
offset against the store's ``GET /_time``, so :func:`merge_events`
interleaves ranks of different hosts on one axis.

A dump issues no collective: it runs after a failed runtime aborted its
process groups, where a collective would hang.

Knobs: ``HOROVOD_FLIGHT_RECORDER`` (default on; ``0`` disables; an integer
> 1 sets the ring's capacity, default 2048), ``HOROVOD_FLIGHT_RECORDER_DIR``
(directory for ``flight-rank-N.json``; unset: no files, shipping and
``/debug`` still work).
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils import logging as log

SCHEMA = "horovod-flight-recorder-v1"
# rendezvous KV scope where workers ship their dumps for the launcher
RENDEZVOUS_SCOPE = "flight"
DUMP_PREFIX = "flight-rank-"

_EVENTS_TOTAL = _metrics().counter(
    "horovod_flight_recorder_events_total",
    "Structured events recorded into the flight-recorder ring buffer.")
_DUMPS_TOTAL = _metrics().counter(
    "horovod_flight_recorder_dumps_total",
    "Flight-recorder snapshots produced (file dumps, shipped dumps, "
    "/debug requests and hvd.dump_debug_state calls).")


def _rendezvous_addr() -> Optional[Tuple[str, int]]:
    addr = os.environ.get(env.HOROVOD_RENDEZVOUS_HTTP_ADDR)
    port = os.environ.get(env.HOROVOD_RENDEZVOUS_HTTP_PORT)
    if not addr or not port:
        return None
    try:
        return addr, int(port)
    except ValueError:
        return None


def _estimate_clock_offset() -> Optional[float]:
    """Offset such that ``local_time + offset == launcher_time``, from the
    rendezvous store's ``/_time`` (the sample with the smallest round trip
    wins, the server's time against the midpoint). None when no store is
    configured or reachable."""
    dest = _rendezvous_addr()
    if dest is None:
        return None
    from urllib.request import urlopen

    best_rtt, best_offset = None, None
    for _ in range(3):
        try:
            t0 = time.time()
            with urlopen("http://%s:%d/_time" % dest, timeout=2) as resp:
                server = float(resp.read())
            t1 = time.time()
        except (OSError, ValueError, http.client.HTTPException):
            return best_offset
        rtt = t1 - t0
        if best_rtt is None or rtt < best_rtt:
            best_rtt, best_offset = rtt, server - (t0 + t1) / 2.0
    return best_offset


class FlightRecorder:
    """Bounded ring of structured events and the dump machinery."""

    def __init__(self) -> None:
        enabled, capacity = env.parse_flight_recorder(
            os.environ.get(env.HOROVOD_FLIGHT_RECORDER))
        self.enabled = enabled
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        # the rank this process was launched as: stable across elastic
        # re-forms (renumbering), so per-process dump files never collide
        self.launch_rank = env._get_int(env.HOROVOD_RANK, 0)
        self.rank = self.launch_rank
        self.dir = os.environ.get(env.HOROVOD_FLIGHT_RECORDER_DIR, "")
        self._providers: Dict[str, Callable[[], Any]] = {}
        self._dump_history: List[dict] = []  # guarded-by: _dump_lock
        self._clock_offset: Optional[float] = None
        self._offset_checked = False
        self._dump_lock = threading.Lock()
        self._last_failure_dump = 0.0

    # -- hot path -----------------------------------------------------------
    def emit(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        ev = {"t": time.time(), "kind": kind}
        ev.update(fields)
        self._events.append(ev)  # GIL-atomic; maxlen evicts the oldest
        _EVENTS_TOTAL.inc()

    def events(self) -> List[dict]:
        return list(self._events)

    # -- configuration ------------------------------------------------------
    def configure(self, rank: Optional[int] = None) -> None:
        """Re-read the knobs (from ``hvd.init()``, the elastic re-init
        included, where the rank may have changed)."""
        enabled, capacity = env.parse_flight_recorder(
            os.environ.get(env.HOROVOD_FLIGHT_RECORDER))
        self.enabled = enabled
        if capacity != self.capacity:
            self._events = deque(self._events, maxlen=capacity)
            self.capacity = capacity
        self.dir = os.environ.get(env.HOROVOD_FLIGHT_RECORDER_DIR, "")
        if rank is not None:
            self.rank = rank

    def set_state_provider(self, name: str,
                           fn: Optional[Callable[[], Any]]) -> None:
        """Register a callable whose result is embedded under
        ``state[name]`` in every dump. Re-registering replaces (a re-made
        runtime supersedes the dead one); ``None`` unregisters."""
        if fn is None:
            self._providers.pop(name, None)
        else:
            self._providers[name] = fn

    # -- dump side ----------------------------------------------------------
    def clock_offset(self) -> Optional[float]:
        if not self._offset_checked:
            self._offset_checked = True
            self._clock_offset = _estimate_clock_offset()
        return self._clock_offset

    def snapshot(self, reason: str) -> dict:
        """The postmortem document: the ring, the providers' state, the
        metrics, the identity, and the clock metadata that merges dumps
        across hosts."""
        state = {}
        for name, fn in list(self._providers.items()):
            try:
                state[name] = fn()
            except Exception as exc:  # a dying plane must not block dumps
                state[name] = "<state provider failed: %s>" % (exc,)
        _DUMPS_TOTAL.inc()
        return {
            "schema": SCHEMA,
            "rank": self.rank,
            "launch_rank": self.launch_rank,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "reason": reason,
            "wall_time": time.time(),
            "clock_offset_seconds": self.clock_offset(),
            "dump_history": list(self._dump_history),
            "events": self.events(),
            "state": state,
            "metrics": _metrics().snapshot(),
        }

    def _dump_path(self, target: str) -> str:
        if "{rank}" in target:
            return target.replace("{rank}", str(self.launch_rank))
        if target.endswith(".json"):
            return target
        return os.path.join(target,
                            "%s%d.json" % (DUMP_PREFIX, self.launch_rank))

    def dump(self, reason: str, path: Optional[str] = None,
             ship: bool = True) -> dict:
        """Snapshot and persist: write ``flight-rank-N.json`` (the last
        dump wins; earlier reasons stay in ``dump_history``) and ship the
        JSON to the rendezvous store when one is configured. Never raises
        for a file or a store that fails: it runs on failing paths."""
        # the snapshot is built before the lock: the first one estimates
        # the clock offset over HTTP, and concurrent dumpers (a signal, a
        # stall shutdown, a dying cycle thread) must not queue behind it
        snap = self.snapshot(reason)
        payload = None
        target = path or self.dir
        with self._dump_lock:
            # the history holds the earlier dumps only: this reason is
            # snap["reason"]
            snap["dump_history"] = list(self._dump_history)
            self._dump_history.append(
                {"reason": reason, "t": snap["wall_time"]})
            if target:
                # one writer at a time: concurrent dumps are whole files,
                # the last one winning
                try:
                    out = self._dump_path(target)
                    parent = os.path.dirname(out)
                    if parent:
                        os.makedirs(parent, exist_ok=True)
                    payload = json.dumps(snap, default=repr)
                    # a reader (a postmortem, a test polling for the file)
                    # sees the previous dump or this one whole, never a
                    # file still being written
                    tmp = os.path.join(parent or ".", ".%s.%d.tmp" % (
                        os.path.basename(out), os.getpid()))
                    with open(tmp, "w") as f:
                        f.write(payload)
                    os.replace(tmp, out)
                    log.debug("flight recorder: wrote %s (%s)", out, reason)
                except (OSError, TypeError, ValueError) as exc:
                    log.warning("flight recorder: dump to %r failed: %s",
                                target, exc)
        # shipping is an HTTP round trip: never under the lock
        if ship:
            try:
                self._ship(payload if payload is not None
                           else json.dumps(snap, default=repr))
            except (OSError, ValueError, http.client.HTTPException) as exc:
                log.debug("flight recorder: ship failed: %s", exc)
        return snap

    def _ship(self, payload: str) -> None:
        dest = _rendezvous_addr()
        if dest is None:
            return
        from horovod_tpu_torch.run.rendezvous import KVStoreClient
        from horovod_tpu_torch.utils import resilience

        # a dump usually ships while the job is unhealthy: retry briefly,
        # but bound the whole attempt so it never delays teardown long
        client = KVStoreClient(
            dest[0], dest[1], scope=RENDEZVOUS_SCOPE, timeout=5.0,
            retry=resilience.RetryPolicy.from_env("flight", deadline=5.0))
        client.set("rank.%d" % self.launch_rank, payload.encode())


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    return _recorder


def emit(kind: str, **fields) -> None:
    """Record one structured event (the hot-path entry point)."""
    _recorder.emit(kind, **fields)


def set_state_provider(name: str, fn: Optional[Callable[[], Any]]) -> None:
    _recorder.set_state_provider(name, fn)


def configure(rank: Optional[int] = None) -> None:
    _recorder.configure(rank=rank)


def debug_state() -> dict:
    """The snapshot the metrics endpoint's ``/debug`` serves."""
    return _recorder.snapshot("debug_endpoint")


def dump_debug_state(path: Optional[str] = None,
                     reason: str = "on_demand") -> dict:
    """``hvd.dump_debug_state()``: the full debug snapshot, persisted too
    when ``path`` or ``HOROVOD_FLIGHT_RECORDER_DIR`` names a
    destination."""
    if path or _recorder.dir:
        return _recorder.dump(reason, path=path)
    return _recorder.snapshot(reason)


def dump_on_failure(reason: str) -> None:
    """A dump from a failure path (cycle abort, stall shutdown, a lost
    worker, a fatal signal, an OOM, a rollback). At most one a second, so
    a failure loop cannot become a storm of writes. A provider that fails
    is written as its message; a file or store that fails is logged."""
    if not _recorder.enabled:
        return
    now = time.monotonic()
    if _recorder._last_failure_dump and \
            now - _recorder._last_failure_dump < 1.0:
        return
    _recorder._last_failure_dump = now
    _recorder.dump(reason)


# -- fatal-signal hook ------------------------------------------------------
_signals_installed = False
_prev_handlers: Dict[int, Any] = {}


def install_signal_handlers() -> None:
    """Dump on SIGTERM, then hand the signal to the handler that was there
    before (or its default action), and on SIGUSR1 (dump and keep running:
    ``kill -USR1`` a live job to inspect it). Only from the main thread
    (a rendezvous thread or an embedded ``init`` skips it: the failure
    paths still dump) and only when the recorder is on.
    :func:`uninstall_signal_handlers` puts the earlier handlers back."""
    global _signals_installed
    if _signals_installed or not _recorder.enabled:
        return
    if threading.current_thread() is not threading.main_thread():
        return
    import signal

    def _fatal(signum, frame):
        dump_on_failure("signal:%s" % signal.Signals(signum).name)
        prev = _prev_handlers.get(signum)
        if prev is signal.SIG_IGN:
            return
        if callable(prev):
            prev(signum, frame)
            return
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    def _inspect(signum, frame):
        dump_on_failure("signal:SIGUSR1")
        prev = _prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)

    _prev_handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM, _fatal)
    if hasattr(signal, "SIGUSR1"):
        _prev_handlers[signal.SIGUSR1] = signal.signal(signal.SIGUSR1,
                                                       _inspect)
    _signals_installed = True


def uninstall_signal_handlers() -> None:
    """Restore the handlers :func:`install_signal_handlers` replaced (from
    ``hvd.shutdown()``, so a process that leaves the world keeps none of
    the recorder's handlers). Main thread only, like the install."""
    global _signals_installed
    if not _signals_installed:
        return
    if threading.current_thread() is not threading.main_thread():
        return
    import signal

    for signum, prev in list(_prev_handlers.items()):
        signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
    _prev_handlers.clear()
    _signals_installed = False


# -- cross-rank postmortem --------------------------------------------------
def load_dumps(directory: str) -> List[dict]:
    """Every ``flight-rank-*.json`` in ``directory`` (an unreadable or
    truncated file is skipped with a warning: a crash may have cut one
    short)."""
    dumps = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return dumps
    for name in names:
        if not (name.startswith(DUMP_PREFIX) and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                dumps.append(json.load(f))
        except (OSError, ValueError) as exc:
            log.warning("flight recorder: skipping unreadable dump %s: %s",
                        path, exc)
    return dumps


def merge_events(dumps: List[dict]) -> List[dict]:
    """Interleave the ranks' events on one time axis: each rank's events
    are shifted by its estimated clock offset (when it had one)."""
    merged = []
    for d in dumps:
        offset = d.get("clock_offset_seconds") or 0.0
        rank = d.get("launch_rank", d.get("rank", "?"))
        for ev in d.get("events", ()):
            e = dict(ev)
            e["rank"] = rank
            e["t_merged"] = float(ev.get("t", 0.0)) + offset
            merged.append(e)
    merged.sort(key=lambda e: e["t_merged"])
    return merged


def suspect_culprit(dumps: List[dict]) -> Optional[Tuple[Any, str]]:
    """The rank to blame: explicit evidence first (a rank that recorded
    its own injected kill; a digest vote's suspect; ranks named by
    workers_down, stall_shutdown or collective_timeout events; the rank
    missing from a re-form's membership), then the straggler lag EWMA of
    any coordinator's dump."""
    for d in dumps:
        for ev in d.get("events", ()):
            if ev.get("kind") == "fault_inject" and ev.get("action") == \
                    "kill":
                return ev.get("rank"), "recorded its own injected kill"
    # a digest vote that convicted a rank is stronger than any absence or
    # straggler heuristic
    for d in dumps:
        for ev in d.get("events", ()):
            if ev.get("kind") in ("integrity_violation", "rollback") \
                    and ev.get("suspect") is not None:
                return ev.get("suspect"), (
                    "voted out by collective digest disagreement")
    named: Dict[Any, int] = {}
    for d in dumps:
        for ev in d.get("events", ()):
            if ev.get("kind") in ("workers_down", "stall_shutdown",
                                  "collective_timeout"):
                for r in (ev.get("ranks") or ev.get("missing") or ()):
                    named[r] = named.get(r, 0) + 1
    if named:
        rank = max(named, key=lambda r: named[r])
        return rank, ("named missing/lost by %d workers_down/stall event(s)"
                      % named[rank])
    # a partitioned rank ships no dump and a transport error names no peer,
    # but the survivors' re-form does: whoever was in the old generation
    # and is absent from the new membership
    for d in dumps:
        for ev in d.get("events", ()):
            if ev.get("kind") != "elastic_reform":
                continue
            members = ev.get("members")
            old_size = ev.get("old_size")
            if members is None or old_size is None:
                continue
            missing = sorted(set(range(int(old_size))) - set(members))
            if missing:
                return missing[0], (
                    "absent from the generation-%s re-form (%d of %d old "
                    "ranks rejoined)" % (ev.get("generation", "?"),
                                         len(members), int(old_size)))
    best = None
    for d in dumps:
        lag = d.get("metrics", {}).get("horovod_straggler_lag_seconds")
        for row in (lag or {}).get("values", ()):
            value = row.get("value", 0.0)
            if best is None or value > best[1]:
                best = (row.get("labels", {}).get("rank"), value)
    # same-cycle arrival jitter is microseconds; a real straggler lags by
    # whole cycles: below that, naming a rank would be noise
    if best is not None and best[1] >= 0.05:
        return best[0], ("highest straggler lag EWMA (%.3fs)" % best[1])
    return None


def load_restart_lineage(directory: str) -> Optional[dict]:
    """The supervised-restart lineage a supervising launcher records next
    to the dumps (``restart-lineage.json``), or None."""
    path = os.path.join(directory, "restart-lineage.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def format_postmortem(dumps: List[dict], last_n: int = 40,
                      lineage: Optional[dict] = None) -> str:
    """The merged postmortem as text: each rank's dump, the last
    ``last_n`` interleaved events, the suspected culprit, then the memory,
    SLO, comms and goodput reports of the dumps' ledgers. ``lineage`` (from
    :func:`load_restart_lineage`) puts the restart history first."""
    lines = ["=== flight-recorder postmortem (%d dump%s) ==="
             % (len(dumps), "" if len(dumps) == 1 else "s")]
    for att in (lineage or {}).get("attempts", ()):
        dur = float(att.get("ended", 0)) - float(att.get("started", 0))
        lines.append(
            "restart attempt %s/%s: exit=%s duration=%.1fs" % (
                att.get("attempt", "?"),
                att.get("restart_budget", "?"),
                att.get("exit_code", "?"), max(dur, 0.0)))
    for d in sorted(dumps, key=lambda d: d.get("launch_rank", 0)):
        offset = d.get("clock_offset_seconds")
        lines.append(
            "rank %s: reason=%s host=%s pid=%s events=%d%s" % (
                d.get("launch_rank", d.get("rank", "?")),
                d.get("reason", "?"), d.get("host", "?"), d.get("pid", "?"),
                len(d.get("events", ())),
                (" clock_offset=%+.4fs" % offset) if offset is not None
                else ""))
    merged = merge_events(dumps)
    tail = merged[-last_n:]
    if len(merged) > len(tail):
        lines.append("... %d earlier events omitted ..."
                     % (len(merged) - len(tail)))
    for ev in tail:
        t = ev["t_merged"]
        stamp = time.strftime("%H:%M:%S", time.localtime(t)) + \
            (".%03d" % int((t % 1) * 1000))
        extras = " ".join(
            "%s=%s" % (k, v) for k, v in ev.items()
            if k not in ("t", "t_merged", "kind", "rank"))
        lines.append("%s [rank %s] %s%s"
                     % (stamp, ev["rank"], ev["kind"],
                        (" " + extras) if extras else ""))
    culprit = suspect_culprit(dumps)
    if culprit is not None:
        lines.append("suspected culprit: rank %s (%s)" % culprit)
    else:
        lines.append("suspected culprit: none identified")
    # the planes import this module, so they are imported here
    from horovod_tpu_torch import comms, goodput, memory, tracing

    for report in (memory.format_memory_report(dumps),
                   tracing.format_slo_report(dumps),
                   comms.format_comms_report(dumps),
                   goodput.format_goodput_report(dumps)):
        if report:
            lines.append("")
            lines.append(report)
    return "\n".join(lines)
