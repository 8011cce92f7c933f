"""Control-plane resilience: retry with backoff, the generation fence, the
collective deadline and network chaos (port of
``horovod_tpu/utils/resilience.py``).

* :class:`RetryPolicy`: exponential backoff with full jitter
  (``delay ~ U(0, min(max, base * 2**(k-1)))``), a per-attempt timeout hint,
  an overall deadline and the retryable classification. Every retry moves
  ``horovod_net_retries_total{transport=...}`` and its backoff seconds;
  exhaustion moves ``horovod_net_gave_up_total``.
* **The generation fence**: the elastic runner publishes its membership
  generation here (:func:`set_generation`); the runtime stamps its typed
  verdicts with it (:func:`current_generation`), and the checkpoint
  writer's barrier keys its store prefix by it.
* :func:`collective_timeout`: ``HOROVOD_COLLECTIVE_TIMEOUT``, the deadline
  the coordinator holds each negotiation round to.
* **Network chaos**: ``HOROVOD_FAULT_INJECT`` clauses of the kinds
  ``partition:<rank>[:<secs>][:after=<secs>]``, ``kv_outage:<secs>
  [:after=<secs>|:on=reform]``, ``flaky:<prob>[:rank=<r>][:seconds=<t>]``
  and ``netdelay:<ms>[:rank=<r>][:hop=cross]``, fired by :func:`inject`
  inside the real transports before each wire op: the rendezvous store's
  client (``kv``) and the gloo controller's verbs (``ctrl``). The server
  answers 503 inside a ``kv_outage`` window. ``hop=cross`` prices a slow
  inter-group link: it taxes the data plane's seams (the executor's flat
  collectives and the two-level hops of ``runtime/hierarchy.py``) once a
  crossing of that link.

Each retry is a ``net_retry`` flight event and its backoff sleep the
goodput ledger's ``collective_stall``; exhaustion is ``net_gave_up``; a
fired fault is ``chaos_inject``. This module sits at the bottom layer and
imports no runtime, elastic or run module.
"""

from __future__ import annotations

import dataclasses
import http.client
import os
import random
import socket
import time
from typing import Callable, List, Optional
from urllib.error import HTTPError, URLError

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch import goodput
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils.env import (
    HOROVOD_COLLECTIVE_TIMEOUT, HOROVOD_FAULT_INJECT,
    HOROVOD_NET_ATTEMPT_TIMEOUT_SECONDS, HOROVOD_NET_BACKOFF_BASE_SECONDS,
    HOROVOD_NET_BACKOFF_MAX_SECONDS, HOROVOD_NET_DEADLINE_SECONDS,
    HOROVOD_NET_MAX_RETRIES, HOROVOD_RANK, _get_float, _get_int)

_NET_RETRIES = _metrics().counter(
    "horovod_net_retries_total",
    "Control-plane transport ops retried after a transient failure.",
    labelnames=("transport",))
_NET_BACKOFF = _metrics().counter(
    "horovod_net_backoff_seconds_total",
    "Seconds spent sleeping in retry backoff, per transport.",
    labelnames=("transport",))
_NET_GAVE_UP = _metrics().counter(
    "horovod_net_gave_up_total",
    "Transport ops that exhausted their retry budget and re-raised.",
    labelnames=("transport",))
_CHAOS_INJECTED = _metrics().counter(
    "horovod_net_chaos_injected_total",
    "Network faults fired by the HOROVOD_FAULT_INJECT chaos harness.",
    labelnames=("kind",))

# HTTP statuses worth retrying: timeouts, throttles and server-side
# failures (503 is the rendezvous kv_outage signal). 404 is not: it is the
# store's key-absent signal, which the long-poll protocol rides on.
RETRYABLE_HTTP_CODES = (408, 429, 500, 502, 503, 504)


class ChaosError(ConnectionResetError):
    """A connection reset injected by the chaos harness: a
    ``ConnectionResetError``, so the retryable classification and the
    transports' handlers treat it as the real thing."""


def is_retryable(exc: BaseException) -> bool:
    """Retryable: connection resets, refusals and aborts, socket timeouts,
    HTTP protocol errors, URL errors and the HTTP statuses of
    :data:`RETRYABLE_HTTP_CODES`. Not: 404, other 4xx, and anything that
    is not a transport error."""
    if isinstance(exc, HTTPError):
        return exc.code in RETRYABLE_HTTP_CODES
    return isinstance(exc, (ConnectionError, TimeoutError, socket.timeout,
                            http.client.HTTPException, URLError, OSError))


def note_retry(transport: str, phase: str, attempt: int, delay: float,
               exc: BaseException) -> None:
    """Account one retry: the metrics, a ``net_retry`` event, and the
    backoff sleep about to happen as collective-stall badput."""
    _NET_RETRIES.labels(transport=transport).inc()
    _NET_BACKOFF.labels(transport=transport).inc(delay)
    flight_recorder.emit("net_retry", transport=transport, phase=phase,
                         attempt=attempt, delay=round(delay, 4),
                         error=str(exc)[:120])
    goodput.record_span("collective_stall", delay)
    log.debug("net retry: %s/%s attempt %d in %.3fs (%s)",
              transport, phase, attempt, delay, exc)


def give_up(transport: str, phase: str, attempt: int,
            exc: BaseException) -> None:
    """Account an exhausted retry budget: the metric and ``net_gave_up``."""
    _NET_GAVE_UP.labels(transport=transport).inc()
    flight_recorder.emit("net_gave_up", transport=transport, phase=phase,
                         attempts=attempt, error=str(exc)[:200])
    log.warning("net retries exhausted: %s/%s after %d attempt(s): %s",
                transport, phase, attempt, exc)


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff with full jitter, bounded by attempts and an
    overall deadline. ``attempt_timeout`` is what callers pass to their
    socket timeouts; ``sleep`` and ``rng`` are injectable for tests."""

    transport: str = "net"
    max_retries: int = 4
    base_delay: float = 0.1
    max_delay: float = 2.0
    deadline: float = 30.0
    attempt_timeout: float = 10.0
    sleep: Callable[[float], None] = time.sleep
    rng: Optional[random.Random] = None

    @classmethod
    def from_env(cls, transport: str = "net", **overrides) -> "RetryPolicy":
        kw = dict(
            max_retries=_get_int(HOROVOD_NET_MAX_RETRIES, 4),
            base_delay=_get_float(HOROVOD_NET_BACKOFF_BASE_SECONDS, 0.1),
            max_delay=_get_float(HOROVOD_NET_BACKOFF_MAX_SECONDS, 2.0),
            deadline=_get_float(HOROVOD_NET_DEADLINE_SECONDS, 30.0),
            attempt_timeout=_get_float(
                HOROVOD_NET_ATTEMPT_TIMEOUT_SECONDS, 10.0),
        )
        kw.update(overrides)
        return cls(transport=transport, **kw)

    def delay_for(self, attempt: int) -> float:
        """Full-jitter delay of retry ``attempt`` (1-based)."""
        cap = min(self.max_delay,
                  self.base_delay * (2.0 ** max(attempt - 1, 0)))
        r = (self.rng or random).random()
        return cap * r

    def retryable(self, exc: BaseException) -> bool:
        return is_retryable(exc)

    def call(self, fn: Callable, *args, phase: str = "",
             deadline: Optional[float] = None,
             classify: Optional[Callable[[BaseException], bool]] = None,
             **kwargs):
        """``fn(*args, **kwargs)``, retrying transient failures until
        ``max_retries`` or the deadline is spent, then re-raising the last
        error; a non-retryable error passes through at once."""
        start = time.monotonic()
        budget = self.deadline if deadline is None else deadline
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                if not (classify or is_retryable)(exc):
                    raise
                attempt += 1
                delay = self.delay_for(attempt)
                elapsed = time.monotonic() - start
                if attempt > self.max_retries or elapsed + delay > budget:
                    give_up(self.transport, phase, attempt, exc)
                    raise
                note_retry(self.transport, phase, attempt, delay, exc)
                self.sleep(delay)


# -- collective timeout / generation fence ---------------------------------

def collective_timeout() -> float:
    """``HOROVOD_COLLECTIVE_TIMEOUT`` in seconds; 0 disables the deadline."""
    return _get_float(HOROVOD_COLLECTIVE_TIMEOUT, 0.0)


# the process's membership generation; the elastic runner writes it at
# every re-form
_generation = 0


def set_generation(gen: int) -> None:
    global _generation
    _generation = int(gen)


def current_generation() -> int:
    return _generation


# -- network chaos ---------------------------------------------------------

NET_FAULT_KINDS = ("partition", "kv_outage", "flaky", "netdelay")


@dataclasses.dataclass(frozen=True)
class NetFault:
    kind: str
    rank: Optional[int] = None  # None: every rank
    seconds: float = float("inf")  # the fault window's length
    prob: float = 0.0  # flaky: a reset's probability an op
    delay_ms: float = 0.0  # netdelay: latency an op
    after: float = 0.0  # the window's start, seconds after arming
    on: str = ""  # kv_outage's trigger: "" (timer) or "reform"
    # netdelay's scope: "" every wire op, "cross" only the crossings of the
    # slow inter-group link
    hop: str = ""


def is_net_clause(clause: str) -> bool:
    """True when a ``HOROVOD_FAULT_INJECT`` clause names a network fault."""
    return clause.strip().split(":", 1)[0].strip().lower() in NET_FAULT_KINDS


def parse_net_faults(text: Optional[str]) -> List[NetFault]:
    """The network clauses of ``HOROVOD_FAULT_INJECT`` (``;``-separated;
    other clauses are skipped). ``ValueError`` on a malformed one."""
    faults: List[NetFault] = []
    for clause in (text or "").split(";"):
        clause = clause.strip()
        if not clause or not is_net_clause(clause):
            continue
        parts = [p.strip() for p in clause.split(":")]
        kind = parts[0].lower()
        positional: List[str] = []
        named = {}
        for p in parts[1:]:
            if "=" in p:
                k, v = p.split("=", 1)
                named[k.strip().lower()] = v.strip()
            else:
                positional.append(p)
        try:
            after = float(named.pop("after", 0.0))
            if kind == "partition":
                faults.append(NetFault(
                    kind, rank=int(positional[0]),
                    seconds=(float(positional[1]) if len(positional) > 1
                             else float("inf")),
                    after=after))
            elif kind == "kv_outage":
                faults.append(NetFault(
                    kind, seconds=float(positional[0]), after=after,
                    on=named.pop("on", "").lower()))
            elif kind == "flaky":
                prob = min(max(float(positional[0]), 0.0), 1.0)
                faults.append(NetFault(
                    kind, prob=prob,
                    rank=(int(named.pop("rank")) if "rank" in named
                          else None),
                    seconds=float(named.pop("seconds", float("inf"))),
                    after=after))
            elif kind == "netdelay":
                hop = named.pop("hop", "").lower()
                if hop not in ("", "cross"):
                    raise ValueError(f"unknown hop {hop!r} "
                                     "(expected hop=cross)")
                faults.append(NetFault(
                    kind, delay_ms=float(positional[0]),
                    rank=(int(named.pop("rank")) if "rank" in named
                          else None),
                    after=after, hop=hop))
        except (IndexError, ValueError) as exc:
            raise ValueError(
                f"HOROVOD_FAULT_INJECT: malformed net-fault clause "
                f"{clause!r}: {exc}") from exc
        if named:
            raise ValueError(
                f"HOROVOD_FAULT_INJECT: unknown key(s) {sorted(named)} in "
                f"net-fault clause {clause!r}")
    return faults


class _Chaos:
    """Armed chaos: the faults, the launch rank they target (frozen: a
    re-form renumbers ``HOROVOD_RANK``), a per-rank RNG and the arming
    time the windows count from."""

    def __init__(self, faults: List[NetFault], rank: int):
        self.faults = faults
        self.rank = rank
        self.t0 = time.monotonic()
        self.rng = random.Random(0xC0FFEE + rank)
        self._partition_announced = False


_chaos_state: Optional[_Chaos] = None
_chaos_loaded = False


def _chaos() -> Optional[_Chaos]:
    global _chaos_state, _chaos_loaded
    if not _chaos_loaded:
        _chaos_loaded = True
        try:
            faults = parse_net_faults(os.environ.get(HOROVOD_FAULT_INJECT))
        except ValueError as exc:
            log.error("%s", exc)
            faults = []
        if faults:
            rank = int(os.environ.get(HOROVOD_RANK, "0") or 0)
            _chaos_state = _Chaos(faults, rank)
            log.warning("network chaos armed on rank %d: %s", rank,
                        "; ".join(f.kind for f in faults))
    return _chaos_state


def reload_chaos() -> None:
    """Re-arm chaos from the current environment (tests)."""
    global _chaos_state, _chaos_loaded
    _chaos_state = None
    _chaos_loaded = False


def inject(transport: str, phase: str = "",
           crossings: Optional[int] = None) -> None:
    """The chaos seam, called inside the transports before each wire op:
    applies the netdelay, flaky and partition faults whose window covers
    now. A no-op when nothing is armed.

    ``crossings``: how many times this op crosses the hierarchy's group
    boundary (the slow link), declared by the data plane's seams (the
    executor's flat collectives as ``ring``: ``2(w-1)`` for an allreduce;
    the two-level hops as ``hier_cross``, ``2(G-1)``, and ``hier_intra``,
    0). ``netdelay:...:hop=cross`` sleeps its delay once a crossing and
    skips seams that declare none; plain ``netdelay`` ignores it. The
    data plane's seams take delays only."""
    ch = _chaos()
    if ch is None:
        return
    now = time.monotonic() - ch.t0
    for f in ch.faults:
        in_window = f.after <= now <= f.after + f.seconds
        targeted = f.rank is None or f.rank == ch.rank
        if f.kind == "netdelay" and targeted and in_window:
            if f.hop == "cross":
                if not crossings:  # a seam off the slow link (or untyped)
                    continue
                _CHAOS_INJECTED.labels(kind="netdelay").inc()
                time.sleep(f.delay_ms * crossings / 1000.0)
                continue
            _CHAOS_INJECTED.labels(kind="netdelay").inc()
            time.sleep(f.delay_ms / 1000.0)
        elif transport in ("ring", "hier_intra", "hier_cross"):
            # the data plane's seams carry delays only: resets and
            # partitions model control traffic, which the retry and
            # elastic layers own
            continue
        elif f.kind == "flaky" and targeted and in_window:
            if ch.rng.random() < f.prob:
                _CHAOS_INJECTED.labels(kind="flaky").inc()
                flight_recorder.emit("chaos_inject", fault="flaky",
                                     transport=transport, phase=phase)
                raise ChaosError(
                    f"chaos: injected connection reset "
                    f"({transport}/{phase})")
        elif f.kind == "partition" and f.rank == ch.rank and now >= f.after:
            end = f.after + f.seconds
            if not ch._partition_announced:
                ch._partition_announced = True
                _CHAOS_INJECTED.labels(kind="partition").inc()
                flight_recorder.emit("chaos_inject", fault="partition",
                                     rank=ch.rank, seconds=f.seconds)
                log.error("chaos: partitioning rank %d control traffic "
                          "for %s", ch.rank,
                          "ever" if end == float("inf")
                          else "%.0fs" % f.seconds)
            # dropped traffic reads as a blocked op here and as silence to
            # the peers: sleep out the window
            while True:
                remaining = end - (time.monotonic() - ch.t0)
                if remaining <= 0:
                    break
                time.sleep(min(remaining, 0.2))
