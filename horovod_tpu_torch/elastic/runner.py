"""Elastic runner: catch failures, re-form the world, resume (port of
``horovod_tpu/elastic/runner.py:71-454``; reference: horovod/common/
elastic.py ``run_fn``).

The decorated training function takes a
:class:`~horovod_tpu_torch.elastic.state.State` first. When a collective
raises :class:`~horovod_tpu_torch.exceptions.WorkersDownError` (a peer
died, hung past a deadline or closed its transport) the runner

1. leaves the world (``hvd.shutdown``: on the card the groups are aborted,
   not destroyed, since a collective a dead peer never joins may be in
   flight),
2. re-forms through the rendezvous store (``run/rendezvous.py``): every
   survivor registers under the next generation's scope; once the scope
   stops changing for ``HOROVOD_ELASTIC_SETTLE_SECONDS``, the lowest old
   rank leads, numbers the survivors in order (itself 0), picks a
   coordinator address (``host:port`` of a free port on its host) and
   publishes the assignment,
3. rewrites ``HOROVOD_RANK``, ``HOROVOD_SIZE`` and
   ``HOROVOD_COORDINATOR_ADDR`` and calls ``core.basics.reinit()``: a new
   default group on a store the new rank 0 hosts, new control and data
   groups (NCCL on the card), a new runtime, in the same process,
4. rolls the state back to the last commit (``state.on_reset``) and makes
   the new rank 0's copy everyone's (``state.sync``, which re-shards ZeRO
   states with the neighbour replicas; a ``WorkersDownError`` there, a
   peer lost in the new world's first collectives, re-forms again),

then calls the function again. A membership below
``HOROVOD_ELASTIC_MIN_WORKERS`` is scanned again with bounded exponential
backoff (:class:`Backoff`). A
:class:`~horovod_tpu_torch.exceptions.HostsUpdatedInterrupt` (the driver's
host-change notice, seen at a commit) takes the same path without the
rollback. A :class:`~horovod_tpu_torch.exceptions.NumericalError` takes no
re-form: every rank raised it in the same dispatch, and
``integrity.rollback.handle_failure`` restores in place before the
function runs again.

The port's world always forms at ``HOROVOD_COORDINATOR_ADDR``
(``core/basics.py``), so a re-form always writes the assignment's
coordinator there (the JAX package writes it only where it was set). The
JAX package's ``jax.distributed`` teardown has no counterpart.

The observability planes: a re-form is an ``elastic_reform`` flight event
(with the old size and the members, so a postmortem names the rank that
did not come back) and a goodput incident of cause ``elastic_reform``
whose seconds run from the quiesce to the end of the sync, with the rank
that did not rejoin as its culprit and the steps rolled back to the last
commit as its replay; a lost worker is a ``workers_down`` event and a
failure dump, a host notice ``hosts_updated``, an integrity verdict a
failure dump after the rollback, and an OOM in the training function the
memory ledger's record before it propagates.
"""

from __future__ import annotations

import functools
import json
import os
import socket as socket_mod
import threading
import time
from typing import Iterator, List, Optional

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch import goodput
from horovod_tpu_torch import memory
from horovod_tpu_torch import exceptions
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.elastic import fault_inject
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils import resilience
from horovod_tpu_torch.utils.env import (
    HOROVOD_COORDINATOR_ADDR, HOROVOD_CROSS_RANK, HOROVOD_CROSS_SIZE,
    HOROVOD_ELASTIC_BACKOFF_BASE_SECONDS, HOROVOD_ELASTIC_BACKOFF_MAX_SECONDS,
    HOROVOD_ELASTIC_HEARTBEAT_SECONDS, HOROVOD_ELASTIC_MAX_RETRIES,
    HOROVOD_ELASTIC_MIN_WORKERS, HOROVOD_ELASTIC_REJOIN_TIMEOUT_SECONDS,
    HOROVOD_ELASTIC_SETTLE_SECONDS, HOROVOD_LOCAL_RANK, HOROVOD_LOCAL_SIZE,
    HOROVOD_RANK, HOROVOD_RENDEZVOUS_HTTP_ADDR, HOROVOD_RENDEZVOUS_HTTP_PORT,
    HOROVOD_SIZE, _get_float, _get_int)

_RESTARTS_TOTAL = _metrics().counter(
    "horovod_elastic_restarts_total",
    "Successful elastic re-forms after a failure (per process).")
_WORKERS_REMOVED = _metrics().counter(
    "horovod_elastic_workers_removed_total",
    "Workers lost across elastic re-forms, as seen by this process.")
_GENERATION_GAUGE = _metrics().gauge(
    "horovod_elastic_generation",
    "Current membership generation (0 = original launch).")

_LOCAL_HOSTS = ("127.0.0.1", "localhost", "::1")

# the process's membership generation; every re-form adds one
_generation = 0
_heartbeat_thread = None
_heartbeat_stop = threading.Event()
_last_notice: Optional[str] = None
# seconds of the last re-form's parts: shutdown, rendezvous, reinit, sync
_last_reform: dict = {}


def restarts() -> int:
    """How many times this process has re-formed (the generation)."""
    return _generation


def last_reform() -> dict:
    """Seconds of the last re-form's parts (``shutdown``, ``rendezvous``,
    ``reinit``, ``restore``, ``sync``), and its ``generation``; empty
    before any."""
    return dict(_last_reform)


class Backoff:
    """Deterministic bounded exponential backoff: ``delays()`` yields
    ``retries`` sleeps, ``base, base*factor, ...`` capped at
    ``max_delay``."""

    def __init__(self, base: float = 0.5, factor: float = 2.0,
                 max_delay: float = 10.0, retries: int = 5):
        if base <= 0 or factor < 1 or retries < 0:
            raise ValueError("base > 0, factor >= 1, retries >= 0 required")
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.retries = retries

    def delays(self) -> Iterator[float]:
        delay = self.base
        for _ in range(self.retries):
            yield min(delay, self.max_delay)
            delay *= self.factor

    def schedule(self) -> List[float]:
        return list(self.delays())

    @classmethod
    def from_env(cls) -> "Backoff":
        return cls(
            base=_get_float(HOROVOD_ELASTIC_BACKOFF_BASE_SECONDS, 0.5),
            max_delay=_get_float(HOROVOD_ELASTIC_BACKOFF_MAX_SECONDS, 10.0),
            retries=_get_int(HOROVOD_ELASTIC_MAX_RETRIES, 5))


def _kv_client(scope: str = "global"):
    """The rendezvous store's client, or None when the launcher gave no
    store (one process, a manual run)."""
    addr = os.environ.get(HOROVOD_RENDEZVOUS_HTTP_ADDR)
    port = os.environ.get(HOROVOD_RENDEZVOUS_HTTP_PORT)
    if not addr or not port:
        return None
    from horovod_tpu_torch.run.rendezvous import KVStoreClient

    timeout = _get_float(HOROVOD_ELASTIC_REJOIN_TIMEOUT_SECONDS, 60.0)
    return KVStoreClient(addr, int(port), scope=scope, timeout=timeout)


def _worker_uid() -> str:
    return f"{fault_inject.initial_rank()}-{os.getpid()}"


def _coordinator_host() -> str:
    """The host of this process's current coordinator address."""
    addr = os.environ.get(HOROVOD_COORDINATOR_ADDR, "")
    addr = addr.split("://", 1)[-1]
    if not addr or addr.startswith("/"):  # file:// or none
        return ""
    return addr.rsplit(":", 1)[0]


def _my_address() -> str:
    """An address the peers can reach this worker's new coordinator at:
    loopback jobs stay on loopback, others use the host's address."""
    old = _coordinator_host()
    if not old or old in _LOCAL_HOSTS:
        return "127.0.0.1"
    try:
        return socket_mod.gethostbyname(socket_mod.gethostname())
    except OSError:
        return old


def _free_port() -> int:
    with socket_mod.socket() as s:
        s.bind(("0.0.0.0", 0))
        return s.getsockname()[1]


def start_heartbeat() -> None:
    """Announce liveness in the store's ``heartbeat`` scope (the driver
    reads a beat older than the TTL as a lost worker)."""
    global _heartbeat_thread
    if _heartbeat_thread is not None and _heartbeat_thread.is_alive():
        return
    client = _kv_client(scope="heartbeat")
    if client is None:
        return
    interval = _get_float(HOROVOD_ELASTIC_HEARTBEAT_SECONDS, 2.0)
    uid = _worker_uid()
    _heartbeat_stop.clear()

    def _beat():
        while not _heartbeat_stop.is_set():
            try:
                client.set(uid, json.dumps(
                    {"rank": int(os.environ.get(HOROVOD_RANK, "0")),
                     "generation": _generation}).encode())
            except OSError:
                pass  # the launcher going away ends the job anyway
            _heartbeat_stop.wait(interval)

    _heartbeat_thread = threading.Thread(
        target=_beat, daemon=True, name="hvd-elastic-heartbeat")
    _heartbeat_thread.start()


def stop_heartbeat() -> None:
    """End the heartbeat (a process that leaves an elastic job and goes on,
    as a test or a smoke script does); ``run`` starts it again."""
    global _heartbeat_thread
    _heartbeat_stop.set()
    if _heartbeat_thread is not None:
        _heartbeat_thread.join(timeout=10)
        _heartbeat_thread = None


def check_host_updates() -> None:
    """Raise :class:`HostsUpdatedInterrupt` when the driver published a
    new host-change notice since the last check (``State.commit`` calls
    it: a commit is the one place a re-form is safe). The first notice
    seen only sets the baseline."""
    global _last_notice
    client = _kv_client(scope="elastic.notice")
    if client is None:
        return
    try:
        notice = client.get("update", wait=False).decode()
    except (KeyError, OSError):
        return
    if _last_notice is None:
        _last_notice = notice
        return
    if notice != _last_notice:
        _last_notice = notice
        raise exceptions.HostsUpdatedInterrupt(
            f"elastic driver notice: {notice}")


def _scan_members(client, scope: str, settle: float,
                  deadline: float) -> List[int]:
    """Poll the generation's membership scope until it has not changed for
    ``settle`` seconds (survivors see a failure at different times)."""
    members: List[int] = []
    last_change = time.monotonic()
    while True:
        now = time.monotonic()
        try:
            seen = sorted(int(k.split(".", 1)[1])
                          for k in client.keys(scope)
                          if k.startswith("member."))
        except OSError:
            # an outage of the store (a restart, kv_outage chaos): keep
            # polling until the deadline
            if now >= deadline:
                return members
            time.sleep(0.2)
            continue
        if seen != members:
            members, last_change = seen, now
        elif members and now - last_change >= settle:
            return members
        if now >= deadline:
            return members
        time.sleep(0.1)


def _reform(min_workers: int, backoff: Backoff) -> List[int]:
    """Re-form the world as generation ``_generation + 1`` and join it.
    Returns the old ranks that did not make it."""
    global _generation
    client = _kv_client()
    if client is None:
        raise exceptions.WorkersDownError(
            "cannot re-form: no rendezvous KV store "
            "(HOROVOD_RENDEZVOUS_HTTP_ADDR/PORT unset)")

    gen = _generation + 1
    scope = f"elastic.g{gen}"
    old_rank = int(os.environ.get(HOROVOD_RANK, "0"))
    old_size = int(os.environ.get(HOROVOD_SIZE, "1"))
    settle = _get_float(HOROVOD_ELASTIC_SETTLE_SECONDS, 1.0)
    rejoin_timeout = _get_float(HOROVOD_ELASTIC_REJOIN_TIMEOUT_SECONDS, 60.0)

    t0 = time.monotonic()
    # the process keeps its device across generations
    device = basics.device() if basics.is_initialized() else None
    basics.shutdown()
    t_shutdown = time.monotonic()

    deadline = time.monotonic() + rejoin_timeout
    # the registration survives an outage of the store for the whole
    # rejoin window
    while True:
        try:
            client.set(f"member.{old_rank}", _worker_uid().encode(),
                       scope=scope)
            break
        except OSError as exc:
            if time.monotonic() >= deadline:
                raise exceptions.WorkersDownError(
                    f"elastic re-form failed: cannot register with the "
                    f"rendezvous store within {rejoin_timeout:g}s "
                    f"({exc})") from exc
            time.sleep(0.5)
    members = _scan_members(client, scope, settle, deadline)
    # below quorum: scan again with backoff (an early scan can settle on
    # this worker alone)
    for delay in backoff.delays():
        if len(members) >= min_workers:
            break
        log.warning("elastic: %d/%d workers present; retrying in %.1fs",
                    len(members), min_workers, delay)
        time.sleep(delay)
        members = _scan_members(
            client, scope, settle, time.monotonic() + rejoin_timeout)
    if len(members) < min_workers:
        raise exceptions.WorkersDownError(
            f"elastic re-form failed: {len(members)} workers "
            f"registered, HOROVOD_ELASTIC_MIN_WORKERS={min_workers} "
            f"(after {backoff.retries} retries)")
    # the leader is decided after the final scan: an early lone scanner
    # must not keep a stale claim
    if min(members) == old_rank:
        addr = _my_address()
        assignment = {
            "generation": gen,
            "size": len(members),
            # the lowest surviving old rank becomes rank 0: the sync root
            "ranks": {str(r): i for i, r in enumerate(members)},
            "addr": addr,
            "port": _free_port(),
            "coordinator": f"{addr}:{_free_port()}",
        }
        client.set("assign", json.dumps(assignment).encode(), scope=scope)
    try:
        assignment = json.loads(client.get("assign", scope=scope).decode())
    except (KeyError, TimeoutError) as exc:
        raise exceptions.WorkersDownError(
            f"elastic re-form failed: no assignment for generation {gen} "
            f"({exc})") from exc

    new_rank = assignment["ranks"].get(str(old_rank))
    if new_rank is None:
        raise exceptions.WorkersDownError(
            f"this worker (old rank {old_rank}) was not included in the "
            f"generation-{gen} assignment")
    new_size = int(assignment["size"])
    os.environ[HOROVOD_RANK] = str(new_rank)
    os.environ[HOROVOD_SIZE] = str(new_size)
    # the derived topology follows from rank and size again
    for stale in (HOROVOD_LOCAL_RANK, HOROVOD_LOCAL_SIZE,
                  HOROVOD_CROSS_RANK, HOROVOD_CROSS_SIZE):
        os.environ.pop(stale, None)
    # the port's world always forms at the coordinator address
    os.environ[HOROVOD_COORDINATOR_ADDR] = assignment["coordinator"]
    t_rendezvous = time.monotonic()

    _generation = gen
    # the generation fence: the checkpoint barrier's keys and the typed
    # verdicts carry it
    resilience.set_generation(gen)
    _GENERATION_GAUGE.set(gen)
    if new_size < old_size:
        _WORKERS_REMOVED.inc(old_size - new_size)
    log.warning("elastic: re-formed generation %d: old rank %d -> new rank "
                "%d of %d", gen, old_rank, new_rank, new_size)
    flight_recorder.emit("elastic_reform", generation=gen,
                         old_rank=old_rank, new_rank=new_rank,
                         size=new_size, members=members, old_size=old_size)
    basics.reinit(device=device)
    _last_reform.clear()
    _last_reform.update(generation=gen, shutdown=t_shutdown - t0,
                        rendezvous=t_rendezvous - t_shutdown,
                        reinit=time.monotonic() - t_rendezvous)
    return sorted(set(range(old_size)) - set(members))


def run(func):
    """Decorator: the elastic-retrying entry point (reference:
    horovod/common/elastic.py ``run``). The wrapped function's first
    argument is a :class:`~horovod_tpu_torch.elastic.state.State`."""

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        fault_inject.initial_rank()  # frozen before a re-form renumbers
        min_workers = _get_int(HOROVOD_ELASTIC_MIN_WORKERS, 1)
        start_heartbeat()
        rollback = False
        while True:
            if rollback is not False:
                # everything from the quiesce to the end of the sync is
                # re-form badput; steps rolled back will run again
                t_reform = time.monotonic()
                step_before = getattr(state, "step", None)
                missing: List[int] = []
                while True:
                    lost = _reform(min_workers, Backoff.from_env())
                    missing = missing or lost  # the first loss's culprit
                    t0 = time.monotonic()
                    if rollback:  # a failure: back to the last commit
                        state.on_reset()
                    t1 = time.monotonic()
                    # either way the new rank 0's copy is everyone's; a
                    # peer lost in the new world's first collectives (a
                    # reset gloo verb is a lost worker here, where the JAX
                    # package's socket retried it) means another re-form,
                    # counted in this incident's time
                    try:
                        state.sync(root_rank=0)
                        break
                    except exceptions.WorkersDownError as exc:
                        log.warning("elastic: workers down while syncing "
                                    "the re-formed state (%s); re-forming "
                                    "again", exc)
                        flight_recorder.emit(
                            "workers_down",
                            ranks=sorted(getattr(exc, "ranks", None) or []),
                            error=str(exc)[:200])
                _last_reform.update(restore=t1 - t0,
                                    sync=time.monotonic() - t1)
                # sync consumed the neighbour replicas; their old-rank
                # tags mean nothing in the new world
                from horovod_tpu_torch.ckpt import replica as _ckpt_replica

                _ckpt_replica.clear("reform")
                if rollback:
                    _RESTARTS_TOTAL.inc()
                step_after = getattr(state, "step", None)
                replay = 0
                if isinstance(step_before, int) \
                        and isinstance(step_after, int):
                    replay = max(0, step_before - step_after)
                goodput.note_incident(
                    "elastic_reform", time.monotonic() - t_reform,
                    generation=_generation,
                    culprit_rank=missing[0] if missing else None,
                    replay_steps=replay,
                    linked_events=["elastic_reform", "workers_down"])
                rollback = False
            try:
                return func(state, *args, **kwargs)
            except exceptions.HostsUpdatedInterrupt as exc:
                log.warning("elastic: %s; re-forming to fold in the new "
                            "host set", exc)
                flight_recorder.emit("hosts_updated", notice=str(exc)[:200])
                rollback = None  # re-form without a rollback
            except exceptions.NumericalError as exc:
                # no worker is down: every rank raised the same verdict
                # together, so the recovery is a rollback in place
                log.warning("elastic: integrity failure (%s); rolling "
                            "back in place", exc)
                from horovod_tpu_torch.integrity import rollback as _rb

                _rb.handle_failure(state, exc)
                # after the rollback, so the dump holds its event, which
                # names the verdict (a quarantine or a spent budget dumps
                # on its own path)
                flight_recorder.dump_on_failure("integrity_violation")
                continue
            except exceptions.WorkersDownError as exc:
                log.warning("elastic: workers down (%s); attempting "
                            "recovery", exc)
                flight_recorder.emit(
                    "workers_down",
                    ranks=sorted(getattr(exc, "ranks", None) or []),
                    error=str(exc)[:200])
                # the runtime has aborted its groups by now: the dump
                # issues no collective
                flight_recorder.dump_on_failure(
                    "worker_stall"
                    if isinstance(exc, exceptions.WorkerStallError)
                    else "worker_lost")
                rollback = True
            except Exception as exc:
                # an OOM raised by the training function itself (not
                # through the executor) still leaves its record
                memory.maybe_record_oom(exc, where="elastic")
                raise

    return wrapper
