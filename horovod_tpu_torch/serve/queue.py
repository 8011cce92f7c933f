"""Shared request queue for the serving plane (port of
``horovod_tpu/serve/queue.py``: the same classes, scopes and wire format,
byte for byte).

Two transports behind one contract:

* :class:`RequestQueue` — in-memory, single-controller. ``hvd.serve()``
  threads (replicas) and caller threads (submitters) share it inside one
  process; it is also the reference semantics the unit tests pin down.
* :class:`KVQueueFrontend` / :class:`KVQueueReplica` — the cross-process
  transport over the rendezvous HTTP KV store (run/rendezvous.py), used
  by fleets of ``python -m horovod_tpu_torch.serve`` workers. The store
  has no atomic claim op, so the frontend is the single dispatcher: it
  round-robins requests into per-rank scopes, watches per-rank
  heartbeat keys, and re-dispatches the un-answered requests of a dead
  replica to survivors (responses are deduplicated by request id, so a
  reply that raced the death detection is harmless).

The zero-lost-requests invariant both transports uphold: a request
leaves the system only by completing. Pulling moves it to an in-flight
set tagged with the puller's rank; worker loss moves that rank's
in-flight requests back to the FRONT of the waiting line
(:meth:`RequestQueue.requeue_worker`), oldest first, so a re-dispatched
request does not also lose its queue position.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch import flight_recorder, tracing
from horovod_tpu_torch.utils.env import (HOROVOD_SERVE_RESULT_TTL_S,
                                         _get_float)

# rendezvous scopes of the cross-process transport
REQ_SCOPE = "serve.req.{rank}"   # per-replica inbox: key=uid, val=request
RESP_SCOPE = "serve.resp"        # key=uid, val=completion
HB_SCOPE = "serve.hb"            # key=str(rank), TTL-listed for liveness
CTL_SCOPE = "serve.ctl"          # "stop" key drains the fleet

# a replica heartbeats ~4x faster than the frontend declares it dead.
# Replicas beat from a dedicated thread (replica._KVTransport), NOT the
# serve loop, so a multi-second blocking step (a first request's CUDA
# graph capture, large prefills) cannot lapse a healthy replica's
# liveness.
HEARTBEAT_SECONDS = 0.5
STALE_SECONDS = 2.0

# completed results are held for late readers, then evicted — a serving
# process must not leak memory proportional to total requests served
RESULT_TTL_SECONDS = 600.0


class QueueFull(RuntimeError):
    """Admission refused: the queue is at HOROVOD_SERVE_QUEUE_CAPACITY."""


@dataclasses.dataclass
class Request:
    """One generation request. ``submitted_s`` is the submitter's local
    monotonic clock (latency accounting happens where the clock lives).
    ``trace_id`` is the distributed trace context (tracing.py): minted
    once at submit, it rides the wire format through every transport hop
    so spans on the frontend and on whichever replica(s) serve the
    request join into one Perfetto flow. ``requeues`` counts how many
    times worker loss bounced the request back into the waiting line."""

    uid: str
    prompt: List[int]
    max_new_tokens: int
    submitted_s: float = 0.0
    trace_id: str = ""
    requeues: int = 0

    def to_json(self) -> bytes:
        return json.dumps({"uid": self.uid, "prompt": list(self.prompt),
                           "max_new_tokens": self.max_new_tokens,
                           "trace_id": self.trace_id,
                           "requeues": self.requeues}).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Request":
        d = json.loads(raw)
        return cls(uid=d["uid"], prompt=[int(t) for t in d["prompt"]],
                   max_new_tokens=int(d["max_new_tokens"]),
                   trace_id=d.get("trace_id", ""),
                   requeues=int(d.get("requeues", 0)))


@dataclasses.dataclass
class Completion:
    """A finished request: generated ids + where/how it ran."""

    uid: str
    tokens: List[int]
    prompt_len: int
    rank: int
    ttft_s: float = 0.0      # submit -> first generated token
    latency_s: float = 0.0   # submit -> completion
    finish: str = "length"
    trace_id: str = ""       # trace context echoed back to the submitter
    requeues: int = 0

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Completion":
        d = json.loads(raw)
        return cls(uid=d["uid"], tokens=[int(t) for t in d["tokens"]],
                   prompt_len=int(d["prompt_len"]), rank=int(d["rank"]),
                   ttft_s=float(d.get("ttft_s", 0.0)),
                   latency_s=float(d.get("latency_s", 0.0)),
                   finish=d.get("finish", "length"),
                   trace_id=d.get("trace_id", ""),
                   requeues=int(d.get("requeues", 0)))


class RequestQueue:
    """In-process shared queue: waiting deque + per-rank in-flight map +
    completed results, one lock. No call blocks under the lock — waiters
    poll (:meth:`result`) with short sleeps outside it."""

    def __init__(self, capacity: int = 1024,
                 result_ttl: Optional[float] = None):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._result_ttl = (
            _get_float(HOROVOD_SERVE_RESULT_TTL_S, RESULT_TTL_SECONDS)
            if result_ttl is None else result_ttl)
        self._waiting: deque = deque()           # guarded-by: _lock
        self._inflight: Dict[str, Tuple[int, Request]] = {}  # guarded-by: _lock
        self._results: Dict[str, Completion] = {}  # guarded-by: _lock
        self._expiry: deque = deque()            # (deadline, uid); guarded-by: _lock
        self._submitted = 0                      # guarded-by: _lock
        self._completed = 0                      # guarded-by: _lock
        self._requeued = 0                       # guarded-by: _lock

    def submit(self, prompt: List[int], max_new_tokens: int,
               uid: Optional[str] = None, trace_id: str = "") -> str:
        t0 = time.time()
        req = Request(uid=uid or uuid.uuid4().hex, prompt=list(prompt),
                      max_new_tokens=int(max_new_tokens),
                      submitted_s=time.monotonic(),
                      trace_id=trace_id or tracing.new_trace_id())
        with self._lock:
            if len(self._waiting) >= self._capacity:
                raise QueueFull(
                    f"serve queue at capacity ({self._capacity})")
            self._waiting.append(req)
            self._submitted += 1
        tracing.record("request.submit", t0, time.time() - t0,
                       trace_id=req.trace_id, uid=req.uid,
                       prompt_len=len(req.prompt))
        return req.uid

    def pull(self, rank: int, max_n: int) -> List[Request]:
        """Hand up to ``max_n`` waiting requests to replica ``rank``;
        they stay in-flight (charged to that rank) until completed or
        requeued."""
        out: List[Request] = []
        with self._lock:
            while self._waiting and len(out) < max_n:
                req = self._waiting.popleft()
                self._inflight[req.uid] = (rank, req)
                out.append(req)
        return out

    def complete(self, completion: Completion) -> None:
        t0 = time.time()
        now = time.monotonic()
        with self._lock:
            self._inflight.pop(completion.uid, None)
            # first writer wins: a requeued duplicate that also finished
            # must not overwrite the reply the caller already saw
            if completion.uid not in self._results:
                self._results[completion.uid] = completion
                self._expiry.append((now + self._result_ttl,
                                     completion.uid))
                self._completed += 1
            # evict results older than the TTL (amortized on the write
            # path) — without this a long-running serving process leaks
            # one Completion per request ever served
            while self._expiry and self._expiry[0][0] <= now:
                _, uid = self._expiry.popleft()
                self._results.pop(uid, None)
        tracing.record("request.response", t0, time.time() - t0,
                       trace_id=completion.trace_id, uid=completion.uid,
                       finish=completion.finish)

    def requeue_worker(self, rank: int) -> int:
        """Return every request in-flight on ``rank`` to the FRONT of
        the waiting line (oldest first). The no-request-lost half of
        worker loss; called by the serve loop on ``WorkersDownError``,
        quarantine, or replica death."""
        with self._lock:
            stranded = [(uid, req) for uid, (r, req)
                        in self._inflight.items() if r == rank]
            for uid, req in sorted(stranded,
                                   key=lambda kv: kv[1].submitted_s,
                                   reverse=True):
                del self._inflight[uid]
                req.requeues += 1
                self._waiting.appendleft(req)
            self._requeued += len(stranded)
            return len(stranded)

    def result(self, uid: str, timeout: Optional[float] = None
               ) -> Completion:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                done = self._results.get(uid)
            if done is not None:
                return done
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"request {uid} not completed "
                                   f"within {timeout}s")
            time.sleep(0.002)

    def try_result(self, uid: str) -> Optional[Completion]:
        with self._lock:
            return self._results.get(uid)

    def depth(self) -> int:
        with self._lock:
            return len(self._waiting)

    def stats(self) -> dict:
        with self._lock:
            return {"waiting": len(self._waiting),
                    "inflight": len(self._inflight),
                    "completed": self._completed,
                    "results_held": len(self._results),
                    "submitted": self._submitted,
                    "requeued": self._requeued}


class KVQueueReplica:
    """Replica-side view of the KV transport: poll the per-rank inbox,
    publish completions, heartbeat, honor the stop key. Single-owner
    (the replica loop thread) — no lock needed."""

    def __init__(self, client, rank: int):
        self._client = client            # KVStoreClient, any scope
        self._rank = rank
        self._scope = REQ_SCOPE.format(rank=rank)
        self._taken: set = set()         # guarded-by: <replica-thread>

    def heartbeat(self) -> None:
        self._client.set(str(self._rank), b"1", scope=HB_SCOPE)

    def poll(self, max_n: int) -> List[Request]:
        out: List[Request] = []
        try:
            keys = self._client.keys(scope=self._scope)
        except Exception:
            return out
        # taken keys leave the inbox listing when complete() finishes
        # them — prune the memo so it tracks the inbox, not all history
        self._taken.intersection_update(keys)
        for key in keys:
            if key in self._taken or len(out) >= max_n:
                continue
            try:
                raw = self._client.get(key, scope=self._scope, wait=False)
            except KeyError:
                continue
            self._taken.add(key)
            req = Request.from_json(raw)
            req.submitted_s = time.monotonic()  # replica-local clock
            out.append(req)
        return out

    def complete(self, completion: Completion) -> None:
        self._client.set(completion.uid, completion.to_json(),
                         scope=RESP_SCOPE)
        try:  # shrink the inbox listing; liveness only, never correctness
            self._client.finish(completion.uid, scope=self._scope)
        except Exception:
            pass

    def stopped(self) -> bool:
        try:
            self._client.get("stop", scope=CTL_SCOPE, wait=False)
            return True
        except Exception:
            return False


class KVQueueFrontend:
    """Dispatcher side of the KV transport (runs in the load generator's
    process). Single-owner thread."""

    # dedup memory for late zombie replies: completions already consumed
    # and finished server-side; bounded so a long-running frontend does
    # not leak one Completion per request ever served
    _DONE_MAX = 65536

    def __init__(self, client, stale_seconds: float = STALE_SECONDS):
        self._client = client
        self._stale = stale_seconds
        self._rr = itertools.count()
        # guarded-by: <frontend-thread>
        self._assigned: Dict[str, Tuple[int, Request]] = {}
        self._done: Dict[str, Completion] = {}
        self._done_order: deque = deque()
        self.requeued = 0
        self.dead_ranks: set = set()

    def live_replicas(self) -> List[int]:
        try:
            keys = self._client.keys(scope=HB_SCOPE, ttl=self._stale)
        except Exception:
            return []
        return sorted(int(k) for k in keys if k.isdigit())

    def wait_for_replicas(self, n: int, timeout: float = 60.0) -> List[int]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            live = self.live_replicas()
            if len(live) >= n:
                return live
            time.sleep(0.1)
        raise TimeoutError(f"{n} serve replicas not up within {timeout}s")

    def submit(self, request: Request,
               rank: Optional[int] = None) -> int:
        """Dispatch to ``rank`` (or round-robin over live replicas).
        Mints the trace context if the caller didn't — the span covers
        the KV put, i.e. the frontend→replica wire hop."""
        if not request.trace_id:
            request.trace_id = tracing.new_trace_id()
        t0 = time.time()
        if rank is None:
            live = self.live_replicas()
            if not live:
                raise RuntimeError("no live serve replicas")
            rank = live[next(self._rr) % len(live)]
        self._client.set(request.uid, request.to_json(),
                         scope=REQ_SCOPE.format(rank=rank))
        self._assigned[request.uid] = (rank, request)
        tracing.record("request.submit", t0, time.time() - t0,
                       trace_id=request.trace_id, uid=request.uid,
                       prompt_len=len(request.prompt), to_rank=rank)
        return rank

    def _redispatch_dead(self) -> None:
        live = set(self.live_replicas())
        if not live:
            return
        # _assigned holds only unanswered requests (poll_responses drops
        # an entry the moment its completion is consumed)
        for uid, (rank, req) in list(self._assigned.items()):
            if rank in live:
                continue
            self.dead_ranks.add(rank)
            self.requeued += 1
            req.requeues += 1
            new_rank = self.submit(req)
            flight_recorder.emit(
                "serve_redispatch", uid=uid, trace_id=req.trace_id,
                dead_rank=rank, new_rank=new_rank,
                requeues=req.requeues)

    def poll_responses(self) -> List[Completion]:
        """Drain newly-published completions; re-dispatches the pending
        requests of any replica whose heartbeat went stale."""
        fresh: List[Completion] = []
        try:
            keys = self._client.keys(scope=RESP_SCOPE)
        except Exception:
            keys = []
        for key in keys:
            if key in self._done:
                continue
            t0 = time.time()
            try:
                raw = self._client.get(key, scope=RESP_SCOPE, wait=False)
            except KeyError:
                continue
            done = Completion.from_json(raw)
            self._done[key] = done   # dedup: first reply wins
            self._done_order.append(key)
            self._assigned.pop(key, None)
            fresh.append(done)
            tracing.record("request.response", t0, time.time() - t0,
                           trace_id=done.trace_id, uid=done.uid,
                           from_rank=done.rank, finish=done.finish)
            try:  # shrink the response listing; liveness only
                self._client.finish(key, scope=RESP_SCOPE)
            except Exception:
                pass
        while len(self._done) > self._DONE_MAX:
            self._done.pop(self._done_order.popleft(), None)
        self._redispatch_dead()
        return fresh

    def pending(self) -> int:
        return len(self._assigned)

    def stop_fleet(self) -> None:
        self._client.set("stop", b"1", scope=CTL_SCOPE)
