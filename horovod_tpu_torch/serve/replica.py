"""The per-replica serving loop: pull → admit/prefill → decode → retire
(port of ``horovod_tpu/serve/replica.py``, its hooks included).

One :class:`Replica` drives one :class:`~horovod_tpu_torch.serve.kv_cache.
DecodeEngine` and one :class:`~horovod_tpu_torch.serve.batcher.
ContinuousBatcher` on a single thread. The loop each iteration:

1. pulls new requests from the shared queue (in-process or KV-backed,
   behind a small transport adapter) into the batcher's waiting line;
2. when admission is due (decode-block boundary, idle replica, or the
   admission deadline — batcher.py has the policy), prefills admitted
   prompts through the bucketed prefill programs; the first generated
   token falls out of prefill, so TTFT is measured here;
3. runs ONE fixed-shape decode step over all slots and retires finished
   rows iteration-level (a retiring request frees its slot for the very
   next admission check, not a batch boundary).

Reliability wiring (the serve plane rides the existing stack):

* ``fault_inject.maybe_inject`` fires per DECODE step (the serving
  analogue of the training step counter), so a fault harness can kill
  a replica mid-generation;
* a :class:`~horovod_tpu_torch.integrity.guards.StepGuard` watches the
  per-step max-|logit|; a non-finite value (or an exhausted guard)
  QUARANTINES the replica — it returns every pulled request to the
  queue, stops heartbeating so the dispatcher reassigns, and parks,
  rather than serving garbage;
* a :class:`~horovod_tpu_torch.exceptions.WorkersDownError` escaping the step
  (a model whose forward uses collectives under elastic) requeues the
  in-flight work the same way before re-raising to the elastic driver.

Any other exception escaping a step (a failed CUDA graph capture, a
device error) quarantines the replica rather than kill its thread: the
error is logged and counted (``horovod_serve_quarantined_total``) and
``stats()["quarantined"]`` says so, for callers that must fail on it.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

from horovod_tpu_torch import flight_recorder, goodput, tracing
from horovod_tpu_torch.elastic import fault_inject
from horovod_tpu_torch.exceptions import NumericalError, WorkersDownError
from horovod_tpu_torch.metrics import COUNT_BUCKETS, registry as _metrics
from horovod_tpu_torch.serve.batcher import ContinuousBatcher
from horovod_tpu_torch.serve.kv_cache import DecodeEngine
from horovod_tpu_torch.serve.paging import PagePoolExhausted
from horovod_tpu_torch.serve.queue import (Completion, KVQueueReplica,
                                           RequestQueue, HEARTBEAT_SECONDS)
from horovod_tpu_torch.utils import logging as log

_IDLE_SLEEP_SECONDS = 0.002

_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_REQUESTS = _metrics().counter(
    "horovod_serve_requests_total",
    "Serving requests, by outcome (completed/requeued).",
    labelnames=("outcome",))
_TOKENS = _metrics().counter(
    "horovod_serve_tokens_total",
    "Tokens processed by the serving plane, by kind (prefill/decode).",
    labelnames=("kind",))
_OCCUPANCY = _metrics().gauge(
    "horovod_serve_batch_occupancy",
    "Active requests in the continuous batch, per replica.",
    labelnames=("replica",))
_QUEUE_DEPTH = _metrics().gauge(
    "horovod_serve_queue_depth",
    "Requests waiting for admission (queue + batcher), per replica.",
    labelnames=("replica",))
_OCCUPANCY_HIST = _metrics().histogram(
    "horovod_serve_batch_occupancy_steps",
    "Batch occupancy observed at each decode step.",
    buckets=COUNT_BUCKETS)
_LATENCY = _metrics().histogram(
    "horovod_serve_latency_seconds",
    "Request latency by phase: ttft (submit to first token) and total.",
    buckets=_LATENCY_BUCKETS, labelnames=("phase",))
_QUARANTINED = _metrics().counter(
    "horovod_serve_quarantined_total",
    "Replicas quarantined by the serving integrity guard.")


class _LocalTransport:
    """In-process adapter over the shared :class:`RequestQueue`."""

    def __init__(self, queue: RequestQueue, rank: int):
        self._queue = queue
        self._rank = rank

    def pull(self, max_n):
        return self._queue.pull(self._rank, max_n)

    def complete(self, completion):
        self._queue.complete(completion)

    def requeue_all(self) -> int:
        return self._queue.requeue_worker(self._rank)

    def heartbeat(self):
        pass

    def stopped(self) -> bool:
        return False

    def depth(self) -> int:
        return self._queue.depth()


class _KVTransport:
    """Cross-process adapter over the rendezvous-KV queue. Requeueing is
    the DISPATCHER's job in this transport (it owns assignment): on
    quarantine the replica just goes silent — its heartbeat lapses and
    the frontend redistributes everything unanswered.

    Heartbeats come from a dedicated daemon thread, NOT the serve loop:
    a blocking step longer than STALE_SECONDS (a first request's graph
    capture or a long prefill can take seconds) must not make
    the frontend declare a healthy replica dead and re-dispatch its
    pending work. The thread only writes one KV key; ``silent`` and the
    stop event are its whole shared state (single-word flags, read-only
    here, set by the replica thread).

    The serve loop spins at millisecond cadence; every KV op is an HTTP
    round trip, so the inbox poll and the stop-key check are throttled —
    an idle replica costs the rendezvous server ~60 requests/s, not
    ~1500."""

    _POLL_SECONDS = 0.02
    _STOP_CHECK_SECONDS = 0.25

    def __init__(self, kv: KVQueueReplica):
        self._kv = kv
        self._last_poll = 0.0
        self._last_stop_check = 0.0
        self._stopped = False
        self.silent = False          # set by replica thread on quarantine
        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="serve-heartbeat")
        self._hb_thread.start()

    def _heartbeat_loop(self) -> None:
        while True:
            if not self.silent:
                try:
                    self._kv.heartbeat()
                    tracing.note_replica_heartbeat()
                except Exception as exc:
                    log.warning("serve: heartbeat failed: %s", exc)
            if self._hb_stop.wait(HEARTBEAT_SECONDS):
                return

    def pull(self, max_n):
        now = time.monotonic()
        if now - self._last_poll < self._POLL_SECONDS:
            return []
        self._last_poll = now
        return self._kv.poll(max_n)

    def complete(self, completion):
        self._kv.complete(completion)

    def requeue_all(self) -> int:
        self.silent = True
        return 0

    def heartbeat(self):
        pass   # the dedicated thread owns liveness

    def shutdown(self) -> None:
        """Stop heartbeating for good (replica drained or crashed) so
        the frontend does not keep dispatching to a gone replica."""
        self._hb_stop.set()
        self._hb_thread.join(timeout=2 * HEARTBEAT_SECONDS)

    def stopped(self) -> bool:
        if self._stopped:
            return True
        now = time.monotonic()
        if now - self._last_stop_check < self._STOP_CHECK_SECONDS:
            return False
        self._last_stop_check = now
        self._stopped = self._kv.stopped()
        return self._stopped

    def depth(self) -> int:
        return 0


class Replica:
    """One serving replica; ``run()`` is the loop, single thread."""

    def __init__(self, engine: DecodeEngine, transport, policy, rank: int = 0,
                 name: Optional[str] = None, guard=None):
        self.engine = engine
        self.transport = transport
        self.policy = policy
        self.rank = rank
        self.name = name or f"serve-r{rank}"
        # paged engines (serve/paging.py) switch admission from dense
        # slot rows to free-page accounting: the batcher commits pool
        # pages, discounted by the candidate's current prefix hits
        self.paged = bool(getattr(engine, "paged", False))
        self.batcher = ContinuousBatcher(
            num_slots=engine.num_slots,
            max_batch_tokens=policy.max_batch_tokens,
            admission_ms=policy.admission_ms,
            decode_block=policy.decode_block,
            max_seq=engine.max_seq,
            page_tokens=engine.page_tokens if self.paged else None,
            pool_pages=engine.pool.allocatable if self.paged else None,
            prefix_probe=engine.probe_prefix if self.paged else None)
        self.guard = guard
        self.quarantined = False
        self.completed = 0
        self.decode_iterations = 0
        self.occupancy_sum = 0
        self.page_used_sum = 0   # pool pages in use, summed per step
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def stop(self) -> None:
        self._stop.set()

    def _finish(self, active, now: float) -> None:
        req = active.request
        epoch_now = time.time()
        if active.block_steps > 0:   # close the trailing decode block
            tracing.record(
                "request.decode_block", active.block_t0,
                max(epoch_now - active.block_t0, 0.0),
                trace_id=req.trace_id, uid=req.uid, slot=active.slot,
                block=active.blocks, tokens=active.block_steps)
        # "cache_limit" (not "length") when the KV cache, not the
        # request, bounded the generation — callers must be able to
        # tell a fulfilled budget from a truncated one
        completion = Completion(
            uid=req.uid, tokens=list(active.generated),
            prompt_len=active.prompt_len, rank=self.rank,
            ttft_s=active.first_token_s - req.submitted_s,
            latency_s=now - req.submitted_s,
            finish="cache_limit" if active.capped else "length",
            trace_id=req.trace_id, requeues=req.requeues)
        self.transport.complete(completion)
        self.completed += 1
        _REQUESTS.labels(outcome="completed").inc()
        _LATENCY.labels(phase="total").observe(completion.latency_s)
        serve_dur = max(now - active.admitted_s, 0.0)
        tracing.record(
            "request.serve", epoch_now - serve_dur, serve_dur,
            trace_id=req.trace_id, uid=req.uid, slot=active.slot,
            finish=completion.finish, requeues=req.requeues,
            tokens=len(active.generated),
            ttft_ms=round(completion.ttft_s * 1000.0, 3),
            latency_ms=round(completion.latency_s * 1000.0, 3))
        tracing.slo().record_request(
            completion.ttft_s, completion.latency_s, ok=True,
            trace_id=req.trace_id, rank=self.rank, requeues=req.requeues,
            phases={"queue_wait": active.queue_wait_s,
                    "prefill": active.prefill_s,
                    "decode": max(now - active.first_token_s, 0.0)})

    def _reject(self, req, reason: str) -> None:
        """Complete an unservable request (empty, or prompt longer than
        the KV cache) with ``finish="rejected"`` instead of crashing the
        loop on it or stranding its caller in ``result()``."""
        self.transport.complete(Completion(
            uid=req.uid, tokens=[], prompt_len=len(req.prompt),
            rank=self.rank, finish="rejected",
            trace_id=req.trace_id, requeues=req.requeues))
        _REQUESTS.labels(outcome="rejected").inc()
        # an unserved request is an availability bad event — it has no
        # meaningful TTFT, so the latency objectives are not scored
        tracing.slo().record_request(
            0.0, 0.0, ok=False, trace_id=req.trace_id, rank=self.rank,
            requeues=req.requeues)
        log.warning("serve: replica %s rejected request %s (%s)",
                    self.name, req.uid, reason)

    def _quarantine(self, reason: str) -> None:
        """Integrity trip: never serve garbage. Active + waiting work
        goes back to the queue (in-process) or to the dispatcher's
        death-detection (KV: the heartbeat just stops); the replica
        parks until the fleet is stopped."""
        self.quarantined = True
        _QUARANTINED.inc()
        victims = self.batcher.evict_all()
        victims += self.batcher.drain_waiting()
        if self.paged:
            # a dead replica must not pin pool pages: every request-held
            # page goes back (the chaos cell pins request_held == 0)
            self.engine.release_all()
        evicted = len(victims)
        requeued = self.transport.requeue_all()
        _REQUESTS.labels(outcome="requeued").inc(max(evicted, requeued))
        flight_recorder.emit("serve_quarantine", replica=self.name,
                             rank=self.rank, reason=reason,
                             evicted=evicted,
                             trace_ids=[r.trace_id for r in victims])
        log.error("serve: replica %s QUARANTINED (%s); %d request(s) "
                  "returned for redistribution", self.name, reason,
                  max(evicted, requeued))

    def _preempt_for_pages(self, exclude_slot=None) -> bool:
        """Page-pool exhaustion (paged engines): bounce the newest-
        admitted request back to the queue FRONT and reclaim its pages.
        Returns False when there is no other victim to take."""
        victim = self.batcher.preempt_newest(exclude_slot=exclude_slot)
        if victim is None:
            return False
        self.engine.release_slot(victim.slot)
        self.engine.note_preemption()
        _REQUESTS.labels(outcome="preempted").inc()
        # goodput ledger: the victim's decoded-so-far tokens are work the
        # preemption threw away — re-attributed from productive to
        # serve_preempted badput at the EWMA per-token decode cost
        goodput.note_serve_preempted(len(victim.generated))
        flight_recorder.emit(
            "serve_preempt", replica=self.name, rank=self.rank,
            uid=victim.request.uid, slot=victim.slot,
            trace_id=victim.request.trace_id,
            generated=len(victim.generated),
            requeues=victim.request.requeues)
        log.warning("serve: replica %s preempted request %s (pool "
                    "exhausted); requeued at front", self.name,
                    victim.request.uid)
        return True

    def _guard_ok(self, max_abs: float) -> bool:
        """Non-finite logits always quarantine; the spike guard's EWMA
        feeds the same decision once its skip budget is spent."""
        if not math.isfinite(max_abs):
            return False
        if self.guard is not None:
            try:
                self.guard.observe(max_abs)
            except NumericalError:
                return False
        return True

    # -- the loop ----------------------------------------------------------
    def run(self) -> None:
        flight_recorder.emit("serve_replica_start", replica=self.name,
                             rank=self.rank, slots=self.engine.num_slots)
        # a running loop IS the liveness signal for in-process serving
        # (the KV transport's heartbeat thread also notes it) — flips
        # the /healthz readiness gate
        tracing.note_replica_heartbeat()
        while not self._stop.is_set():
            self.transport.heartbeat()
            if self.transport.stopped():
                break
            if self.quarantined:
                time.sleep(0.05)
                continue
            try:
                self._iterate()
            except WorkersDownError:
                # elastic membership change mid-step: nothing is lost —
                # the pulled work returns to the queue before the
                # elastic driver re-forms us
                victims = self.batcher.evict_all()
                victims += self.batcher.drain_waiting()
                if self.paged:
                    self.engine.release_all()
                requeued = self.transport.requeue_all()
                requeued += len(victims)
                flight_recorder.emit(
                    "serve_requeue", replica=self.name, rank=self.rank,
                    requeued=requeued,
                    trace_ids=[r.trace_id for r in victims])
                raise
            except Exception as exc:
                # anything else must not silently kill the loop thread
                # and strand its in-flight callers — quarantine instead
                # (which requeues active + waiting work for the other
                # replicas / the dispatcher first)
                log.error("serve: replica %s loop error: %r",
                          self.name, exc)
                self._quarantine(f"loop error: {exc!r}")
        flight_recorder.emit("serve_replica_stop", replica=self.name,
                             rank=self.rank, completed=self.completed)

    def _iterate(self) -> None:
        now = time.monotonic()
        free = self.engine.num_slots - self.batcher.occupancy()
        if free > 0 or self.batcher.waiting() == 0:
            for req in self.transport.pull(max(free, 1)):
                # unservable prompts answer immediately — an oversized
                # prompt must never reach prefill (where it would blow
                # up the padded copy) or circulate in requeue forever
                if not req.prompt:
                    self._reject(req, "empty prompt")
                elif len(req.prompt) > self.engine.max_seq:
                    self._reject(
                        req, f"prompt length {len(req.prompt)} > "
                             f"max_seq {self.engine.max_seq}")
                else:
                    self.batcher.offer(req, now)
        _QUEUE_DEPTH.labels(replica=self.name).set(
            self.batcher.waiting() + self.transport.depth())

        if self.batcher.admission_due(now):
            for active in self.batcher.admit(now):
                req = active.request
                # queue-wait span: submitted -> admitted. submitted_s is
                # a LOCAL monotonic stamp; map it onto the epoch trace
                # clock by anchoring "now" and subtracting the wait.
                p0 = time.time()
                active.queue_wait_s = max(
                    active.admitted_s - req.submitted_s, 0.0)
                tracing.record(
                    "request.queue_wait", p0 - active.queue_wait_s,
                    active.queue_wait_s, trace_id=req.trace_id,
                    uid=req.uid, requeues=req.requeues)
                token = None
                while True:
                    try:
                        token, max_abs = self.engine.prefill(
                            active.slot, req.prompt)
                        break
                    except PagePoolExhausted:
                        # prefill rolled its partial allocations back;
                        # preempt the newest OTHER request and retry.
                        # With nothing left to preempt, the admission
                        # itself bounces back to the queue front (its
                        # prefix-hit discount was optimistic)
                        if not self._preempt_for_pages(
                                exclude_slot=active.slot):
                            self.batcher.preempt_slot(active.slot)
                            self.engine.note_preemption()
                            _REQUESTS.labels(outcome="preempted").inc()
                            break
                if token is None:
                    continue
                if not self._guard_ok(max_abs):
                    self._quarantine("non-finite prefill logits")
                    return
                active.generated.append(token)
                active.first_token_s = time.monotonic()
                active.prefill_s = time.time() - p0
                tracing.record(
                    "request.prefill", p0, active.prefill_s,
                    trace_id=req.trace_id, uid=req.uid,
                    slot=active.slot, prompt_len=active.prompt_len)
                # prefill is productive serve time too (tokens=0: the
                # preemption exchange rate stays a pure decode cost)
                goodput.record_serve_step(active.prefill_s)
                # open the first decode-block span
                active.block_t0 = p0 + active.prefill_s
                _TOKENS.labels(kind="prefill").inc(active.prompt_len)
                _LATENCY.labels(phase="ttft").observe(
                    active.first_token_s - active.request.submitted_s)
            for done in self.batcher.retire_done():  # max_new_tokens == 1
                if self.paged:
                    self.engine.release_slot(done.slot)
                self._finish(done, time.monotonic())

        slots, tokens, positions = self.batcher.batch_rows()
        if not slots:
            _OCCUPANCY.labels(replica=self.name).set(0)
            time.sleep(_IDLE_SLEEP_SECONDS)
            # goodput ledger: an empty loop iteration is queue-idle badput
            goodput.record_span("serve_queue_idle", _IDLE_SLEEP_SECONDS)
            return

        if self.paged:
            # grow tables across block boundaries / COW shared pages
            # BEFORE the step; exhaustion preempts newest-admitted until
            # the survivors fit (admission guarantees a sole request
            # always does)
            while True:
                try:
                    self.engine.prepare_step(slots, positions)
                    break
                except PagePoolExhausted:
                    if not self._preempt_for_pages():
                        raise   # nothing left to shed: quarantine path
                    slots, tokens, positions = self.batcher.batch_rows()
                    if not slots:
                        _OCCUPANCY.labels(replica=self.name).set(0)
                        return

        # the serving step counter: chaos kills aim at decode step N
        self.decode_iterations += 1
        fault_inject.maybe_inject(self.decode_iterations)
        t_decode0 = time.monotonic()
        ids, max_abs = self.engine.decode(slots, tokens, positions)
        # no short-circuit: the guard's EWMA/skip-budget state must see
        # EVERY slot's observation, not a prefix that stops at the
        # first failing slot
        verdicts = [self._guard_ok(m) for m in max_abs]
        if not all(verdicts):
            self._quarantine("non-finite decode logits")
            return
        by_slot = {a.slot: a for a in self.batcher.active()}
        for slot, token in zip(slots, ids):
            active = by_slot[slot]
            active.generated.append(token)
            active.position += 1
            active.block_steps += 1
            if active.block_steps >= self.policy.decode_block:
                # decode-block boundary: close this request's span and
                # open the next (one time.time() per block, not per step)
                t1 = time.time()
                tracing.record(
                    "request.decode_block", active.block_t0,
                    max(t1 - active.block_t0, 0.0),
                    trace_id=active.request.trace_id,
                    uid=active.request.uid, slot=slot,
                    block=active.blocks, tokens=active.block_steps)
                active.blocks += 1
                active.block_t0 = t1
                active.block_steps = 0
        occupancy = len(slots)
        self.occupancy_sum += occupancy
        if self.paged:
            self.page_used_sum += self.engine.pool.used_count()
        _TOKENS.labels(kind="decode").inc(occupancy)
        _OCCUPANCY.labels(replica=self.name).set(occupancy)
        _OCCUPANCY_HIST.observe(occupancy)
        self.batcher.note_step()
        now = time.monotonic()
        # goodput ledger: one decoded token per occupied slot is the
        # serve plane's productive unit; the step wall also refreshes the
        # EWMA per-token cost that prices preempted work
        goodput.record_serve_step(now - t_decode0, tokens=occupancy)
        for done in self.batcher.retire_done():
            if self.paged:
                self.engine.release_slot(done.slot)
            self._finish(done, now)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        steps = max(self.engine.decode_steps, 1)
        out = {"name": self.name, "rank": self.rank,
               "quarantined": self.quarantined,
               "completed": self.completed,
               "active": self.batcher.occupancy(),
               "waiting": self.batcher.waiting(),
               "decode_steps": self.engine.decode_steps,
               "avg_occupancy": round(self.occupancy_sum / steps, 3),
               # memory plane: resident KV bytes + the slot-occupancy-
               # weighted share of the cache that did useful work
               "kv_cache_bytes": self.engine.cache_bytes(),
               "kv_utilization": round(
                   self.occupancy_sum
                   / (steps * max(self.engine.num_slots, 1)), 3),
               "engine": self.engine.stats()}
        if self.paged:
            # pool view for /serve and hvd_top's pages row: live pool
            # stats plus the per-decode-step average occupancy
            out["pages"] = self.engine.page_stats()
            out["page_utilization"] = round(
                self.page_used_sum
                / (steps * max(self.engine.pool.allocatable, 1)), 3)
            out["prefix_hit_rate"] = self.engine.prefix_hit_rate()
            out["preemptions"] = self.engine.preemptions
        return out


def run_kv_replica(model, policy, rank: int, addr: str, port: int,
                   guard=None) -> Replica:
    """Blocking entrypoint for a cross-process replica (``python -m
    horovod_tpu_torch.serve`` workers): serve from the rendezvous KV
    queue until the frontend publishes the stop key."""
    from horovod_tpu_torch.run.rendezvous import KVStoreClient

    client = KVStoreClient(addr, port, scope="serve", timeout=10.0)
    if getattr(policy, "paged", False):
        from horovod_tpu_torch.serve.paging import PagedDecodeEngine

        engine = PagedDecodeEngine(
            model, num_slots=policy.slots, name=f"r{rank}",
            page_tokens=policy.page_tokens, pool_pages=policy.page_pool,
            prefix_entries=policy.prefix_cache)
    else:
        engine = DecodeEngine(model, num_slots=policy.slots,
                              name=f"r{rank}")
    # the transport's heartbeat thread starts beating here, BEFORE the
    # first (slow, capturing) decode can run — registration is not
    # gated on the serve loop being responsive
    transport = _KVTransport(KVQueueReplica(client, rank))
    replica = Replica(engine, transport, policy, rank=rank, guard=guard)
    try:
        replica.run()
    finally:
        # stop advertising liveness once we are no longer serving
        transport.shutdown()
    return replica
