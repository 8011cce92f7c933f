"""Controller: the coordination plane of per-tensor negotiation (port of
``horovod_tpu/runtime/controller.py``; reference:
horovod/common/controller.cc/.h, protocol at controller.h:62-96).

Every cycle each worker announces which named tensors it has enqueued; the
coordinator (rank 0) finds those ready on all workers, checks that their
metadata agree, and broadcasts the ordered response list that every worker
then executes identically. So callers may enqueue in different orders on
different workers and still run their collectives in one agreed order.

The transport verbs are abstract (reference: controller.h:34-124):

* ``LocalController``: one process, world 1. Negotiation is trivially
  satisfied; the cache and fusion run as in a larger world.
* ``GlooController`` (``gloo_controller.py``): one process per GPU, the
  verbs on a gloo process group, the reference's own Gloo controller
  design.

The coordinator's stall inspector and straggler tracker (``stall.py``)
read the message table's arrival times. So does the collective deadline
(``HOROVOD_COLLECTIVE_TIMEOUT``): a round announced by some ranks and
older than it ends the job with a generation-stamped ``WorkerStallError``
naming the ranks that never announced, kept on :attr:`Controller.failure`
(the runtime lifts it into every waiting handle) while the shutdown bit
takes every peer out of its loop in the same cycle. The stall inspector's
elastic verdict lands there too. The response cache and the bin-packing
run on the engine ``HOROVOD_NATIVE_CYCLE`` picks (the C++ one by default).
The flight recorder gets the JAX package's events: ``cache_invalidate``,
the coordinator's ``negotiate_begin``, ``rank_request`` and
``negotiate_end`` (with the arrival skew), and ``collective_timeout`` with
a failure dump.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch.runtime import fusion
from horovod_tpu_torch.runtime import message as msg
from horovod_tpu_torch.runtime import types
from horovod_tpu_torch.runtime.response_cache import (CacheCoordinator,
                                                      CacheState,
                                                      make_response_cache)
from horovod_tpu_torch.exceptions import WorkerStallError
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils import resilience


class MessageTable:
    """name -> requests received so far (reference: MessageTable +
    IncrementTensorCount, controller.cc:700-723)."""

    def __init__(self):
        self._table: Dict[str, List[msg.Request]] = {}
        # name -> monotonic time of the first announcement: the stall
        # inspector's age baseline (stall_inspector.cc stamps on
        # IncrementTensorCount, not on its own scan)
        self._first_request_time: Dict[str, float] = {}
        # name -> {rank: monotonic arrival time}: the straggler tracker's
        # input (resolution: one cycle)
        self._arrivals: Dict[str, Dict[int, float]] = {}

    def increment(self, request: msg.Request, world: int) -> bool:
        """Record one worker's announcement; True once every worker has
        announced the tensor."""
        now = time.monotonic()
        reqs = self._table.setdefault(request.tensor_name, [])
        if not reqs:
            self._first_request_time[request.tensor_name] = now
        self._arrivals.setdefault(request.tensor_name, {})[request.rank] = now
        reqs.append(request)
        return len(reqs) == world

    def pop(self, name: str) -> List[msg.Request]:
        self._first_request_time.pop(name, None)
        self._arrivals.pop(name, None)
        return self._table.pop(name, [])

    def arrivals(self, name: str) -> Dict[int, float]:
        """Each announcing rank's arrival time for ``name``."""
        return dict(self._arrivals.get(name, {}))

    def first_request_time(self, name: str) -> Optional[float]:
        return self._first_request_time.get(name)

    def pending(self) -> Dict[str, List[msg.Request]]:
        return self._table

    def __len__(self) -> int:
        return len(self._table)


def construct_response(requests: List[msg.Request]) -> msg.Response:
    """Check that every worker announced compatible metadata and build the
    verdict (reference: ConstructResponse, controller.cc:320-522): a dtype,
    shape, op or root mismatch across ranks becomes an ERROR response that
    raises on every worker."""
    first = requests[0]
    name = first.tensor_name

    for r in requests[1:]:
        if r.request_type != first.request_type:
            return msg.Response(
                types.ERROR, [name],
                f"Mismatched collective operations: one worker requested "
                f"{first.request_type.lower()}, another requested "
                f"{r.request_type.lower()}.")
        if r.dtype != first.dtype:
            return msg.Response(
                types.ERROR, [name],
                f"Mismatched data types: one worker sent {first.dtype}, "
                f"another sent {r.dtype}.")

    if first.request_type == types.ALLREDUCE:
        for r in requests[1:]:
            if r.shape != first.shape:
                return msg.Response(
                    types.ERROR, [name],
                    f"Mismatched allreduce tensor shapes: {first.shape} vs "
                    f"{r.shape}.")
            if r.reduce_op != first.reduce_op:
                return msg.Response(
                    types.ERROR, [name],
                    "Mismatched allreduce reduction ops across workers.")
        return msg.Response(types.ALLREDUCE, [name])

    if first.request_type == types.ALLGATHER:
        for r in requests[1:]:
            if len(r.shape) != len(first.shape) or r.shape[1:] != first.shape[1:]:
                return msg.Response(
                    types.ERROR, [name],
                    f"Mismatched allgather tensor shapes: all dimensions "
                    f"except the first must match ({first.shape} vs "
                    f"{r.shape}).")
        # per-rank first-dim sizes in rank order (controller.cc recvcounts)
        by_rank = sorted(requests, key=lambda r: r.rank)
        sizes = [r.shape[0] if r.shape else 1 for r in by_rank]
        return msg.Response(types.ALLGATHER, [name], tensor_sizes=sizes)

    if first.request_type == types.BROADCAST:
        for r in requests[1:]:
            if r.root_rank != first.root_rank:
                return msg.Response(
                    types.ERROR, [name],
                    f"Mismatched broadcast root ranks: {first.root_rank} vs "
                    f"{r.root_rank}.")
            if r.shape != first.shape:
                return msg.Response(
                    types.ERROR, [name],
                    f"Mismatched broadcast tensor shapes: {first.shape} vs "
                    f"{r.shape}.")
        return msg.Response(types.BROADCAST, [name])

    if first.request_type == types.REDUCESCATTER:
        world = len(requests)
        for r in requests[1:]:
            if r.shape != first.shape:
                return msg.Response(
                    types.ERROR, [name],
                    f"Mismatched reducescatter tensor shapes: "
                    f"{first.shape} vs {r.shape}.")
            if r.reduce_op != first.reduce_op:
                return msg.Response(
                    types.ERROR, [name],
                    "Mismatched reducescatter reduction ops across "
                    "workers.")
        if not first.shape or first.shape[0] % world != 0:
            return msg.Response(
                types.ERROR, [name],
                f"reducescatter dim 0 ({first.shape[0] if first.shape else 0}) "
                f"must divide evenly by the world size ({world}).")
        return msg.Response(types.REDUCESCATTER, [name])

    if first.request_type == types.ALLTOALL:
        world = len(requests)
        for r in requests[1:]:
            if r.shape != first.shape:
                return msg.Response(
                    types.ERROR, [name],
                    f"Mismatched alltoall tensor shapes: {first.shape} vs "
                    f"{r.shape} (equal splits require identical shapes).")
        if not first.shape or first.shape[0] % world != 0:
            return msg.Response(
                types.ERROR, [name],
                f"alltoall dim 0 ({first.shape[0] if first.shape else 0}) "
                f"must divide evenly by the world size ({world}).")
        return msg.Response(types.ALLTOALL, [name])

    return msg.Response(types.ERROR, [name],
                        f"Unknown request type {first.request_type}.")


class Controller:
    """Negotiation over abstract transport verbs."""

    # deferred cache hits older than this are invalidated and renegotiated
    # (reference: stalled cached tensors re-enter negotiation,
    # stall_inspector.cc:112+); the runtime sets it to the stall warning time
    STALE_HIT_SECONDS = 60.0

    def __init__(self, rank: int, world: int, cache_capacity: int = 1024,
                 native_engine: Optional[bool] = None):
        self.rank = rank
        self.world = world
        # the engine of the cache and the bin-packing (default:
        # HOROVOD_NATIVE_CYCLE); the native one raises here if its library
        # cannot be built
        self.native_engine = (env.native_cycle() if native_engine is None
                              else native_engine)
        self.cache = make_response_cache(cache_capacity, self.native_engine)
        self.cache_enabled = cache_capacity > 0
        self.message_table = MessageTable()  # coordinator only
        self._should_shut_down = False
        # name -> Request of every announcement not yet resolved on this
        # worker (fusion's byte counts and cache puts when the agreement
        # lands in a later cycle than the announcement)
        self._pending: Dict[str, msg.Request] = {}
        # uncached names already at the coordinator: never re-sent
        # (IncrementTensorCount would count this rank twice)
        self._awaiting: set = set()
        # cache hits not yet common to all workers: re-announced every cycle
        # until the agreement lands; name -> first announcement time
        self._deferred_first_seen: Dict[str, float] = {}
        # synchronized invalidation notices for the next slow path
        self._invalidate_queue: List[str] = []
        # the coordinator's straggler attribution (stall.StragglerTracker),
        # attached by the runtime; None on workers
        self.straggler = None
        # the typed verdict of a shutdown this controller provoked (a
        # WorkerStallError of the stall inspector or the deadline), which
        # the runtime lifts into the handles
        self.failure: Optional[Exception] = None
        # the deadline on negotiation rounds in flight (0: none)
        self.collective_timeout = resilience.collective_timeout()

    # -- transport verbs (reference: controller.h:98-124) ------------------
    def sync_bitvectors(self, bits: int) -> Tuple[int, int]:
        """(AND-reduced, OR-reduced) bitvectors across workers (reference:
        CrossRankBitwiseAnd/Or)."""
        raise NotImplementedError

    def send_ready_tensors(self, requests: List[msg.Request]
                           ) -> Optional[List[List[msg.Request]]]:
        """Workers send their ready lists; the coordinator gets every
        worker's list (reference: RecvReadyTensors / SendReadyTensors)."""
        raise NotImplementedError

    def bcast_responses(self, responses: Optional[List[msg.Response]]
                        ) -> List[msg.Response]:
        """The coordinator broadcasts the final list; workers receive it
        (reference: SendFinalTensors / RecvFinalTensors)."""
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError

    def bcast_blob(self, blob: Optional[bytes]) -> bytes:
        """The coordinator broadcasts an opaque blob; workers receive it
        (reference: SynchronizeParameters, controller.cc:32-46)."""
        raise NotImplementedError

    def allgather_blob(self, blob: bytes) -> List[bytes]:
        """Every rank's ``blob`` (all of one length), in rank order, on
        every rank: the integrity digests' record exchange."""
        raise NotImplementedError

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def lockstep(self) -> bool:
        """True where every cycle must meet the other workers' cycles, even
        with nothing queued (reference: RunLoopOnce runs
        ComputeResponseList unconditionally, operations.cc:500-550)."""
        return self.world > 1

    def request_shutdown(self) -> None:
        self._should_shut_down = True

    # -- the cycle (reference: ComputeResponseList, controller.cc:54-298) --
    def compute_response_list(
        self, requests: List[msg.Request], fusion_threshold: int,
        timeline=None, stall_inspector=None,
    ) -> Tuple[List[msg.Response], bool]:
        """Returns (responses to execute, should shut down).

        Cache puts and invalidations happen only through the agreed list,
        in its order, so every worker applies the same sequence and the
        cache bits stay aligned across workers, which the bitvector fast
        path depends on (reference: response_cache.cc:232+)."""
        now = time.monotonic()
        coordinator = CacheCoordinator()
        uncached_to_send: List[msg.Request] = []

        for r in requests:
            name = r.tensor_name
            self._pending[name] = r
            if name in self._awaiting:
                continue  # already at the coordinator
            state = (self.cache.cached(r) if self.cache_enabled
                     else CacheState.MISS)
            stale = (state == CacheState.HIT and
                     now - self._deferred_first_seen.get(name, now)
                     > self.STALE_HIT_SECONDS)
            if state == CacheState.HIT and not stale:
                coordinator.record_hit(self.cache.bit_for_name(name))
                if name not in self._deferred_first_seen:
                    types.COUNTS["cache_hits"] += 1
                self._deferred_first_seen.setdefault(name, now)
            else:
                if state in (CacheState.INVALID, CacheState.HIT):
                    # params changed, or the hit went stale waiting for the
                    # other workers: synchronized invalidation, renegotiate
                    self._invalidate_queue.append(name)
                    coordinator.set_invalid_in_queue()
                    self._deferred_first_seen.pop(name, None)
                    flight_recorder.emit("cache_invalidate", name=name,
                                         stale=stale)
                coordinator.set_uncached_in_queue()
                uncached_to_send.append(r)

        if self._should_shut_down:
            coordinator.set_should_shut_down()

        anded, ored = self.sync_bitvectors(coordinator.bitvector)
        shut_down, any_uncached, any_invalid = CacheCoordinator.flags(ored)

        # the stall scan runs on the coordinator every cycle: a stalled
        # tensor sits in the message table while later cycles take the
        # fast path (reference: controller.cc:98-107)
        if self.is_coordinator and stall_inspector is not None \
                and len(self.message_table):
            try:
                if stall_inspector.check(self.message_table,
                                         world=self.world,
                                         straggler=self.straggler):
                    self.request_shutdown()
            except WorkerStallError as stall_exc:
                # keep the typed reason, and still send the shutdown bit,
                # so every peer leaves its loop in the same cycle
                if self.failure is None:
                    self.failure = stall_exc
                self.request_shutdown()

        # the deadline on negotiation rounds: catches a rank that stopped
        # announcing (a hang, a partition) and names it
        if (self.is_coordinator and self.collective_timeout > 0
                and self.failure is None and len(self.message_table)):
            self._check_collective_deadline(now)

        common_bits = sorted(CacheCoordinator.common_hits(anded))
        cached_responses: List[msg.Response] = []
        for bit in common_bits:
            resp = self.cache.get_by_bit(bit)
            if resp is not None:
                cached_responses.append(resp)

        if not any_uncached and not any_invalid:
            # fast path (reference: controller.cc:151-179): everything
            # queued everywhere is cached, no gather or broadcast
            agreed = cached_responses
        else:
            notices = [
                msg.Request(self.rank, types.INVALIDATE, n, "", ())
                for n in dict.fromkeys(self._invalidate_queue)
            ]
            gathered = self.send_ready_tensors(notices + uncached_to_send)
            self._awaiting.update(r.tensor_name for r in uncached_to_send)
            self._invalidate_queue.clear()

            final: Optional[List[msg.Response]] = None
            if self.is_coordinator:
                invalidate_names: List[str] = []
                ready_names: List[str] = []
                for worker_requests in gathered:
                    for r in worker_requests:
                        if r.request_type == types.INVALIDATE:
                            if r.tensor_name not in invalidate_names:
                                invalidate_names.append(r.tensor_name)
                            continue
                        fresh = (r.tensor_name
                                 not in self.message_table.pending())
                        if timeline is not None:
                            if fresh:
                                timeline.negotiate_start(r.tensor_name,
                                                         r.request_type)
                            timeline.negotiate_rank_ready(r.tensor_name,
                                                          r.rank)
                        if fresh:
                            flight_recorder.emit("negotiate_begin",
                                                 name=r.tensor_name,
                                                 type=r.request_type)
                        flight_recorder.emit("rank_request",
                                             name=r.tensor_name, rank=r.rank)
                        if self.message_table.increment(r, self.world):
                            ready_names.append(r.tensor_name)
                negotiated: List[msg.Response] = []
                for name in ready_names:
                    arrivals = self.message_table.arrivals(name)
                    if self.straggler is not None and arrivals:
                        self.straggler.observe(name, arrivals)
                    skew = (round(max(arrivals.values())
                                  - min(arrivals.values()), 6)
                            if arrivals else 0.0)
                    reqs = self.message_table.pop(name)
                    if timeline is not None:
                        timeline.negotiate_end(name)
                    flight_recorder.emit("negotiate_end", name=name,
                                         skew=skew)
                    negotiated.append(construct_response(reqs))
                final = []
                if invalidate_names:
                    final.append(msg.Response(types.INVALIDATE,
                                              invalidate_names))
                final += cached_responses + negotiated

            agreed = self.bcast_responses(final)

        # apply the agreed list: invalidations first (the same order on
        # every worker keeps the free-bit pools aligned), then cache puts
        # for newly negotiated responses
        executable: List[msg.Response] = []
        for resp in agreed:
            if resp.response_type == types.INVALIDATE:
                for name in resp.tensor_names:
                    self.cache.invalidate(name)
                continue
            if resp.response_type != types.ERROR and self.cache_enabled:
                for name in resp.tensor_names:
                    req = self._pending.get(name)
                    if req is not None \
                            and self.cache.cached(req) != CacheState.HIT:
                        self.cache.put(
                            msg.Response(resp.response_type, [name],
                                         tensor_sizes=resp.tensor_sizes),
                            req)
            executable.append(resp)

        fused = fusion.fuse_responses(executable, self._pending,
                                      fusion_threshold, self.native_engine)

        for resp in fused:
            for name in resp.tensor_names:
                self._pending.pop(name, None)
                self._awaiting.discard(name)
                self._deferred_first_seen.pop(name, None)
        return fused, shut_down

    def _check_collective_deadline(self, now: float) -> None:
        """Any tensor whose first announcement is older than
        ``HOROVOD_COLLECTIVE_TIMEOUT`` ends the cycle: a
        generation-stamped :class:`WorkerStallError` naming the ranks that
        never announced goes on :attr:`failure`, and the shutdown bit goes
        out (``horovod_tpu/runtime/controller.py:446-480``)."""
        overdue: List[str] = []
        missing: set = set()
        for name, reqs in self.message_table.pending().items():
            first = self.message_table.first_request_time(name)
            if first is None or now - first < self.collective_timeout:
                continue
            overdue.append(name)
            missing.update(set(range(self.world)) - {r.rank for r in reqs})
        if not overdue:
            return
        gen = resilience.current_generation()
        ranks = sorted(missing)
        exc = WorkerStallError(
            f"collective timeout: {len(overdue)} negotiate round(s) "
            f"(first: {overdue[0]!r}) exceeded "
            f"HOROVOD_COLLECTIVE_TIMEOUT={self.collective_timeout:g}s in "
            f"generation {gen}; ranks never announced: {ranks}",
            ranks=ranks)
        log.error("%s", exc)
        flight_recorder.emit("collective_timeout", tensors=len(overdue),
                             missing=ranks, generation=gen)
        flight_recorder.dump_on_failure("collective_timeout")
        self.failure = exc
        self.request_shutdown()

    def take_deferred(self) -> List[msg.Request]:
        """Requests still unresolved on this worker that must be announced
        again this cycle: cache hits waiting for the other workers (not the
        uncached ones already at the coordinator)."""
        return [self._pending[n] for n in self._deferred_first_seen
                if n in self._pending]


class LocalController(Controller):
    """World 1: every enqueued tensor is ready on all workers; the verbs
    are identities, and the cache and fusion run as in a larger world."""

    def sync_bitvectors(self, bits: int) -> Tuple[int, int]:
        return bits, bits

    def send_ready_tensors(self, requests):
        return [requests]

    def bcast_responses(self, responses):
        return responses

    def bcast_blob(self, blob):
        return blob

    def allgather_blob(self, blob):
        return [blob]

    def barrier(self) -> None:
        pass
