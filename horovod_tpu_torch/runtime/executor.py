"""Data-plane execution of negotiated (fused) responses (port of
``horovod_tpu/runtime/executor.py``; reference:
horovod/common/operations.cc:211-279, ops/collective_operations.cc).

A fused ALLREDUCE response becomes one ``dist.all_reduce`` over a slab of
the fusion buffer: the bin's tensors are packed with one ``torch.cat``
into ``slab[:total]``, reduced, and copied back out to each entry's output.
Unlike the JAX package, the payload is not padded to its bucket: NCCL
compiles nothing, so pad bytes would only be wire traffic. Broadcast,
allgather and reduce-scatter run one call an entry, as the reference never
fuses them. Every collective goes to the runtime's data group, and only
the runtime's thread issues on it.

An allgather whose ranks' dim 0 differ (the negotiated response's
``tensor_sizes``, one a rank) runs as an equal one padded to the largest
part: ``all_gather`` needs equal parts on NCCL and gloo, so each rank
copies its part into a zeroed buffer of the largest size, gathers those,
and the parts are copied out of the result, in rank order, into the
output. The padding is wire traffic only; the result is exact. Alltoall
is one ``all_to_all_single`` of equal chunks an entry.

On the card everything runs on the runtime's comm stream: it waits for
each input's producer stream (the caller's current stream at enqueue, as
it stands at dispatch), packs, issues the collective with itself current
(ProcessGroupNCCL orders its stream after it), unpacks, and records the
``done`` event that the caller's stream waits on. The host never blocks
on the device here.

The data plane is pipelined: ``dispatch`` packs and launches, returning a
``_PendingOp``; ``_PendingOp.complete`` queues the wait, the average and
the unpack, then fires the entries' callbacks. The cycle dispatches up to
``HOROVOD_CYCLE_PIPELINE_DEPTH`` responses before draining the oldest, so
the pack of bin k+1 is queued before bin k's unpack. A slab's lease goes
back to the pool when its unpack is queued: every later use of the slab
is on the same stream, so it is ordered after that unpack.

Each response's host time from dispatch to completion, its bytes, its
errors and the part of its time not hidden behind later dispatches are
metrics (``horovod_executor_op_*`` by op, ``horovod_comm_exposed_seconds_
total``) and the comm clock the step profiler diffs (:func:`comm_totals`);
on the card these are the host's times of queueing the work, not the
device's.

The integrity digests (``integrity/digest.py``, under ``HOROVOD_INTEGRITY``)
ride every ``HOROVOD_INTEGRITY_INTERVAL``-th eligible dispatch, counted
alike on every rank since the dispatch order is negotiated: an allreduce
counts its packed input's non-finite elements on the comm stream before
the collective and, at the drain, takes CRC-32 of the reduced bytes; a
reduce-scatter counts its inputs' (its shards differ by rank: no CRC). The
drain, on the cycle thread, gathers one 12-byte record a rank on the gloo
control group and raises the vote's verdict before anything is unpacked:
a ``NumericalError`` goes to :attr:`Executor.integrity_failure`, which the
waiting handle lifts. The ``nan`` and ``bitflip`` faults of
``integrity/inject.py`` fire here. A collective that fails because a peer
went away records a ``WorkerLostError`` on :attr:`Executor.failure`.

The observability planes: each dispatch, completion and failure is a
flight-recorder event (``op_dispatch``, ``op_complete``, ``op_fail``) and a
failure that is an OOM becomes the memory ledger's record
(``memory.maybe_record_oom``). Each collective is a record of the comms
observatory's ``device`` lane, once: on the CPU with its host time from
dispatch to completion, as in the JAX package; on the card with the
device's time, from an ``enable_timing`` CUDA event pair recorded on the
comm stream before the collective's call and after its ``wait``
(``comms.stamp``; a collective queued behind the previous one is timed
from that one's end, ``comms.span``). The pair rides the bin's held entry
and is read when the device has passed the bin's ``done`` event: in
``_mark_done``'s sweep of the held queue, or at ``close``. The cycle
thread never synchronizes for it, and with ``HOROVOD_COMMS=0`` no timing
event is recorded.

The two-level collectives (``runtime/hierarchy.py``): with
``HOROVOD_HIERARCHICAL_ALLREDUCE`` a fused allreduce runs as the intra
reduce-scatter, the cross allreduce of 1/g of the slab (in the wire dtype
of ``HOROVOD_HIERARCHY_COMPRESSION``) and the intra allgather, its slab
padded to a multiple of g (wire traffic only, zeroed), and a
reduce-scatter as the two-level one; with ``HOROVOD_HIERARCHICAL_
ALLGATHER`` an equal allgather runs as the intra then the cross
allgather. The plan and its groups are built at the first such dispatch
(every rank reaches it at the same point of the negotiated order) and
memoised on (world, rank, group size, generation); a plan that resolves
flat, a ragged allgather and a reduce-scatter whose size is not a multiple
of the world run the flat call, each with a warning once. Under
integrity digests the non-finite count is taken before compression and the
CRC after assembly. Each flat collective passes the chaos seam
(``resilience.inject("ring", ..., crossings=...)``, the flat ring's
crossings of the slow link), each hop its own.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch import comms
from horovod_tpu_torch import exceptions
from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch import integrity
from horovod_tpu_torch import memory
from horovod_tpu_torch import timeline as timeline_mod
from horovod_tpu_torch import tracing
from horovod_tpu_torch.integrity import digest as integ_digest
from horovod_tpu_torch.integrity import inject as integ_inject
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.runtime import hierarchy
from horovod_tpu_torch.runtime import types
from horovod_tpu_torch.runtime.fusion_buffer import FusionBufferManager
from horovod_tpu_torch.runtime.gloo_controller import lost_worker
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils import resilience

_OP_LATENCY = _metrics().histogram(
    "horovod_executor_op_duration_seconds",
    "Wall time executing one (possibly fused) response, per op type.",
    labelnames=("op",))
_OP_BYTES = _metrics().counter(
    "horovod_executor_op_bytes_total",
    "Per-worker payload bytes executed, per op type.", labelnames=("op",))
_OP_ERRORS = _metrics().counter(
    "horovod_executor_op_errors_total",
    "Responses that completed with an error status, per op type.",
    labelnames=("op",))
_COMM_EXPOSED = _metrics().counter(
    "horovod_comm_exposed_seconds_total",
    "Collective wall time NOT hidden behind other in-flight work: dispatch "
    "busy time plus drain (device sync + unpack) time, summed across ops. "
    "Compare against the horovod_executor_op_duration_seconds sum for the "
    "comm-hidden fraction.")



class _CommClock:
    """Cumulative comm-exposure accounting that the step profiler
    (``profiler.py``) diffs at step boundaries. Per completed op the
    lifetime splits into dispatch-busy (pack + launch), an overlap window
    (the token parked in the pipeline while later responses dispatch, the
    only part hidden from the caller) and drain-busy (the wait and the
    unpack). Plain float adds under the GIL, as in the metrics registry."""

    __slots__ = ("total_seconds", "exposed_seconds", "total_bytes",
                 "hidden_bytes", "ops")

    def __init__(self) -> None:
        self.total_seconds = 0.0
        self.exposed_seconds = 0.0
        self.total_bytes = 0
        self.hidden_bytes = 0.0
        self.ops = 0

    def record(self, total: float, exposed: float, nbytes: int) -> None:
        """One completed op; moves ``horovod_comm_exposed_seconds_total``
        by the same ``exposed``."""
        self.total_seconds += total
        self.exposed_seconds += exposed
        self.total_bytes += nbytes
        self.ops += 1
        if total > 0.0:
            self.hidden_bytes += nbytes * (1.0 - exposed / total)
        _COMM_EXPOSED.inc(exposed)


_comm_clock = _CommClock()


def comm_totals() -> dict:
    """Snapshot of the cumulative comm-exposure accumulators (the step
    profiler diffs two of these to attribute one step's collectives)."""
    c = _comm_clock
    return {"total_seconds": c.total_seconds,
            "exposed_seconds": c.exposed_seconds,
            "total_bytes": c.total_bytes,
            "hidden_bytes": c.hidden_bytes,
            "ops": c.ops}


_TORCH_OPS = {types.REDUCE_SUM: dist.ReduceOp.SUM,
              types.REDUCE_AVERAGE: dist.ReduceOp.SUM,
              types.REDUCE_MIN: dist.ReduceOp.MIN,
              types.REDUCE_MAX: dist.ReduceOp.MAX,
              types.REDUCE_PRODUCT: dist.ReduceOp.PRODUCT}

# the one-tensor reduce-scatter and allgather of this torch release
_reduce_scatter_one = hierarchy._reduce_scatter_one
_all_gather_one = hierarchy._all_gather_one


def _average_(out: torch.Tensor, world: int) -> None:
    """A SUM turned into the Average, in place: ``div_`` by the world for
    floats (the bits of a mean over the ranks), division rounded toward
    zero for integers, as the reference divides and casts back
    (``horovod_tpu/runtime/executor.py:927-949, 1146-1148``,
    ``horovod_tpu/torch/mpi_ops.py:65-75``): a sum of -5 over 2 ranks
    averages to -2."""
    if out.is_floating_point():
        out.div_(world)
    else:
        torch.div(out, world, rounding_mode="trunc", out=out)


_done_seq = itertools.count()


class Done(NamedTuple):
    """A bin's result on the card: ``event`` recorded on ``executor``'s
    comm stream after the unpack, ``seq`` its place in that stream's order.
    A later event of the same stream covers it: a caller waits on
    ``executor.latest`` and skips any handle whose ``seq`` its stream has
    already waited past, so the gradients of a step cost a few stream
    waits, not one each (``RuntimeHandle.wait``)."""

    seq: int
    event: torch.cuda.Event
    executor: "Executor"


class _PendingOp:
    """Completion token of one dispatched response.

    ``finish`` is the tail that ``complete`` runs (the wait, average and
    unpack), None when dispatch already finished or failed. ``complete``
    fires every entry's callback once and releases the slab's lease on
    success and failure alike. Tokens complete in dispatch order."""

    __slots__ = ("executor", "op", "entries", "timeline", "name0", "finish",
                 "done", "lease", "nbytes", "t0", "t_disp_end",
                 "t_drain_start", "lane")

    def __init__(self, executor: "Executor", op: str, entries, timeline):
        self.executor = executor
        self.op = op
        self.entries = entries
        self.timeline = timeline
        self.name0 = entries[0].name if entries else "?"
        self.finish: Optional[Callable[[], None]] = None
        self.done = False
        self.lease = None
        self.nbytes = sum(types.entry_nbytes(e) for e in entries)
        # dispatch start, dispatch end and drain start: the gap between the
        # last two is the time the op's work stood queued behind later
        # dispatches, hidden from the caller
        self.t0 = time.perf_counter()
        self.t_disp_end: Optional[float] = None
        self.t_drain_start: Optional[float] = None
        # the comms lane of the bytes this op moved; on the card its
        # seconds come from the comm stream's events, not the host's
        # interval
        self.lane: Optional[str] = None

    def _close(self) -> None:
        self.done = True
        if self.lease is not None:
            self.executor.fusion_buffers.release(self.lease)
            self.lease = None
        t_end = time.perf_counter()
        total = t_end - self.t0
        _OP_LATENCY.labels(op=self.op).observe(total)
        disp_end = min(self.t_disp_end or t_end, t_end)
        drain_start = min(self.t_drain_start or t_end, t_end)
        _comm_clock.record(total,
                           max(0.0, total - max(0.0, drain_start - disp_end)),
                           self.nbytes)
        if self.lane is not None and self.executor.stream is None:
            # gloo: the host interval is the collective's
            comms.record(self.op, self.lane, self.nbytes, total,
                         world=self.executor.world)
        if tracing.enabled():
            # the response's dispatch -> overlap -> drain lineage on the
            # request spans' clock, so an exposed-comm spike names its
            # tensor (horovod_tpu/runtime/executor.py:249-259)
            tracing.record(
                "collective:" + str(self.name0),
                time.time() - total, total, op=self.op, bytes=self.nbytes,
                dispatch_ms=round((disp_end - self.t0) * 1000.0, 3),
                overlap_ms=round(max(0.0, drain_start - disp_end)
                                 * 1000.0, 3),
                drain_ms=round(max(t_end - drain_start, 0.0) * 1000.0, 3))
        if self.timeline is not None:
            self.timeline.end(self.name0)

    def fail_exc(self, exc: Exception) -> None:
        """Fail every entry for ``exc``, keeping its typed reason on the
        executor first: an integrity verdict (which the runtime survives)
        or the loss of a peer (which takes it down)."""
        ex = self.executor
        # an OOM at dispatch or at the drain becomes the ledger's record
        memory.maybe_record_oom(exc, where="executor")
        if isinstance(exc, exceptions.NumericalError):
            if ex.integrity_failure is None:
                ex.integrity_failure = exc
        elif ex.world > 1 and ex.failure is None:
            ex.failure = lost_worker(exc)
        self.fail(types.Status.UnknownError(f"{type(exc).__name__}: {exc}"))

    def fail(self, status: types.Status) -> None:
        """Complete every entry with an error (reference: ErrorOp,
        collective_operations.cc:202-205). Idempotent."""
        if self.done:
            return
        if self.t_drain_start is None:
            self.t_drain_start = time.perf_counter()
        _OP_ERRORS.labels(op=self.op).inc()
        flight_recorder.emit("op_fail", op=self.op, name=self.name0,
                             bytes=self.nbytes, bucket=None,
                             error=str(status.reason)[:200])
        for e in self.entries:
            e.complete(status, None)
        self._close()

    def complete(self) -> None:
        if self.done:
            return
        if self.t_drain_start is None:
            self.t_drain_start = time.perf_counter()
        try:
            if self.finish is not None:
                self.finish()
        except Exception as exc:  # a failure becomes the entries' status
            self.fail_exc(exc)
            return
        _OP_BYTES.labels(op=self.op).inc(self.nbytes)
        flight_recorder.emit(
            "op_complete", op=self.op, name=self.name0, bytes=self.nbytes,
            bucket=None, seconds=round(time.perf_counter() - self.t0, 6))
        ok = types.Status.OK()
        for e in self.entries:
            e.complete(ok, e.output)
        self._close()


class Executor:
    """Runs each response on the data group ``group`` of ``world`` ranks,
    on the card from the comm stream ``stream``, which the runtime's thread
    keeps as its current stream."""

    def __init__(self, device: torch.device, group, world: int,
                 fusion_threshold: int, quantum_bytes: int, depth: int,
                 config: Optional[env.Config] = None):
        self.device = device
        # the runtime's knobs: the hierarchy's, which the autotuner writes
        self.config = env.Config() if config is None else config
        self.group = group
        self.world = world
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.backend = "NCCL" if device.type == "cuda" else "GLOO"
        self.fusion_buffers = FusionBufferManager(
            quantum_bytes, fusion_threshold, depth)
        self._held: "collections.deque" = collections.deque()
        self.latest: Optional["Done"] = None
        # a data-plane loss (WorkerLostError); the runtime lifts it
        self.failure: Optional[Exception] = None
        # the digests' verdict (NumericalError); the waiting handle lifts
        # and clears it, so the runtime survives the rollback
        self.integrity_failure: Optional[Exception] = None
        # eligible dispatches seen: the digest cadence (the same on every
        # rank, since the dispatch order is negotiated)
        self._integrity_dispatches = 0
        #: digest checks run and the cycle thread's seconds in them
        self.digest_checks = 0
        self.digest_seconds = 0.0
        # the end stamp of the last timed collective on the comm stream
        self._last_end: Optional[comms.Stamp] = None
        # the memoised two-level plan, its groups and its key
        self._hier_key = None
        self._hier: Optional[hierarchy.HierarchyGroups] = None
        self._warned: set = set()

    # -- the two-level collectives (horovod_tpu/runtime/executor.py:509-585)
    def hierarchical_available(self) -> bool:
        """Whether a hierarchy can form: an explicit group size must tile
        the world into >= 2 groups of >= 2; with host-derived grouping any
        world >= 4 could split (a plan that resolves flat is a no-op).
        Static: no wire traffic."""
        w = self.world
        if w < 4:
            return False
        g = self._hier_group_size()
        return g == 0 or (g >= 2 and w % g == 0 and w // g >= 2)

    def _hier_group_size(self) -> int:
        """``HOROVOD_HIERARCHY_GROUP_SIZE`` (0: from the hosts' names), as
        the autotuner last wrote it."""
        return int(self.config.hierarchy_group_size or 0)

    def _hierarchy_plan(self, controller, knob: bool):
        """The groups of the memoised plan when ``knob`` (the op's
        hierarchical switch) is on and the plan is enabled, else None. The
        plan is built where every rank builds it, at the same point of the
        negotiated order; a new generation (an elastic re-form) or group
        size builds a new one, destroying the old groups."""
        if not knob or self.world < 2:
            return None
        gsize = self._hier_group_size()
        key = (self.world, controller.rank, gsize,
               resilience.current_generation())
        if self._hier_key != key:
            self.drop_hierarchy()
            plan = hierarchy.build_plan(controller, gsize)
            self._hier_key = key
            if plan.enabled:
                self._hier = hierarchy.HierarchyGroups(
                    plan, "nccl" if self.stream is not None else "gloo",
                    warm=self.device)
                flight_recorder.emit(
                    "hierarchy_plan", groups=plan.num_groups,
                    group_size=plan.group_size, source=plan.source,
                    world=plan.world)
                log.debug("hierarchy: %s", plan.describe())
            else:
                self._warn_once("flat", "hierarchy: world %d with group "
                                "size %d resolves flat; the flat "
                                "collectives run", self.world, gsize)
        return self._hier

    def _hier_wire_dtype(self):
        """The cross hop's wire dtype (None: full precision) from
        ``HOROVOD_HIERARCHY_COMPRESSION``; an unknown name raises."""
        return hierarchy.wire_dtype_from_name(
            self.config.hierarchy_compression)

    def _warn_once(self, what: str, msg: str, *args) -> None:
        if what not in self._warned:
            self._warned.add(what)
            log.warning(msg, *args)

    def drop_hierarchy(self, abort: bool = False) -> None:
        """Destroy the plan's groups (``abort``: abort them, after a lost
        peer on the card) and forget the plan."""
        h, self._hier, self._hier_key = self._hier, None, None
        if h is not None:
            if not abort and self.stream is not None:
                # no communicator goes while a hop of it is still queued
                self.stream.synchronize()
            h.destroy(abort=abort)

    def _stamp(self) -> Optional[comms.Stamp]:
        """A timing stamp on the comm stream now; None on the CPU or with
        the comms plane off."""
        if self.stream is None:
            return None
        return comms.stamp(self.stream)

    def _timing(self, pend: "_PendingOp", start):
        """After the collective's wait on the comm stream: its timing for
        the held entry, (op, bytes, span), or None when ``start`` is."""
        if start is None:
            return None
        end = self._stamp()
        if end is None:
            return None
        after, self._last_end = self._last_end, end
        return pend.op, pend.nbytes, comms.span(start, end, after)

    def _record_timing(self, timing) -> None:
        """A held bin's collective, passed by the device, into the comms
        observatory with the device's seconds."""
        if timing is None:
            return
        op, nbytes, s = timing
        comms.record(op, "device", nbytes, comms.span_seconds(s),
                     world=self.world)

    def _integrity_due(self) -> bool:
        """Advance the digest cadence by one eligible dispatch; True on the
        first and every ``HOROVOD_INTEGRITY_INTERVAL``-th."""
        if not integrity.enabled():
            return False
        iv = integrity.interval()
        if iv <= 0:
            return False
        n = self._integrity_dispatches
        self._integrity_dispatches = n + 1
        return n % iv == 0

    def _verify(self, controller, nf_dev, crc: int, bucket: str,
                tensor: str, t0: float) -> None:
        """Gather the records on the control group and raise the verdict
        (on the cycle thread, at the drain)."""
        try:
            records = integ_digest.exchange(controller, int(nf_dev), crc)
            integ_digest.verify(records, bucket=bucket, tensor=tensor)
        finally:
            self.digest_checks += 1
            self.digest_seconds += time.perf_counter() - t0

    def _order_after_inputs(self, entries) -> None:
        """The comm stream waits for each producer stream of the bin: for
        everything queued on it so far, which includes each input's
        producer (the hooks record no event of their own, see
        ``Runtime._entry``)."""
        if self.stream is None:
            return
        producers = {e.ready.cuda_stream: e.ready for e in entries
                     if e.ready is not None}
        for producer in producers.values():
            self.stream.wait_stream(producer)

    def _mark_done(self, entries, timing=None, works=None) -> None:
        """Record the bin's ``done`` event, numbered in the comm stream's
        order (see ``Done``). Until the device has passed it, the executor
        holds the bin's tensors and its works (a two-level chain holds its
        hops' temporaries), so the allocator cannot hand their memory to
        another stream while the comm stream still uses it (one reference
        a bin in place of ``record_stream`` a tensor). A bin's collective
        timing rides its entry and is recorded as it leaves."""
        if self.stream is None:
            return
        event = torch.cuda.Event()
        event.record(self.stream)
        self.latest = done = Done(next(_done_seq), event, self)
        for e in entries:
            e.done = done
        self._held.append((event, ([(e.tensor, e.output) for e in entries],
                                   works), timing))
        while self._held and self._held[0][0].query():
            self._record_timing(self._held.popleft()[2])

    def close(self, wait: bool = True) -> None:
        """Wait for the comm stream's work, then drop the held tensors.
        ``wait=False`` (after a failure: a collective a dead peer never
        joins may sit on the stream) keeps them held: the group's abort at
        shutdown ends that collective, and the executor's last reference
        goes with the runtime."""
        if not wait:
            return
        if self.stream is not None:
            self.stream.synchronize()
        for _event, _tensors, timing in self._held:
            self._record_timing(timing)
        self._held.clear()

    def dispatch(self, response, entries: List[types.TensorTableEntry],
                 timeline=None, controller=None) -> _PendingOp:
        """Launch one (fused) response and return its pending token
        (reference: PerformOperation, operations.cc:211-279: statuses go
        through the entries' callbacks, an ERROR response fails them all)."""
        pend = _PendingOp(self, response.response_type, entries, timeline)
        flight_recorder.emit("op_dispatch", op=pend.op, name=pend.name0,
                             tensors=len(entries), bytes=pend.nbytes)
        try:
            if timeline is not None:
                timeline.start(pend.name0, response.response_type)
            kind = response.response_type
            if kind == types.ERROR:
                pend.fail(
                    types.Status.PreconditionError(response.error_message))
                return pend
            self._order_after_inputs(entries)
            pend.lane = "device"
            if kind == types.ALLREDUCE:
                pend.finish = self._dispatch_allreduce(entries, timeline,
                                                       pend, controller)
            elif kind in (types.BROADCAST, types.ALLGATHER,
                          types.REDUCESCATTER, types.ALLTOALL):
                pend.finish = self._dispatch_each(
                    kind, entries, timeline, pend,
                    response.tensor_sizes, controller)
            else:
                raise ValueError(f"response type {kind} is not ported")
        except Exception as exc:
            pend.fail_exc(exc)
        if pend.t_disp_end is None:
            pend.t_disp_end = time.perf_counter()
        return pend

    def _dispatch_allreduce(self, entries, timeline, pend, controller=None):
        """Pack the bin into a leased slab, one collective over
        ``slab[:total]``; the returned tail averages and unpacks into each
        entry's own tensor (never a view of the slab, which the next bin
        overwrites)."""
        reduce_op = entries[0].reduce_op
        name0 = entries[0].name
        sizes = [e.tensor.numel() for e in entries]
        total = sum(sizes)
        hier = self._hierarchy_plan(controller,
                                    self.config.hierarchical_allreduce)
        # the two-level slab is a multiple of g long: pad, wire traffic only
        padded = total if hier is None else \
            -(-total // hier.plan.group_size) * hier.plan.group_size
        if timeline is not None:
            timeline.activity_start(name0,
                                    timeline_mod.MEMCPY_IN_FUSION_BUFFER)
        pend.lease = self.fusion_buffers.acquire(
            padded, entries[0].tensor.dtype, self.device)
        buf = pend.lease.tensor[:total]
        if padded > total:
            pend.lease.tensor[total:padded].zero_()
        # flat views of the (contiguous) inputs: packed from, unpacked into
        flats = [e.tensor.view(-1) for e in entries]
        torch.cat(flats, out=buf)
        plan = integ_inject.plan_dispatch()
        if plan == "nan" and buf.is_floating_point():
            integ_inject.corrupt_nan(buf)  # this rank's input, pre-reduce
        nf_dev = None
        if self._integrity_due():
            t0 = time.perf_counter()
            nf_dev = integ_digest.nonfinite_count_tensor(buf)
            self.digest_seconds += time.perf_counter() - t0
        if timeline is not None:
            timeline.activity_end(name0)
            timeline.activity_start(name0, f"{self.backend}_ALLREDUCE")
        start = self._stamp()
        if hier is not None:
            # nf_dev above counted the uncompressed input, and the CRC
            # below runs over the assembled result: the digests' verdicts
            # do not depend on the wire precision
            work = hierarchy.hier_allreduce(
                hier, pend.lease.tensor[:padded], _TORCH_OPS[reduce_op],
                wire_dtype=self._hier_wire_dtype(), stream=self.stream)
        else:
            # a flat allreduce's 2(w-1) steps each cross the slow link
            resilience.inject("ring", "allreduce",
                              crossings=2 * (self.world - 1))
            work = dist.all_reduce(buf, op=_TORCH_OPS[reduce_op],
                                   group=self.group, async_op=True)
        types.COUNTS["allreduce"] += 1

        def finish():
            work.wait()
            timing = self._timing(pend, start)
            if reduce_op == types.REDUCE_AVERAGE:
                _average_(buf, self.world)
            if plan == "bitflip":
                # silent corruption of this rank's copy of the result: only
                # the checksum vote sees it
                integ_inject.corrupt_bitflip(buf)
            if nf_dev is not None:
                t0 = time.perf_counter()
                self._verify(controller, nf_dev, integ_digest.checksum(buf),
                             f"fused[{total}]", name0, t0)
            if timeline is not None:
                timeline.activity_end(name0)
                timeline.activity_start(
                    name0, timeline_mod.MEMCPY_OUT_FUSION_BUFFER)
            # one multi-tensor copy for the bin's slices
            torch._foreach_copy_(flats, buf.split(sizes))
            for e in entries:
                e.output = e.tensor
            if timeline is not None:
                timeline.activity_end(name0)
            self._mark_done(entries, timing, work)

        return finish

    def _dispatch_each(self, kind, entries, timeline, pend, sizes=(),
                       controller=None):
        """One collective an entry: broadcast in place; allgather (ragged
        by the negotiated ``sizes``), alltoall and reduce-scatter into the
        outputs the enqueue allocated. A reduce-scatter is a digest's
        eligible dispatch: its inputs' non-finite count, no CRC."""
        name0 = pend.name0
        if timeline is not None:
            timeline.activity_start(name0, f"{self.backend}_{kind}")
        nf_dev = None
        inputs = [e.tensor for e in entries]
        if kind == types.REDUCESCATTER:
            # no replicated result here to flip: a nan lane only
            plan = integ_inject.plan_dispatch(kinds=("nan",))
            if plan == "nan" and inputs[0].is_floating_point():
                # a poisoned gradient: a copy of this rank's input
                inputs[0] = inputs[0].clone()
                integ_inject.corrupt_nan(inputs[0])
            if self._integrity_due():
                t0 = time.perf_counter()
                nf_dev = sum(integ_digest.nonfinite_count_tensor(x)
                             for x in inputs)
                self.digest_seconds += time.perf_counter() - t0
        hier = None
        if kind == types.REDUCESCATTER:
            hier = self._hierarchy_plan(controller,
                                        self.config.hierarchical_allreduce)
        elif kind == types.ALLGATHER:
            hier = self._hierarchy_plan(controller,
                                        self.config.hierarchical_allgather)
            if hier is not None and len(set(sizes)) > 1:
                self._warn_once("ragged", "hierarchy: a ragged allgather "
                                "runs the flat call")
                hier = None
        works, tails = [], []
        start = self._stamp()
        for e, x in zip(entries, inputs):
            if kind == types.BROADCAST:
                resilience.inject("ring", "broadcast")
                e.output = x
                works.append(dist.broadcast(x, src=e.root_rank,
                                            group=self.group, async_op=True))
            elif kind == types.ALLGATHER and hier is not None:
                works.append(hierarchy.hier_allgather(
                    hier, x, e.output, stream=self.stream))
            elif kind == types.ALLGATHER and len(set(sizes)) > 1:
                resilience.inject("ring", "allgather",
                                  crossings=self.world - 1)
                works.append(self._ragged_allgather(e, sizes, tails))
            elif kind == types.ALLGATHER:
                resilience.inject("ring", "allgather",
                                  crossings=self.world - 1)
                works.append(_all_gather_one(e.output, x.contiguous(),
                                             group=self.group, async_op=True))
            elif kind == types.ALLTOALL:
                resilience.inject("ring", "alltoall")
                works.append(dist.all_to_all_single(
                    e.output, x.contiguous(), group=self.group,
                    async_op=True))
            elif hier is not None and x.numel() % self.world == 0:
                works.append(hierarchy.hier_reducescatter(
                    hier, x.contiguous(), e.output,
                    _TORCH_OPS[e.reduce_op],
                    wire_dtype=self._hier_wire_dtype(), stream=self.stream))
            else:
                if hier is not None:
                    self._warn_once("rs", "hierarchy: a reduce-scatter "
                                    "whose size is not a multiple of the "
                                    "world runs the flat call")
                resilience.inject("ring", "reducescatter",
                                  crossings=self.world - 1)
                works.append(_reduce_scatter_one(
                    e.output, x.contiguous(), op=_TORCH_OPS[e.reduce_op],
                    group=self.group, async_op=True))
            types.COUNTS[kind.lower()] += 1

        def finish():
            for w in works:
                w.wait()
            timing = self._timing(pend, start)
            if nf_dev is not None:
                t0 = time.perf_counter()
                self._verify(controller, nf_dev, 0, f"rs[{len(entries)}]",
                             name0, t0)
            for tail in tails:
                tail()
            for e in entries:
                if e.reduce_op == types.REDUCE_AVERAGE \
                        and kind == types.REDUCESCATTER:
                    _average_(e.output, self.world)
            if timeline is not None:
                timeline.activity_end(name0)
            self._mark_done(entries, timing, works)

        return finish

    def _ragged_allgather(self, e, sizes, tails):
        """Gather parts of ``sizes`` rows (rank order) as equal parts of the
        largest: this rank's part goes into a zeroed buffer of that size,
        the gather fills ``world`` such parts, and the tail appended to
        ``tails`` copies the real rows out into a new output of
        ``sum(sizes)`` rows, allocated on the caller's stream as the
        enqueue allocates an output."""
        x, rest, top = e.tensor, tuple(e.tensor.shape[1:]), max(sizes)
        part = x.new_zeros((top,) + rest)
        part[:x.shape[0]] = x
        parts = x.new_empty((self.world * top,) + rest)
        with _on(e.ready):
            e.output = x.new_empty((sum(sizes),) + rest)

        def tail():
            rows = [parts[r * top:r * top + n] for r, n in enumerate(sizes)]
            torch.cat(rows, out=e.output)

        tails.append(tail)
        return _all_gather_one(parts, part, group=self.group, async_op=True)


def _on(stream):
    """The caller's stream as current (allocations land in its pool), or
    nothing on the CPU."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())
