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
total``); on the card these are the host's times of queueing the work, not
the device's. Not ported yet: the hierarchy, integrity digests, comms
accounting and the flight recorder (ROADMAP A8, A10, A11).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch import timeline as timeline_mod
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.runtime import types
from horovod_tpu_torch.runtime.fusion_buffer import FusionBufferManager

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

_TORCH_OPS = {types.REDUCE_SUM: dist.ReduceOp.SUM,
              types.REDUCE_AVERAGE: dist.ReduceOp.SUM,
              types.REDUCE_MIN: dist.ReduceOp.MIN,
              types.REDUCE_MAX: dist.ReduceOp.MAX,
              types.REDUCE_PRODUCT: dist.ReduceOp.PRODUCT}

# torch 2.13 names the one-tensor forms reduce_scatter_single and
# all_gather_single; older releases have only the *_tensor names
_reduce_scatter_one = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather_one = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


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
                 "done", "lease", "t0", "t_disp_end", "t_drain_start")

    def __init__(self, executor: "Executor", op: str, entries, timeline):
        self.executor = executor
        self.op = op
        self.entries = entries
        self.timeline = timeline
        self.name0 = entries[0].name if entries else "?"
        self.finish: Optional[Callable[[], None]] = None
        self.done = False
        self.lease = None
        # dispatch start, dispatch end and drain start: the gap between the
        # last two is the time the op's work stood queued behind later
        # dispatches, hidden from the caller
        self.t0 = time.perf_counter()
        self.t_disp_end: Optional[float] = None
        self.t_drain_start: Optional[float] = None

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
        _COMM_EXPOSED.inc(max(0.0, total - max(0.0, drain_start - disp_end)))
        if self.timeline is not None:
            self.timeline.end(self.name0)

    def fail(self, status: types.Status) -> None:
        """Complete every entry with an error (reference: ErrorOp,
        collective_operations.cc:202-205). Idempotent."""
        if self.done:
            return
        if self.t_drain_start is None:
            self.t_drain_start = time.perf_counter()
        _OP_ERRORS.labels(op=self.op).inc()
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
            self.fail(types.Status.UnknownError(
                f"{type(exc).__name__}: {exc}"))
            return
        _OP_BYTES.labels(op=self.op).inc(
            sum(types.entry_nbytes(e) for e in self.entries))
        ok = types.Status.OK()
        for e in self.entries:
            e.complete(ok, e.output)
        self._close()


class Executor:
    """Runs each response on the data group ``group`` of ``world`` ranks,
    on the card from the comm stream ``stream``, which the runtime's thread
    keeps as its current stream."""

    def __init__(self, device: torch.device, group, world: int,
                 fusion_threshold: int, quantum_bytes: int, depth: int):
        self.device = device
        self.group = group
        self.world = world
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.backend = "NCCL" if device.type == "cuda" else "GLOO"
        self.fusion_buffers = FusionBufferManager(
            quantum_bytes, fusion_threshold, depth)
        self._held: "collections.deque" = collections.deque()
        self.latest: Optional["Done"] = None

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

    def _mark_done(self, entries) -> None:
        """Record the bin's ``done`` event, numbered in the comm stream's
        order (see ``Done``). Until the device has passed it, the executor
        holds the bin's tensors, so the allocator cannot hand their memory
        to another stream while the comm stream still uses it (one
        reference a bin in place of ``record_stream`` a tensor)."""
        if self.stream is None:
            return
        event = torch.cuda.Event()
        event.record(self.stream)
        self.latest = done = Done(next(_done_seq), event, self)
        for e in entries:
            e.done = done
        self._held.append((event, [(e.tensor, e.output) for e in entries]))
        while self._held and self._held[0][0].query():
            self._held.popleft()

    def close(self) -> None:
        """Wait for the comm stream's work, then drop the held tensors."""
        if self.stream is not None:
            self.stream.synchronize()
        self._held.clear()

    def dispatch(self, response, entries: List[types.TensorTableEntry],
                 timeline=None) -> _PendingOp:
        """Launch one (fused) response and return its pending token
        (reference: PerformOperation, operations.cc:211-279: statuses go
        through the entries' callbacks, an ERROR response fails them all)."""
        pend = _PendingOp(self, response.response_type, entries, timeline)
        try:
            if timeline is not None:
                timeline.start(pend.name0, response.response_type)
            kind = response.response_type
            if kind == types.ERROR:
                pend.fail(
                    types.Status.PreconditionError(response.error_message))
                return pend
            self._order_after_inputs(entries)
            if kind == types.ALLREDUCE:
                pend.finish = self._dispatch_allreduce(entries, timeline,
                                                       pend)
            elif kind in (types.BROADCAST, types.ALLGATHER,
                          types.REDUCESCATTER, types.ALLTOALL):
                pend.finish = self._dispatch_each(
                    kind, entries, timeline, pend.name0,
                    response.tensor_sizes)
            else:
                raise ValueError(f"response type {kind} is not ported")
        except Exception as exc:
            pend.fail(types.Status.UnknownError(
                f"{type(exc).__name__}: {exc}"))
        if pend.t_disp_end is None:
            pend.t_disp_end = time.perf_counter()
        return pend

    def _dispatch_allreduce(self, entries, timeline, pend):
        """Pack the bin into a leased slab, one collective over
        ``slab[:total]``; the returned tail averages and unpacks into each
        entry's own tensor (never a view of the slab, which the next bin
        overwrites)."""
        reduce_op = entries[0].reduce_op
        name0 = entries[0].name
        sizes = [e.tensor.numel() for e in entries]
        total = sum(sizes)
        if timeline is not None:
            timeline.activity_start(name0,
                                    timeline_mod.MEMCPY_IN_FUSION_BUFFER)
        pend.lease = self.fusion_buffers.acquire(
            total, entries[0].tensor.dtype, self.device)
        buf = pend.lease.tensor[:total]
        # flat views of the (contiguous) inputs: packed from, unpacked into
        flats = [e.tensor.view(-1) for e in entries]
        torch.cat(flats, out=buf)
        if timeline is not None:
            timeline.activity_end(name0)
            timeline.activity_start(name0, f"{self.backend}_ALLREDUCE")
        work = dist.all_reduce(buf, op=_TORCH_OPS[reduce_op],
                               group=self.group, async_op=True)
        types.COUNTS["allreduce"] += 1

        def finish():
            work.wait()
            if reduce_op == types.REDUCE_AVERAGE:
                _average_(buf, self.world)
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
            self._mark_done(entries)

        return finish

    def _dispatch_each(self, kind, entries, timeline, name0, sizes=()):
        """One collective an entry: broadcast in place; allgather (ragged
        by the negotiated ``sizes``), alltoall and reduce-scatter into the
        outputs the enqueue allocated."""
        if timeline is not None:
            timeline.activity_start(name0, f"{self.backend}_{kind}")
        works, tails = [], []
        for e in entries:
            x = e.tensor
            if kind == types.BROADCAST:
                e.output = x
                works.append(dist.broadcast(x, src=e.root_rank,
                                            group=self.group, async_op=True))
            elif kind == types.ALLGATHER and len(set(sizes)) > 1:
                works.append(self._ragged_allgather(e, sizes, tails))
            elif kind == types.ALLGATHER:
                works.append(_all_gather_one(e.output, x.contiguous(),
                                             group=self.group, async_op=True))
            elif kind == types.ALLTOALL:
                works.append(dist.all_to_all_single(
                    e.output, x.contiguous(), group=self.group,
                    async_op=True))
            else:
                works.append(_reduce_scatter_one(
                    e.output, x.contiguous(), op=_TORCH_OPS[e.reduce_op],
                    group=self.group, async_op=True))
            types.COUNTS[kind.lower()] += 1

        def finish():
            for w in works:
                w.wait()
            for tail in tails:
                tail()
            for e in entries:
                if e.reduce_op == types.REDUCE_AVERAGE \
                        and kind == types.REDUCESCATTER:
                    _average_(e.output, self.world)
            if timeline is not None:
                timeline.activity_end(name0)
            self._mark_done(entries)

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
