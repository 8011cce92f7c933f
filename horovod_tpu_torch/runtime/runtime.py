"""The background enqueue runtime: the cycle loop and its handles (port of
``horovod_tpu/runtime/runtime.py``; reference: horovod/common/
operations.cc, BackgroundThreadLoop/RunLoopOnce :303-550, the enqueue
APIs :736-843, the design note :281-300).

Caller threads enqueue named tensors; one background thread a process
runs cycles that (a) negotiate through the controller which tensors are
ready on every worker, (b) fuse the ready allreduces under
``HOROVOD_FUSION_THRESHOLD``, (c) run the collectives on the data group,
one call a fused bin, and (d) complete the handles. The execution order is
the one the coordinator agreed, whatever order each worker enqueued in,
and the cycle thread is the only issuer on the data group.

Cycles are paced as in the reference's RunLoopOnce: one starts no sooner
than ``HOROVOD_CYCLE_TIME`` after the last one started, so gradients that
autograd's hooks enqueue one at a time gather into bins; a grouped enqueue
(``enqueue_allreduce_group``) starts a cycle at once.

The knobs come from ``init()``'s ``utils.env.Config``. Each cycle adds one
``CYCLE_<n>`` marker (``HOROVOD_TIMELINE_MARK_CYCLES``) and one set of
counter events to the coordinator's timeline, and moves the cycle metrics
(``horovod_cycles_total`` with ``COUNTS["cycles"]`` in one call,
``horovod_cycle_duration_seconds``, ``horovod_cycle_tensors``,
``horovod_cycle_pipeline_depth``; a handle's wait is
``horovod_handle_wait_seconds``, whose sum the step profiler diffs into a
step's ``exposed_comm`` phase: on the card, host time until the
collective is queued, not the device's). The coordinator's stall
inspector carries a straggler tracker.

A multi-process runtime that goes down for a failure keeps its typed
reason in :attr:`Runtime.failure`: the gloo controller's
:class:`~horovod_tpu_torch.exceptions.WorkerLostError` for a peer that
went away (any other cycle failure in a lockstep world reads as one too),
the controller's ``WorkerStallError`` (the collective deadline, the
elastic stall verdict), the executor's data-plane loss, or, under
``HOROVOD_ELASTIC``, a ``WorkersDownError`` for a shutdown bit no local
cause explains (a peer evicted someone). Every waiting handle raises it,
and so does every enqueue after it: ``@hvd.elastic.run`` catches it. An
integrity verdict of the digests (``NumericalError``) reaches the waiting
handle without taking the runtime down: the first handle to see it raises
it and clears it, and the runtime goes on for the rollback's replay.

The flight recorder's ``runtime`` state is this runtime's in-flight view
(the table's names, the ops in the cycle's pipeline, the failure), read
without a lock so a wedged cycle cannot block a dump; a cycle that fails
emits ``cycle_abort`` and makes a failure dump, and ``stop`` emits
``runtime_stop``. Each change of the pipeline's depth is a
``pipeline_depth`` event.

The autotuner (``HOROVOD_AUTOTUNE``; reference: parameter_manager wired
into RunLoopOnce and SynchronizeParameters, operations.cc:500-550,
controller.cc:32-46): under ``HOROVOD_AUTOTUNE_PROBE`` every rank runs the
hardware probes as the runtime starts (``autotune/probe.py``: the card's
memory and the data group's allreduce, and the hierarchy's hops where one
can form) and the ranks agree on the coordinator's seeded fusion
threshold. The coordinator holds a ``ParameterManager`` that scores each
busy cycle; after every cycle it broadcasts the packed knobs on the gloo
control group and every rank applies them at that boundary: the fusion
threshold, the cycle time, the cache switch, the hierarchy's knobs, the
pipeline depth, the release plans' bucket bytes and the stage-3 prefetch
window. Each change applied is an ``autotune_commit`` flight event and
moves ``horovod_autotune_param{knob}`` and ``horovod_autotune_commits_
total`` on every rank; once the manager freezes the syncs stop. The sweep
holds ``cache_enabled`` when a cache exists and, where a hierarchy can form
(``Executor.hierarchical_available``), ``hierarchical_allreduce``,
``hierarchy_compression`` and ``hierarchical_allgather``: the port's one
data plane consults all three. A sample's score is the JAX package's: the
cycle's bytes over its host seconds (on the card the time to queue the
work), blended half and half with ``comms.data_lane_busbw_gbs()`` (the
device's event times, of the bins whose ``done`` event has passed).

Every response the executor completes records a ``collective:<name>``
span in the tracing ring (``tracing.py``), with its op, bytes and the
dispatch, overlap and drain milliseconds.

The lane-hazard watchdog (``_check_lane_hazard``, at the top of each
cycle): the ordered-lane guard (``hvd.assert_collective_lane_clear``)
raises when the library's own collectives would interleave with pending
named ops, but a caller's own NCCL work (a model-parallel step, a user's
``torch.distributed`` call) dispatched while named collectives are pending
is invisible to it, and across ranks the two streams can interleave in
different orders and hang with no error. Its local signature: named ops in
flight past the stall inspector's warning time while the enqueue side has
been quiet that long and no caller waits on a handle or polls one (a
caller parked in ``wait`` or spinning on ``poll`` is waiting on the lane,
and a slow peer there is the stall inspector's diagnosis). Then it logs
one warning a stall period naming the stuck tensors. It is quiet while the
stall inspector is off (``HOROVOD_STALL_CHECK_DISABLE``) and reads its
``HOROVOD_STALL_CHECK_TIME_SECONDS``. Every enqueue stamps the quiet clock
in ``_enqueue``, whichever thread calls it (autograd's backward threads
run the gradient hooks on the card).
"""

from __future__ import annotations

import collections
import struct
import threading
import time
from typing import Any, List, Optional

import torch

from horovod_tpu_torch import exceptions
from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch.core import state as state_mod
from horovod_tpu_torch.exceptions import NotInitializedError
from horovod_tpu_torch.metrics import COUNT_BUCKETS, registry as _metrics
from horovod_tpu_torch.runtime import fusion as fusion_mod
from horovod_tpu_torch.runtime import message as msg
from horovod_tpu_torch.runtime import response_cache as cache_mod
from horovod_tpu_torch.runtime import tensor_queue as queue_mod
from horovod_tpu_torch.runtime import types
from horovod_tpu_torch.runtime.controller import Controller, LocalController
from horovod_tpu_torch.runtime.executor import Executor
from horovod_tpu_torch.runtime.gloo_controller import (GlooController,
                                                       lost_worker)
from horovod_tpu_torch.runtime.tensor_queue import TensorQueue
from horovod_tpu_torch.stall import StallInspector, StragglerTracker
from horovod_tpu_torch.timeline import Timeline
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils import resilience

COUNTS = types.COUNTS
reset_counts = types.reset_counts

_CYCLES = _metrics().counter(
    "horovod_cycles_total", "Background negotiation+execution cycles run.")
_CYCLE_DURATION = _metrics().histogram(
    "horovod_cycle_duration_seconds",
    "Wall time of one cycle body (negotiation + execution).")
_CYCLE_TENSORS = _metrics().histogram(
    "horovod_cycle_tensors",
    "Tensors agreed for execution per cycle.", buckets=COUNT_BUCKETS)
_HANDLE_WAIT = _metrics().histogram(
    "horovod_handle_wait_seconds",
    "Caller time blocked in RuntimeHandle.wait().")
_PIPELINE_DEPTH = _metrics().gauge(
    "horovod_cycle_pipeline_depth",
    "Responses currently in flight on the pipelined data plane (bounded "
    "by HOROVOD_CYCLE_PIPELINE_DEPTH).")
_AUTOTUNE_PARAM = _metrics().gauge(
    "horovod_autotune_param",
    "Runtime parameter value most recently committed by the per-cycle "
    "autotune sync, by knob (string-valued knobs are encoded: the "
    "hierarchy codec reports its COMPRESSION_CODECS index).",
    labelnames=("knob",))
_AUTOTUNE_COMMITS = _metrics().counter(
    "horovod_autotune_commits_total",
    "Parameter-blob changes applied at a cycle boundary (the broadcast "
    "blob differed from the previously applied one).")


def wire_dtype(dtype: torch.dtype) -> str:
    """A torch dtype's name on the wire: "float32", "bfloat16", ..., the
    names the JAX package announces."""
    return str(dtype).replace("torch.", "")


class RuntimeHandle:
    """Completion future of an enqueued named tensor (reference:
    horovod/torch/handle_manager.cc, mpi_ops.py poll/synchronize). A lock
    held from creation to completion is its wait: one object a handle,
    where a ``threading.Event`` makes several, on every gradient of every
    step."""

    __slots__ = ("name", "_lock", "_status", "_output", "_done", "_runtime")

    def __init__(self, name: str, runtime: "Optional[Runtime]" = None):
        self.name = name
        self._runtime = runtime
        self._lock = threading.Lock()
        self._lock.acquire()
        self._status: Optional[types.Status] = None
        self._output: Any = None
        self._done = None  # executor.Done of the result, on the card

    def _complete(self, status: types.Status, output, done=None) -> None:
        self._output = output
        self._done = done
        self._status = status
        rt = self._runtime
        if rt is not None:
            rt._retire(self.name)
        self._lock.release()

    def poll(self) -> bool:
        """True once the result is ready (on the card: once the device has
        run the collective). A poll loop waits on the lane as a parked
        ``wait`` does: it stamps the lane-hazard watchdog's clock."""
        rt = self._runtime
        if rt is not None:
            rt._last_poll_time = time.monotonic()
        return self._status is not None and (self._done is None
                                             or self._done.event.query())

    def wait(self, timeout: Optional[float] = None):
        """Block until the runtime has queued the collective, then order
        the caller's current stream after it (no host wait on the device).
        A failed collective raises: ValueError for an invalid argument, the
        digests' ``NumericalError``, the runtime's typed
        ``WorkersDownError``, RuntimeError otherwise."""
        if self._status is None:
            rt = self._runtime
            if rt is not None:
                with rt._inflight_lock:
                    rt._waiters += 1
            t0 = time.monotonic()
            try:
                got = self._lock.acquire(timeout=-1 if timeout is None
                                         else timeout)
            finally:
                _HANDLE_WAIT.observe(time.monotonic() - t0)
                if rt is not None:
                    with rt._inflight_lock:
                        rt._waiters -= 1
            if not got:
                raise TimeoutError(f"collective '{self.name}' did not "
                                   f"complete within {timeout}s")
            self._lock.release()
        else:
            _HANDLE_WAIT.observe(0.0)
        if not self._status.ok():
            if self._status.type == types.StatusType.INVALID_ARGUMENT:
                raise ValueError(f"collective '{self.name}' failed: "
                                 f"{self._status.reason}")
            rt = self._runtime
            if rt is not None:
                rt.raise_typed(f"collective '{self.name}' failed: "
                               f"{self._status.reason}")
            raise RuntimeError(f"collective '{self.name}' failed: "
                               f"{self._status.reason}")
        out = self._output
        done = self._done
        if done is not None:
            stream = torch.cuda.current_stream(out.device)
            if _waited.get(stream.cuda_stream, -1) < done.seq:
                latest = done.executor.latest  # covers done: same stream
                stream.wait_event(latest.event)
                _waited[stream.cuda_stream] = latest.seq
        return out


# raw CUDA stream -> the seq of the latest ``Done`` it waited on (see wait)
_waited: dict = {}


def _with_callback(group_callback, complete):
    """An entry's completion that first tells ``group_callback`` whether
    it succeeded: accounting never keeps a handle from completing."""

    def callback(status, output, done=None):
        try:
            group_callback(status.ok())
        except Exception:
            log.get_logger().exception("group callback failed")
        complete(status, output, done)

    return callback


def _fail_incomplete_entries(entries) -> None:
    status = types.Status.Aborted("background cycle failed; see runtime log")
    for e in entries:
        e.complete(status, None)  # exactly once: the guard is on the entry


class Runtime:
    """Owns the cycle thread, the queue, the controller and the executor.

    ``controller`` negotiates among ``controller.world`` ranks; the
    collectives run on ``data_group`` from ``device``; the knobs are
    ``config``'s (default: parsed from the environment now)."""

    def __init__(self, controller: Controller, device: torch.device,
                 data_group, config: Optional[env.Config] = None):
        cfg = env.Config.from_env() if config is None else config
        self.config = cfg
        self.queue = TensorQueue()
        self.controller = controller
        self.device = device
        self.fusion_threshold = cfg.fusion_threshold_bytes
        self.depth = max(1, cfg.cycle_pipeline_depth)
        self._cycle_time_s = cfg.cycle_time_ms / 1000.0
        self.executor = Executor(
            device, data_group, controller.world, self.fusion_threshold,
            cfg.fusion_bucket_quantum, self.depth, cfg)
        # the coordinator writes the timeline (reference: operations.cc)
        self.timeline = (Timeline(cfg.timeline_file,
                                  mark_cycles=cfg.timeline_mark_cycles,
                                  native_engine=controller.native_engine)
                         if cfg.timeline_file and controller.is_coordinator
                         else None)
        self.stall_inspector = StallInspector(
            warning_time_seconds=cfg.stall_check_time_seconds,
            shutdown_time_seconds=cfg.stall_shutdown_time_seconds,
            enabled=not cfg.stall_check_disable, elastic=cfg.elastic)
        # the typed reason this runtime went down (a WorkersDownError),
        # when a failure path could tell; a deliberate stop() leaves None
        self.failure: Optional[Exception] = None
        self._deliberate_stop = False
        if controller.is_coordinator:
            controller.straggler = StragglerTracker(
                world=controller.world,
                report_seconds=cfg.straggler_report_seconds)
        # stale deferred hits renegotiate on the stall warning's clock
        self.controller.STALE_HIT_SECONDS = cfg.stall_check_time_seconds
        # the cycle's pipeline, visible to a dump while ops are in flight
        self._cycle_pending: "Optional[collections.deque]" = None
        flight_recorder.set_state_provider("runtime", self._debug_state)
        # the autotuner: every rank probes together (collective), the
        # coordinator tunes, every rank applies the broadcast knobs
        self.param_manager = None
        self._autotune_active = bool(cfg.autotune)
        self._applied_params_blob: Optional[bytes] = None
        self._cycle_bytes = 0
        self.probe: Optional[dict] = None
        if self._autotune_active and cfg.autotune_probe:
            self._probe(data_group)
        if self._autotune_active and controller.is_coordinator:
            self.param_manager = self._make_param_manager()
        # the lane-hazard watchdog's bookkeeping: each in-flight name's
        # enqueue time, when the enqueue side last spoke, the callers
        # parked in wait() and the last poll()
        self._inflight_lock = threading.Lock()
        self._inflight_names: dict = {}  # guarded by _inflight_lock
        self._last_enqueue_time = time.monotonic()
        self._waiters = 0  # guarded by _inflight_lock
        self._last_poll_time = 0.0
        self._lane_last_warn = 0.0
        self._stop = threading.Event()
        self._woken = threading.Event()   # work was enqueued
        self._urgent = threading.Event()  # start a cycle now: no pacing
        self._thread = threading.Thread(
            target=self._run_loop, daemon=True, name="hvd-background-loop")
        self._thread.start()

    # -- enqueue APIs (reference: operations.cc:736-843) -------------------
    def _check_running(self) -> None:
        if self._stop.is_set():
            if isinstance(self.failure, exceptions.WorkersDownError):
                raise type(self.failure)(
                    f"{types.SHUT_DOWN_ERROR} (cause: {self.failure})",
                    ranks=self.failure.ranks) from self.failure
            raise RuntimeError(types.SHUT_DOWN_ERROR)

    def raise_typed(self, message: str) -> None:
        """Raise the typed reason of a failed collective, if there is one:
        the executor's integrity verdict (lifted and cleared: the runtime
        survives the rollback), else the runtime's (or the executor's)
        ``WorkersDownError``. Returns when there is none."""
        integ = self.executor.integrity_failure
        if integ is not None:
            self.executor.integrity_failure = None
            raise type(integ)(
                f"{message}: integrity check: {integ}", bucket=integ.bucket,
                tensor=integ.tensor,
                suspect_rank=integ.suspect_rank) from integ
        # the executor records a data-plane loss before it completes the
        # entries; the runtime lifts it only at the cycle's end
        failure = self.failure or self.executor.failure
        if isinstance(failure, exceptions.WorkersDownError):
            raise type(failure)(f"{message} (cause: {failure})",
                                ranks=failure.ranks) from failure

    def _record_failure(self, exc: Exception) -> None:
        """Keep the typed reason the runtime goes down for (the first one
        wins). A one-process runtime survives a failed cycle: nothing."""
        if not self.controller.lockstep or self.failure is not None:
            return
        self.failure = (
            exc if isinstance(exc, exceptions.WorkersDownError)
            else lost_worker(exc) or exceptions.WorkerLostError(
                f"control-plane failure: {type(exc).__name__}: {exc}"))

    def _entry(self, request_type: str, name: str, tensor, root_rank=0,
               reduce_op=types.REDUCE_AVERAGE, priority=0):
        """The table entry, its negotiation request and its handle. On the
        card the entry carries the caller's current stream, which the
        runtime's stream waits for before it reads. A gather's or scatter's
        output is allocated here, on the caller's stream.

        Nothing here releases the interpreter lock (no CUDA call, no
        kernel): the gradient hooks run this on autograd's thread, and each
        release would let the cycle thread in mid-hook, so that the hook
        then waits for the lock again."""
        if not isinstance(tensor, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(tensor)}")
        if tensor.device.type != self.device.type:
            raise ValueError(f"tensor '{name}' is on {tensor.device} but the "
                             f"runtime runs on {self.device}")
        if reduce_op not in types.REDUCE_OPS:
            raise ValueError(f"unknown reduce_op {reduce_op!r}")
        handle = RuntimeHandle(name, self)
        entry = types.TensorTableEntry(
            name=name, tensor=tensor, request_type=request_type,
            root_rank=root_rank, reduce_op=reduce_op,
            dtype=wire_dtype(tensor.dtype), shape=tuple(tensor.shape),
            priority=priority)
        if tensor.is_cuda:
            entry.ready = torch.cuda.current_stream(tensor.device)
        if request_type == types.ALLGATHER:
            # the equal-split guess; a ragged gather's output is made when
            # the negotiated sizes are known (Executor._dispatch_each)
            entry.output = tensor.new_empty(
                (self.controller.world * tensor.shape[0],)
                + tuple(tensor.shape[1:]))
        elif request_type == types.ALLTOALL:
            entry.output = tensor.new_empty(tensor.shape)
        elif request_type == types.REDUCESCATTER:
            entry.output = tensor.new_empty(
                (tensor.shape[0] // self.controller.world,)
                + tuple(tensor.shape[1:]))
        entry.callback = handle._complete
        request = msg.Request(
            rank=self.controller.rank, request_type=request_type,
            tensor_name=name, dtype=entry.dtype, shape=entry.shape,
            root_rank=root_rank, reduce_op=reduce_op)
        return entry, request, handle

    def _stamp(self, names) -> list:
        """Stamp the watchdog's clocks before the entries become visible to
        the cycle thread; the names that were not in flight already (a
        duplicate must not evict the original's stamp) come back."""
        now = time.monotonic()
        fresh = []
        with self._inflight_lock:
            for name in names:
                if name not in self._inflight_names:
                    self._inflight_names[name] = now
                    fresh.append(name)
            self._last_enqueue_time = now
        return fresh

    def _unstamp(self, names) -> None:
        with self._inflight_lock:
            for name in names:
                self._inflight_names.pop(name, None)

    def _retire(self, name: str) -> None:
        with self._inflight_lock:
            self._inflight_names.pop(name, None)

    def _enqueue(self, request_type: str, name: str, tensor, **kw
                 ) -> RuntimeHandle:
        self._check_running()
        entry, request, handle = self._entry(request_type, name, tensor, **kw)
        fresh = self._stamp((name,))
        try:
            self.queue.add(entry, request)  # DuplicateNameError on misuse
        except BaseException:
            self._unstamp(fresh)
            raise
        if not self._woken.is_set():
            self._woken.set()
        return handle

    def enqueue_allreduce(self, name: str, tensor,
                          reduce_op: str = types.REDUCE_AVERAGE,
                          priority: int = 0) -> RuntimeHandle:
        """Reduce the contiguous ``tensor`` in place across the ranks."""
        return self._enqueue(types.ALLREDUCE, name, tensor,
                             reduce_op=reduce_op, priority=priority)

    def enqueue_allreduce_group(self, names, tensors,
                                reduce_op: str = types.REDUCE_AVERAGE,
                                priority: int = 0,
                                group_callback=None) -> List[RuntimeHandle]:
        """Enqueue a group of allreduces at once: one lock scope in the
        queue (``TensorQueue.add_group``), and a cycle starts at once, so
        the whole group negotiates in one cycle and fuses into as few
        calls as the threshold allows. ``group_callback(ok)``, if given,
        fires on the cycle thread once an entry as it completes or fails
        (a release plan's wire accounting; its exceptions are dropped).
        One handle a tensor, in order."""
        self._check_running()
        names, tensors = list(names), list(tensors)
        if len(names) != len(tensors):
            raise ValueError("names and tensors must pair up")
        made = [self._entry(types.ALLREDUCE, n, t, reduce_op=reduce_op,
                            priority=priority)
                for n, t in zip(names, tensors)]
        if group_callback is not None:
            for entry, _, handle in made:
                entry.callback = _with_callback(group_callback,
                                                handle._complete)
        fresh = self._stamp(names)
        try:
            self.queue.add_group([m[0] for m in made], [m[1] for m in made])
        except BaseException:
            self._unstamp(fresh)
            raise
        self._urgent.set()
        self._woken.set()
        return [m[2] for m in made]

    def enqueue_broadcast(self, name: str, tensor, root_rank: int,
                          priority: int = 0) -> RuntimeHandle:
        """Make every rank's ``tensor`` rank ``root_rank``'s, in place."""
        return self._enqueue(types.BROADCAST, name, tensor,
                             root_rank=root_rank, priority=priority)

    def enqueue_allgather(self, name: str, tensor,
                          priority: int = 0) -> RuntimeHandle:
        return self._enqueue(types.ALLGATHER, name, tensor,
                             priority=priority)

    def enqueue_alltoall(self, name: str, tensor,
                         priority: int = 0) -> RuntimeHandle:
        """Exchange equal chunks of dim 0 with every rank (reference:
        ``horovod_tpu/runtime/runtime.py:545``)."""
        return self._enqueue(types.ALLTOALL, name, tensor, priority=priority)

    def enqueue_reducescatter(self, name: str, tensor,
                              reduce_op: str = types.REDUCE_SUM,
                              priority: int = 0) -> RuntimeHandle:
        return self._enqueue(types.REDUCESCATTER, name, tensor,
                             reduce_op=reduce_op, priority=priority)

    # -- cycle loop (reference: RunLoopOnce, operations.cc:500-550) --------
    def _check_lane_hazard(self) -> None:
        """The lane-hazard watchdog (``horovod_tpu/runtime/runtime.py:551``):
        one warning a stall period, naming the stuck tensors, when named
        ops have been in flight past the stall warning time, nothing was
        enqueued for as long, and no caller waits or polls."""
        ins = self.stall_inspector
        if not ins.enabled or ins.warning_time <= 0:
            return
        now = time.monotonic()
        with self._inflight_lock:
            if (not self._inflight_names or self._waiters > 0
                    or now - self._last_poll_time < ins.warning_time):
                return
            oldest = min(self._inflight_names.values())
            quiet = now - self._last_enqueue_time
            names = sorted(self._inflight_names)
        if (now - oldest < ins.warning_time or quiet < ins.warning_time
                or now - self._lane_last_warn < ins.warning_time):
            return
        self._lane_last_warn = now
        log.warning(
            "Named collective ops have been in flight for %.1fs with no new "
            "enqueues for %.1fs and no caller waiting on them. If this "
            "process is running its own NCCL work (a model-parallel step, "
            "a torch.distributed call of its own), that work and the "
            "pending named ops may be interleaved in different orders "
            "across ranks (a cross-rank hang with no error). Call "
            "hvd.assert_collective_lane_clear() before dispatching your own "
            "collectives. In-flight tensors: %s", now - oldest, quiet, names)

    def _run_loop(self) -> None:
        # the data plane records no autograd (grad mode is per thread): the
        # entries may be tensors that require grad, as a differentiable
        # collective's input does
        torch.set_grad_enabled(False)
        if self.device.type == "cuda":
            # the comm stream is this thread's current stream for good:
            # slabs are allocated on it, collectives ordered after it
            torch.cuda.set_device(self.device)
            torch.cuda.set_stream(self.executor.stream)
        # a lockstep world cycles even when idle: the peers' cycles wait
        idle_wait = self._cycle_time_s if self.controller.lockstep else None
        last_start = None
        while not self._stop.is_set():
            self._woken.wait(idle_wait)
            if last_start is not None and not self._urgent.is_set():
                delay = last_start + self._cycle_time_s - time.monotonic()
                if delay > 0:
                    self._urgent.wait(delay)
            self._woken.clear()
            self._urgent.clear()
            if self._stop.is_set():
                break
            last_start = time.monotonic()
            self._check_lane_hazard()
            try:
                keep_going = self.run_cycle()
            except Exception as exc:
                log.get_logger().exception("background cycle failed")
                # in a lockstep world a failed cycle leaves the peers'
                # collectives unmatched: the runtime goes down
                keep_going = not self.controller.lockstep
                self._record_failure(exc)  # no-op if run_cycle did it
            if not keep_going:
                break
        # every exit gates future enqueues, so none queues into a dead loop
        self._stop.set()
        self._finalize()

    def run_cycle(self) -> bool:
        """One negotiation and execution cycle; False shuts the runtime
        down."""
        if self.timeline is not None:
            self.timeline.mark_cycle_start()
        # cache hits still waiting for the other workers come first
        requests = self.controller.take_deferred() + self.queue.pop_requests()
        if not requests and not self.controller.lockstep \
                and not self.controller._should_shut_down:
            return True
        t0 = time.perf_counter()
        # counted as the cycle starts, so a caller its responses wake reads
        # it already counted
        types.bump("cycles", _CYCLES)
        try:
            keep_going = self._run_cycle_body(requests)
            if self._autotune_active:
                self._autotune_sync(self._cycle_bytes,
                                    time.perf_counter() - t0)
            return keep_going
        except Exception as exc:
            # the typed reason first: a handle reads it as it wakes
            self._record_failure(exc)
            # the popped entries would otherwise stay in the table with
            # their handles never completing: fail them loudly
            status = types.Status.Aborted(
                "background cycle failed; see runtime log")
            for e in self.queue.get_entries(
                    [r.tensor_name for r in requests]):
                e.complete(status, None)
            # the dump after the entries: a caller that its failure woke
            # may enqueue the same names again at once
            flight_recorder.emit(
                "cycle_abort", generation=resilience.current_generation(),
                error="%s: %s" % (type(exc).__name__, str(exc)[:200]))
            flight_recorder.dump_on_failure("cycle_abort")
            raise
        finally:
            seconds = time.perf_counter() - t0
            COUNTS["cycle_ms"] += 1e3 * seconds
            _CYCLE_DURATION.observe(seconds)
            if self.timeline is not None:
                self._emit_timeline_counters()

    def _run_cycle_body(self, requests) -> bool:
        responses, shut_down = self.controller.compute_response_list(
            requests, self.fusion_threshold, timeline=self.timeline,
            stall_inspector=self.stall_inspector)
        # the coordinator's stall or deadline verdict rides on the
        # controller while the shutdown bit goes out: lift it
        if self.controller.failure is not None and self.failure is None:
            self.failure = self.controller.failure
        if shut_down and self.failure is None and not self._deliberate_stop \
                and self.controller.lockstep and self.config.elastic:
            # a shutdown bit with no local cause: a peer evicted someone
            # or is going down, and the survivors re-form
            self.failure = exceptions.WorkersDownError(
                "peer requested shutdown (remote stall eviction or "
                "failure)")
        _CYCLE_TENSORS.observe(sum(len(r.tensor_names) for r in responses))
        pending: "collections.deque" = collections.deque()
        self._cycle_pending = pending
        cycle_entries = []
        self._cycle_bytes = 0
        try:
            for response in responses:
                entries = self.queue.get_entries(response.tensor_names)
                if not entries:
                    continue
                if not cycle_entries:
                    COUNTS["busy_cycles"] += 1
                cycle_entries.append(entries)
                COUNTS["responses"] += 1
                pending.append(self.executor.dispatch(
                    response, entries, timeline=self.timeline,
                    controller=self.controller))
                self._cycle_bytes += pending[-1].nbytes
                _PIPELINE_DEPTH.set(len(pending))
                flight_recorder.emit("pipeline_depth", depth=len(pending))
                while len(pending) >= self.depth:
                    self._drain_one(pending)
            while pending:
                self._drain_one(pending)
            # a data-plane loss fails its entries by status and records
            # itself on the executor
            if self.executor.failure is not None and self.failure is None:
                self.failure = self.executor.failure
        except Exception:
            status = types.Status.UnknownError(
                "background cycle failed; see runtime log")
            while pending:
                pending.popleft().fail(status)
            for entries in cycle_entries:
                _fail_incomplete_entries(entries)
            raise
        finally:
            _PIPELINE_DEPTH.set(0)
        return not shut_down

    @staticmethod
    def _drain_one(pending) -> None:
        """Complete the oldest response in flight; the depth gauge moves
        first, so no caller it wakes reads a stale depth."""
        op = pending.popleft()
        _PIPELINE_DEPTH.set(len(pending))
        flight_recorder.emit("pipeline_depth", depth=len(pending))
        op.complete()

    # -- the autotuner (horovod_tpu/runtime/runtime.py:195-320, 811-886) --
    def _probe(self, data_group) -> None:
        """The hardware probes, on every rank together: the card's memory
        and the data group's allreduce seed the fusion threshold (the
        coordinator's wins), and where a hierarchy can form its hops seed
        their lanes. A probe that fails raises."""
        from horovod_tpu_torch.autotune import probe

        cfg, ctrl = self.config, self.controller
        measured = probe.probe_and_seed(cfg, world=ctrl.world,
                                        rank=ctrl.rank, group=data_group,
                                        device=self.device)
        if ctrl.world > 1:
            # every rank must bin-pack cycle 1 with the same threshold
            blob = (struct.pack("<q", cfg.fusion_threshold_bytes)
                    if ctrl.is_coordinator else None)
            cfg.fusion_threshold_bytes = struct.unpack(
                "<q", ctrl.bcast_blob(blob))[0]
        self.fusion_threshold = cfg.fusion_threshold_bytes
        measured["fusion_threshold_bytes"] = cfg.fusion_threshold_bytes
        if self.executor.hierarchical_available():
            hops = probe.probe_host_hier_and_seed(ctrl, self.executor)
            if hops is not None:
                measured.update(hops)
        self.probe = measured
        if ctrl.is_coordinator:
            log.info("autotune probe: memory %.1f GB/s, allreduce %.1f GB/s "
                     "-> initial fusion threshold %d bytes%s",
                     measured["hbm_gbps"], measured["allreduce_gbps"],
                     cfg.fusion_threshold_bytes,
                     " (cached)" if measured["cached"] else "")

    def _make_param_manager(self):
        """The coordinator's tuner, its sweep and search box from what
        this data plane consults and the probe cache's rooflines."""
        from horovod_tpu_torch.autotune import probe
        from horovod_tpu_torch.autotune.parameter_manager import (
            ParameterManager, Params, normalize_codec,
            search_box_from_roofline)
        from horovod_tpu_torch.parallel import buckets, zero

        cfg = self.config
        initial = Params(
            fusion_threshold_bytes=cfg.fusion_threshold_bytes,
            cycle_time_ms=cfg.cycle_time_ms,
            cache_enabled=self.controller.cache_enabled,
            hierarchical_allreduce=cfg.hierarchical_allreduce,
            hierarchical_allgather=cfg.hierarchical_allgather,
            hierarchy_group_size=cfg.hierarchy_group_size,
            hierarchy_compression=normalize_codec(
                cfg.hierarchy_compression),
            grad_bucket_bytes=buckets.bucket_bytes_from_env(),
            cycle_pipeline_depth=cfg.cycle_pipeline_depth,
            zero_prefetch_buckets=zero.prefetch_buckets_from_env())
        sweep = ["cache_enabled"] if cfg.cache_capacity > 0 else []
        if self.executor.hierarchical_available():
            sweep += ["hierarchical_allreduce", "hierarchy_compression",
                      "hierarchical_allgather"]
        roofline = probe.load_cached_roofline(world=self.controller.world)
        return ParameterManager(
            initial,
            warmup_samples=cfg.autotune_warmup_samples,
            steps_per_sample=cfg.autotune_steps_per_sample,
            bayes_opt_max_samples=cfg.autotune_bayes_opt_max_samples,
            gp_noise=cfg.autotune_gaussian_process_noise,
            log_path=cfg.autotune_log, rank=self.controller.rank,
            sweep=tuple(sweep), bounds=search_box_from_roofline(roofline))

    def _autotune_sync(self, nbytes: int, seconds: float) -> None:
        """The coordinator scores the cycle and broadcasts its knobs; every
        rank applies them at this cycle boundary (reference:
        SynchronizeParameters, controller.cc:32-46)."""
        from horovod_tpu_torch import comms
        from horovod_tpu_torch.autotune.parameter_manager import (
            COMPRESSION_CODECS, Params, normalize_codec)
        from horovod_tpu_torch.parallel import buckets, zero

        blob = None
        if self.param_manager is not None:
            self.param_manager.update(
                nbytes, seconds, busbw_gbs=comms.data_lane_busbw_gbs())
            blob = self.param_manager.params().pack()
        blob = bytes(self.controller.bcast_blob(blob))
        params = Params.unpack(blob)
        cfg = self.config
        cfg.fusion_threshold_bytes = params.fusion_threshold_bytes
        self.fusion_threshold = params.fusion_threshold_bytes
        cfg.cycle_time_ms = params.cycle_time_ms
        self._cycle_time_s = params.cycle_time_ms / 1000.0
        cfg.hierarchical_allreduce = params.hierarchical_allreduce
        cfg.hierarchical_allgather = params.hierarchical_allgather
        cfg.hierarchy_group_size = params.hierarchy_group_size
        cfg.hierarchy_compression = params.hierarchy_compression
        if params.cycle_pipeline_depth > 0:
            cfg.cycle_pipeline_depth = params.cycle_pipeline_depth
            self.depth = params.cycle_pipeline_depth
            self.executor.fusion_buffers.grow(self.depth)
        if params.grad_bucket_bytes > 0:
            buckets.set_autotuned_bucket_bytes(params.grad_bucket_bytes)
        if params.zero_prefetch_buckets > 0:
            zero.set_autotuned_prefetch_buckets(params.zero_prefetch_buckets)
        self.controller.cache_enabled = params.cache_enabled
        if blob != self._applied_params_blob:
            # one event and a gauge refresh a change, on every rank
            self._applied_params_blob = blob
            codec = COMPRESSION_CODECS.index(
                normalize_codec(params.hierarchy_compression))
            for knob, val in (
                    ("fusion_threshold_bytes",
                     params.fusion_threshold_bytes),
                    ("cycle_time_ms", params.cycle_time_ms),
                    ("cache_enabled", int(params.cache_enabled)),
                    ("hierarchical_allreduce",
                     int(params.hierarchical_allreduce)),
                    ("hierarchical_allgather",
                     int(params.hierarchical_allgather)),
                    ("hierarchy_group_size", params.hierarchy_group_size),
                    ("hierarchy_compression_codec", codec),
                    ("grad_bucket_bytes", params.grad_bucket_bytes),
                    ("cycle_pipeline_depth", params.cycle_pipeline_depth),
                    ("zero_prefetch_buckets", params.zero_prefetch_buckets),
                    ("active", int(params.active))):
                _AUTOTUNE_PARAM.labels(knob=knob).set(float(val))
            _AUTOTUNE_COMMITS.inc()
            flight_recorder.emit(
                "autotune_commit",
                fusion_threshold_bytes=params.fusion_threshold_bytes,
                cycle_time_ms=round(params.cycle_time_ms, 3),
                cache_enabled=params.cache_enabled,
                hierarchical_allreduce=params.hierarchical_allreduce,
                hierarchical_allgather=params.hierarchical_allgather,
                hierarchy_group_size=params.hierarchy_group_size,
                hierarchy_compression=params.hierarchy_compression,
                grad_bucket_bytes=params.grad_bucket_bytes,
                cycle_pipeline_depth=params.cycle_pipeline_depth,
                zero_prefetch_buckets=params.zero_prefetch_buckets,
                active=params.active)
        if not params.active:
            self._autotune_active = False

    def in_flight(self) -> int:
        """Named ops enqueued and not yet handed back (the table's size)."""
        return len(self.queue)

    def _debug_state(self) -> dict:
        """The flight recorder's ``runtime`` state: the table's names, the
        ops in the cycle's pipeline with their ages, the failure. Read
        without a lock: a dying process must not wait on a wedged cycle
        thread, so the values are a best-effort view."""
        ops = []
        for tok in list(self._cycle_pending or ()):
            ops.append({"op": tok.op, "name": tok.name0,
                        "bytes": tok.nbytes, "bucket": None,
                        "age_seconds": round(time.perf_counter() - tok.t0,
                                             3)})
        return {
            "in_flight_names": sorted(self.queue._table),
            "pending_ops": ops,
            "failure": repr(self.failure) if self.failure else None,
            "stopped": self._stop.is_set(),
        }

    def _emit_timeline_counters(self) -> None:
        """One ``"C"`` event a series each cycle, in the trace's clock
        domain, so the counters' curves line up with the tensors' bars."""
        self.timeline.counters({
            "queue_depth": queue_mod._QUEUE_DEPTH.value,
            "cache_hits": cache_mod._CACHE_HITS.value,
            "cache_misses": cache_mod._CACHE_MISSES.value,
            "fusion_bytes": fusion_mod._FUSED_BYTES.value,
            "cycles": _CYCLES.value,
        })

    def _finalize(self) -> None:
        self.queue.finalize(types.Status.Aborted(types.SHUT_DOWN_ERROR))
        # after a failure the comm stream may hold a collective a dead peer
        # never joins: no wait for it here (shutdown aborts the group)
        self.executor.close(wait=self.failure is None)
        if self.timeline is not None:
            self.timeline.close()
            self.timeline = None

    def stop(self) -> None:
        """reference: horovod_shutdown: pending entries fail with
        SHUT_DOWN_ERROR (operations.cc:480-486). In a lockstep world the
        shutdown goes out as the SHOULD_SHUT_DOWN bit, so every worker
        leaves its loop in the same cycle (response_cache.h:128-132)."""
        self._deliberate_stop = True
        flight_recorder.emit("runtime_stop")
        if self.controller.lockstep and self._thread.is_alive():
            self.controller.request_shutdown()
            self._woken.set()
            self._urgent.set()
            self._thread.join(timeout=10.0)
        self._stop.set()
        self._woken.set()
        self._urgent.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            log.warning("background loop did not stop within 10s")
            self.queue.finalize(types.Status.Aborted(types.SHUT_DOWN_ERROR))
        # the tuner's commits end with the runtime that made them: a later
        # init (or a re-form) starts from the environment's values
        from horovod_tpu_torch.parallel import buckets, zero
        buckets.set_autotuned_bucket_bytes(0)
        zero.set_autotuned_prefetch_buckets(0)


_runtime_init_lock = threading.Lock()


def get_runtime() -> Runtime:
    """Start the runtime at first use (reference: InitializeHorovodOnce):
    ``LocalController`` at world 1, ``GlooController`` on the control group
    above it; the data group and the device are ``init()``'s."""
    st = state_mod.global_state()
    rt = st.runtime
    if rt is not None:
        return rt
    with _runtime_init_lock:
        if not st.initialized:
            raise NotInitializedError()
        if st.runtime is None:
            cfg = st.config
            if st.size == 1:
                controller = LocalController(0, 1, cfg.cache_capacity,
                                             cfg.native_cycle)
            else:
                controller = GlooController(st.rank, st.size,
                                            st.control_group,
                                            cfg.cache_capacity,
                                            cfg.native_cycle)
            st.runtime = Runtime(controller, st.device, st.data_group, cfg)
        return st.runtime
