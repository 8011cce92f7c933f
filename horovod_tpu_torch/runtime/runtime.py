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

Not ported yet: autotune (ROADMAP A8), the elastic and resilience hooks
and typed worker-loss errors (A10), tracing, the flight recorder and the
lane-hazard watchdog (A11).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, List, Optional

import torch

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
from horovod_tpu_torch.runtime.gloo_controller import GlooController
from horovod_tpu_torch.runtime.tensor_queue import TensorQueue
from horovod_tpu_torch.stall import StallInspector, StragglerTracker
from horovod_tpu_torch.timeline import Timeline
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils import logging as log

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

    __slots__ = ("name", "_lock", "_status", "_output", "_done")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._lock.acquire()
        self._status: Optional[types.Status] = None
        self._output: Any = None
        self._done = None  # executor.Done of the result, on the card

    def _complete(self, status: types.Status, output, done=None) -> None:
        self._output = output
        self._done = done
        self._status = status
        self._lock.release()

    def poll(self) -> bool:
        """True once the result is ready (on the card: once the device has
        run the collective)."""
        return self._status is not None and (self._done is None
                                             or self._done.event.query())

    def wait(self, timeout: Optional[float] = None):
        """Block until the runtime has queued the collective, then order
        the caller's current stream after it (no host wait on the device).
        A failed collective raises: ValueError for an invalid argument,
        RuntimeError otherwise."""
        if self._status is None:
            t0 = time.monotonic()
            got = self._lock.acquire(timeout=-1 if timeout is None
                                     else timeout)
            _HANDLE_WAIT.observe(time.monotonic() - t0)
            if not got:
                raise TimeoutError(f"collective '{self.name}' did not "
                                   f"complete within {timeout}s")
            self._lock.release()
        else:
            _HANDLE_WAIT.observe(0.0)
        if not self._status.ok():
            exc = (ValueError
                   if self._status.type == types.StatusType.INVALID_ARGUMENT
                   else RuntimeError)
            raise exc(f"collective '{self.name}' failed: "
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
            cfg.fusion_bucket_quantum, self.depth)
        # the coordinator writes the timeline (reference: operations.cc)
        self.timeline = (Timeline(cfg.timeline_file,
                                  mark_cycles=cfg.timeline_mark_cycles,
                                  native_engine=controller.native_engine)
                         if cfg.timeline_file and controller.is_coordinator
                         else None)
        self.stall_inspector = StallInspector(
            warning_time_seconds=cfg.stall_check_time_seconds,
            shutdown_time_seconds=cfg.stall_shutdown_time_seconds,
            enabled=not cfg.stall_check_disable)
        if controller.is_coordinator:
            controller.straggler = StragglerTracker(
                world=controller.world,
                report_seconds=cfg.straggler_report_seconds)
        # stale deferred hits renegotiate on the stall warning's clock
        self.controller.STALE_HIT_SECONDS = cfg.stall_check_time_seconds
        self._stop = threading.Event()
        self._woken = threading.Event()   # work was enqueued
        self._urgent = threading.Event()  # start a cycle now: no pacing
        self._thread = threading.Thread(
            target=self._run_loop, daemon=True, name="hvd-background-loop")
        self._thread.start()

    # -- enqueue APIs (reference: operations.cc:736-843) -------------------
    def _check_running(self) -> None:
        if self._stop.is_set():
            raise RuntimeError(types.SHUT_DOWN_ERROR)

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
        handle = RuntimeHandle(name)
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

    def _enqueue(self, request_type: str, name: str, tensor, **kw
                 ) -> RuntimeHandle:
        self._check_running()
        entry, request, handle = self._entry(request_type, name, tensor, **kw)
        self.queue.add(entry, request)  # DuplicateNameError on misuse
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
        self.queue.add_group([m[0] for m in made], [m[1] for m in made])
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
            try:
                keep_going = self.run_cycle()
            except Exception:
                log.get_logger().exception("background cycle failed")
                # in a lockstep world a failed cycle leaves the peers'
                # collectives unmatched: the runtime goes down
                keep_going = not self.controller.lockstep
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
            return self._run_cycle_body(requests)
        except Exception:
            # the popped entries would otherwise stay in the table with
            # their handles never completing: fail them loudly
            status = types.Status.Aborted(
                "background cycle failed; see runtime log")
            for e in self.queue.get_entries(
                    [r.tensor_name for r in requests]):
                e.complete(status, None)
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
        _CYCLE_TENSORS.observe(sum(len(r.tensor_names) for r in responses))
        pending: "collections.deque" = collections.deque()
        cycle_entries = []
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
                    response, entries, timeline=self.timeline))
                _PIPELINE_DEPTH.set(len(pending))
                while len(pending) >= self.depth:
                    self._drain_one(pending)
            while pending:
                self._drain_one(pending)
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
        op.complete()

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
        self.executor.close()
        if self.timeline is not None:
            self.timeline.close()
            self.timeline = None

    def stop(self) -> None:
        """reference: horovod_shutdown: pending entries fail with
        SHUT_DOWN_ERROR (operations.cc:480-486). In a lockstep world the
        shutdown goes out as the SHOULD_SHUT_DOWN bit, so every worker
        leaves its loop in the same cycle (response_cache.h:128-132)."""
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
