"""Chrome-trace timeline of the enqueue runtime (port of
``horovod_tpu/timeline.py``; reference: horovod/common/timeline.cc/.h,
docs/timeline.rst:6-21).

``HOROVOD_TIMELINE=/path/trace.json`` makes the coordinator (rank 0) write
a JSON trace in Chrome's "JSON Array" format: per named tensor the
NEGOTIATE phase (when each rank announced it), the top-level operation,
and its activities: ``MEMCPY_IN_FUSION_BUFFER``, the collective
(``NCCL_ALLREDUCE`` on the card, ``GLOO_ALLREDUCE`` on the CPU, and so on)
and ``MEMCPY_OUT_FUSION_BUFFER``. Each cycle adds one ``"C"`` counter
event a series on pid 0 (queue depth, cache hits and misses, fused bytes,
cycles: :meth:`Timeline.counters`) and, with
``HOROVOD_TIMELINE_MARK_CYCLES``, an instant ``CYCLE_<n>`` marker. The
times are when the runtime's thread queued each piece, on the host's clock
in epoch microseconds (one clock domain across ranks, so
:func:`merge_traces` interleaves several ranks' files truthfully); on the
card the device runs them later.

The hot path never blocks on file I/O: events go to a writer thread
(reference: timeline.h:66-75). With ``HOROVOD_NATIVE_CYCLE`` on (the
default) the writer is the C++ one (``cpp/timeline.cc``: a lock-free ring
and its own thread; an event that does not fit is dropped and counted),
else a Python thread draining a queue. Either writes the drop count as a
last ``dropped_events`` metadata record at close, zero included. Unlike the
JAX package, a native writer that cannot be built raises instead of
falling back to the Python one.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Optional

from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import env

_TL_DROPPED = _metrics().counter(
    "horovod_timeline_dropped_events_total",
    "Timeline events discarded after the writer became unhealthy or its "
    "ring overflowed.")

MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"


class _NativeWriter:
    """The C++ writer (``hvd_tl_*``): a lock-free SPSC ring drained by a
    thread of its own (the reference's boost spsc_queue + TimelineWriter,
    timeline.h:66-75)."""

    def __init__(self, path: str):
        from horovod_tpu_torch.runtime import native

        self._lib = native.load()
        self._handle = self._lib.hvd_tl_open(path.encode())
        if not self._handle:
            raise OSError(f"could not open timeline file {path!r}")
        self.dropped = 0

    def emit(self, ph: str, pid: int, ts_us: float,
             name: Optional[str] = None, args: Optional[dict] = None,
             s: Optional[str] = None) -> None:
        if not self._handle:  # closed: drop rather than use after free
            self._drop()
            return
        if self._lib.hvd_tl_emit(
                self._handle, ph.encode(), pid, ts_us,
                name.encode() if name else None,
                json.dumps(args).encode() if args else None,
                s.encode() if s else None):
            self._drop()  # the ring was full or the event too large

    def _drop(self) -> None:
        self.dropped += 1
        _TL_DROPPED.inc()

    def close(self) -> None:
        if self._handle:
            handle, self._handle = self._handle, None
            self._lib.hvd_tl_close(handle)


class _Writer:
    """The Python writer: a thread draining an event queue into the file
    (reference: TimelineWriter, timeline.cc:28-127). It flushes whenever
    the queue runs dry and once a second, so a killed process leaves a
    readable (truncated) trace."""

    _CLOSE = object()

    def __init__(self, path: str):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._file = open(path, "w")
        self._file.write("[\n")
        self._healthy = True
        self.dropped = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hvd-timeline-writer")
        self._thread.start()

    def emit(self, ph: str, pid: int, ts_us: float,
             name: Optional[str] = None, args: Optional[dict] = None,
             s: Optional[str] = None) -> None:
        if not self._healthy:
            self._drop()
            return
        event = {"ph": ph, "pid": pid, "ts": ts_us}
        if name:
            event["name"] = name
        if args:
            event["args"] = args
        if s:
            event["s"] = s
        self._q.put(event)

    def _drop(self) -> None:
        self.dropped += 1
        _TL_DROPPED.inc()

    def close(self) -> None:
        self._q.put(self._CLOSE)
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        try:
            while True:
                try:
                    item = self._q.get(timeout=1.0)
                except queue.Empty:
                    self._flush()
                    continue
                if item is self._CLOSE:
                    break
                if not self._healthy:
                    self._drop()
                    continue
                try:
                    self._file.write(json.dumps(item) + ",\n")
                    if self._q.empty():
                        self._flush()
                except (OSError, ValueError):
                    self._healthy = False
                    self._drop()
        finally:
            # the drop count, then an empty object that closes the array
            try:
                self._file.write(json.dumps(
                    {"ph": "M", "pid": 0, "name": "dropped_events",
                     "args": {"count": self.dropped}}) + ",\n{}]\n")
                self._file.close()
            except (OSError, ValueError):
                pass
            self._healthy = False

    def _flush(self) -> None:
        if not self._healthy:
            return
        try:
            self._file.flush()
        except (OSError, ValueError):
            self._healthy = False


class Timeline:
    """Per-tensor tracing (reference: timeline.h:77-131): each tensor is a
    "process" lane of its own, named at first sight. Thread-safe: the
    emitting side holds a lock; file I/O happens on the writer's thread.
    ``native_engine`` picks the writer (default ``HOROVOD_NATIVE_CYCLE``)."""

    def __init__(self, path: str, mark_cycles: bool = False,
                 native_engine: Optional[bool] = None):
        if native_engine is None:
            native_engine = env.native_cycle()
        self._writer = (_NativeWriter if native_engine else _Writer)(path)
        self._mark_cycles = mark_cycles
        self._lock = threading.Lock()
        self._tensor_pids: dict = {}
        self._next_pid = 1
        self._cycle = 0

    @property
    def dropped(self) -> int:
        """Events dropped so far (written into the trace at close)."""
        return self._writer.dropped

    @staticmethod
    def _ts_us() -> float:
        # the epoch, so traces of different ranks align
        return time.time_ns() / 1e3

    def _pid(self, tensor_name: str) -> int:
        pid = self._tensor_pids.get(tensor_name)
        if pid is None:
            pid = self._next_pid
            self._next_pid += 1
            self._tensor_pids[tensor_name] = pid
            self._writer.emit("M", pid, self._ts_us(), name="process_name",
                              args={"name": tensor_name})
        return pid

    def _emit(self, tensor_name: str, ph: str,
              name: Optional[str] = None) -> None:
        with self._lock:
            self._writer.emit(ph, self._pid(tensor_name), self._ts_us(),
                              name=name)

    def negotiate_start(self, tensor_name: str, request_type: str) -> None:
        """The first worker announced the tensor (reference: timeline.cc
        NegotiateStart)."""
        self._emit(tensor_name, "B", f"NEGOTIATE_{request_type}")

    def negotiate_rank_ready(self, tensor_name: str, rank: int) -> None:
        self._emit(tensor_name, "i", f"RANK_{rank}_READY")

    def negotiate_end(self, tensor_name: str) -> None:
        self._emit(tensor_name, "E")

    def start(self, tensor_name: str, op_name: str) -> None:
        self._emit(tensor_name, "B", op_name)

    def activity_start(self, tensor_name: str, activity: str) -> None:
        self._emit(tensor_name, "B", activity)

    def activity_end(self, tensor_name: str) -> None:
        self._emit(tensor_name, "E")

    def end(self, tensor_name: str, op_name: Optional[str] = None) -> None:
        self._emit(tensor_name, "E")

    def counters(self, values: dict) -> None:
        """Chrome ``"C"`` (counter) events, one series a key, all on pid 0
        at one timestamp, so the runtime's counters graph above the
        per-tensor lanes in the same clock domain; the runtime calls this
        once a cycle."""
        with self._lock:
            ts = self._ts_us()
            for name, value in values.items():
                self._writer.emit("C", 0, ts, name=name,
                                  args={"value": value})

    def mark_cycle_start(self) -> None:
        """An instant ``CYCLE_<n>`` marker on pid 0, when the timeline was
        made with ``mark_cycles`` (reference: timeline.h:98,
        HOROVOD_TIMELINE_MARK_CYCLES)."""
        if self._mark_cycles:
            with self._lock:
                self._cycle += 1
                self._writer.emit("i", 0, self._ts_us(),
                                  name=f"CYCLE_{self._cycle}", s="g")

    def close(self) -> None:
        # under the emit lock: no emitter may race the native writer's
        # teardown, which frees its ring
        with self._lock:
            self._writer.close()


def _load_trace_events(path: str) -> list:
    """A Chrome trace's events: plain or gzipped, "JSON Array" or
    ``{"traceEvents": [...]}``; a truncated array (a killed writer's) is
    read as far as it goes."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        data = json.loads(text.rstrip().rstrip(",") + "]")
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    return [e for e in events if isinstance(e, dict) and "ph" in e]


def merge_traces(out_path: str, inputs: list, align: bool = False) -> int:
    """Merge Chrome trace files into one (the JAX package's
    ``tpurun --merge-trace``).

    Each input's pids move into a range of their own (a label metadata
    event names the source file), so several ranks' timelines and device
    traces sit side by side; timestamps are kept, since every producer
    here stamps epoch microseconds. ``align=True`` instead rebases each
    file so that its earliest event sits at a common origin (for producers
    with another zero). Returns the number of events written."""
    merged = []
    pid_base = 0
    for path in inputs:
        events = _load_trace_events(path)
        pids = [e.get("pid", 0) for e in events]
        max_pid = max(pids, default=0)
        tss = [e["ts"] for e in events if isinstance(e.get("ts"),
                                                     (int, float))]
        base_ts = min(tss, default=0.0)
        # label every pid the file uses (a device trace's events may sit
        # on nonzero pids only)
        label = f"[{path.rsplit('/', 1)[-1]}]"
        for orig_pid in sorted(set(pids)):
            merged.append({"ph": "M", "pid": orig_pid + pid_base, "ts": 0,
                           "name": "process_labels",
                           "args": {"labels": label}})
        for e in events:
            e = dict(e)
            e["pid"] = e.get("pid", 0) + pid_base
            if align and isinstance(e.get("ts"), (int, float)):
                e["ts"] = e["ts"] - base_ts
            merged.append(e)
        pid_base += max_pid + 2
    merged.sort(key=lambda e: (e.get("ts") or 0))
    with open(out_path, "w") as f:
        json.dump({"traceEvents": merged}, f)
    return len(merged)
