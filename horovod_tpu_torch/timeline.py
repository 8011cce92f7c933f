"""Chrome-trace timeline of the enqueue runtime (port of the Python writer
in ``horovod_tpu/timeline.py``; reference: horovod/common/timeline.cc/.h,
docs/timeline.rst:6-21).

``HOROVOD_TIMELINE=/path/trace.json`` makes the coordinator (rank 0) write
a JSON trace in Chrome's "JSON Array" format: per named tensor the
NEGOTIATE phase (when each rank announced it), the top-level operation,
and its activities: ``MEMCPY_IN_FUSION_BUFFER``, the collective
(``NCCL_ALLREDUCE`` on the card, ``GLOO_ALLREDUCE`` on the CPU, and so on)
and ``MEMCPY_OUT_FUSION_BUFFER``. The times are when the runtime's thread
queued each piece, on the host's clock in epoch microseconds; on the card
the device runs them later.

The hot path never blocks on file I/O: events go through a queue to a
writer thread (reference: timeline.h:66-75). The native writer
(``cpp/timeline.cc``), cycle markers and trace merging are not ported yet.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Optional

MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"


class _Writer:
    """Background thread draining an event queue into the file (reference:
    TimelineWriter, timeline.cc:28-127)."""

    _CLOSE = object()

    def __init__(self, path: str):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._file = open(path, "w")
        self._file.write("[\n")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hvd-timeline-writer")
        self._thread.start()

    def emit(self, event: dict) -> None:
        self._q.put(event)

    def close(self) -> None:
        self._q.put(self._CLOSE)
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        try:
            while True:
                item = self._q.get()
                if item is self._CLOSE:
                    break
                self._file.write(json.dumps(item) + ",\n")
                if self._q.empty():
                    self._file.flush()
        finally:
            # a complete array: an empty object closes the trailing comma
            self._file.write("{}]\n")
            self._file.close()


class Timeline:
    """Per-tensor tracing (reference: timeline.h:77-131): each tensor is a
    "process" lane of its own, named at first sight."""

    def __init__(self, path: str):
        self._writer = _Writer(path)
        self._lock = threading.Lock()
        self._tensor_pids: dict = {}

    def _emit(self, tensor_name: str, ph: str,
              name: Optional[str] = None) -> None:
        with self._lock:
            ts = time.time_ns() / 1e3
            pid = self._tensor_pids.get(tensor_name)
            if pid is None:
                pid = len(self._tensor_pids) + 1
                self._tensor_pids[tensor_name] = pid
                self._writer.emit({"ph": "M", "pid": pid, "ts": ts,
                                   "name": "process_name",
                                   "args": {"name": tensor_name}})
            event = {"ph": ph, "pid": pid, "ts": ts}
            if name:
                event["name"] = name
            self._writer.emit(event)

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

    def end(self, tensor_name: str) -> None:
        self._emit(tensor_name, "E")

    def close(self) -> None:
        with self._lock:
            self._writer.close()
