"""Thread-safe named-tensor queue (port of
``horovod_tpu/runtime/tensor_queue.py``; reference:
horovod/common/tensor_queue.cc/.h).

Caller threads add ``TensorTableEntry``s and negotiation ``Request``s; the
background cycle pops pending requests and takes entries out when their
responses arrive. A name already in flight is rejected (reference:
tensor_queue.cc:26-29). The queue's depth and the names it has accepted
are metrics (``horovod_tensor_queue_depth``,
``horovod_tensor_queue_enqueued_total``).
"""

from __future__ import annotations

import threading
from typing import Dict, List

from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.runtime import message as msg
from horovod_tpu_torch.runtime import types

_QUEUE_DEPTH = _metrics().gauge(
    "horovod_tensor_queue_depth",
    "Named tensors enqueued and not yet handed to the executor.")
_ENQUEUED = _metrics().counter(
    "horovod_tensor_queue_enqueued_total",
    "Named tensors accepted into the tensor queue.")


class DuplicateNameError(ValueError):
    pass


class TensorQueue:
    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[str, types.TensorTableEntry] = {}  # guarded-by: _lock
        self._pending: List[tuple] = []  # (-priority, seq, request); guarded-by: _lock
        self._seq = 0  # guarded-by: _lock

    def add(self, entry: types.TensorTableEntry, request: msg.Request) -> None:
        """reference: TensorQueue::AddToTensorQueue (tensor_queue.cc:18-36)."""
        self.add_group([entry], [request])

    def add_group(self, entries: List[types.TensorTableEntry],
                  requests: List[msg.Request]) -> None:
        """Add a group under one lock acquisition, so one negotiation cycle
        sees all of it; the duplicate check is all-or-nothing: a clash on
        any name leaves the table untouched."""
        if len(entries) != len(requests):
            raise ValueError("entries and requests must pair up")
        with self._lock:
            names = set()
            for entry in entries:
                if entry.name in self._table or entry.name in names:
                    raise DuplicateNameError(
                        types.DUPLICATE_NAME_ERROR_FMT.format(
                            op=entry.request_type.lower()))
                names.add(entry.name)
            for entry, request in zip(entries, requests):
                self._table[entry.name] = entry
                self._pending.append((-entry.priority, self._seq, request))
                self._seq += 1
            _ENQUEUED.inc(len(entries))
            _QUEUE_DEPTH.set(len(self._table))

    def pop_requests(self) -> List[msg.Request]:
        """Drain this cycle's negotiation messages, highest priority first,
        enqueue order within a priority (reference: PopMessagesFromQueue,
        controller.cc:68)."""
        with self._lock:
            pending, self._pending = self._pending, []
        return [r for _, _, r in sorted(pending, key=lambda p: p[:2])]

    def get_entries(self, names: List[str]) -> List[types.TensorTableEntry]:
        """Remove and return the entries of a (fused) response (reference:
        GetTensorEntriesFromResponse, tensor_queue.cc:71). Missing names
        are skipped: a partial failure must not strand the entries that
        were popped with their callbacks unfired."""
        with self._lock:
            out = [e for e in (self._table.pop(n, None) for n in names)
                   if e is not None]
            _QUEUE_DEPTH.set(len(self._table))
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)

    def finalize(self, status: types.Status) -> None:
        """Fail every entry in flight (reference: FinalizeTensorQueue:
        SHUT_DOWN_ERROR to all pending)."""
        with self._lock:
            entries = list(self._table.values())
            self._table.clear()
            self._pending.clear()
            _QUEUE_DEPTH.set(0)
        for e in entries:
            e.complete(status, None)
