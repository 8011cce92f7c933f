"""Core runtime types: Status, TensorTableEntry, request/response kinds
(port of ``horovod_tpu/runtime/types.py``; reference:
horovod/common/common.h:118-242).

Entries carry ``torch.Tensor``s. On the card an entry also carries its
producer's CUDA stream (``ready``) and, once the runtime has queued its
collective, the event that marks the result (``done``); the runtime never
blocks the host on either.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Any, Callable, Optional

# reference: horovod/common/message.h RequestType / ResponseType
ALLREDUCE = "ALLREDUCE"
ALLGATHER = "ALLGATHER"
BROADCAST = "BROADCAST"
REDUCESCATTER = "REDUCESCATTER"
ALLTOALL = "ALLTOALL"
ERROR = "ERROR"
# Synchronized cache-invalidation notice: keeps every worker's response
# cache bit-aligned (the reference syncs invalidated bits inside its
# CacheCoordinator protocol, response_cache.cc:308-430).
INVALIDATE = "INVALIDATE"


class StatusType(enum.Enum):
    # reference: common/common.h:124-131
    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


@dataclasses.dataclass(frozen=True)
class Status:
    type: StatusType = StatusType.OK
    reason: str = ""

    def ok(self) -> bool:
        return self.type == StatusType.OK

    def in_progress(self) -> bool:
        return self.type == StatusType.IN_PROGRESS

    @staticmethod
    def OK() -> "Status":
        return Status()

    @staticmethod
    def Aborted(reason: str) -> "Status":
        return Status(StatusType.ABORTED, reason)

    @staticmethod
    def InvalidArgument(reason: str) -> "Status":
        return Status(StatusType.INVALID_ARGUMENT, reason)

    @staticmethod
    def PreconditionError(reason: str) -> "Status":
        return Status(StatusType.PRECONDITION_ERROR, reason)

    @staticmethod
    def UnknownError(reason: str) -> "Status":
        return Status(StatusType.UNKNOWN_ERROR, reason)


# reference error texts (common.h:141-158)
DUPLICATE_NAME_ERROR_FMT = (
    "Requested to {op} a tensor with the same name as another tensor that is "
    "currently being processed. If you want to request another tensor, use a "
    "different tensor name."
)
SHUT_DOWN_ERROR = (
    "Framework has been shut down. This was caused by an exception on one of "
    "the workers or an attempt to run a collective after shutdown."
)

# callback(status, output, done event or None)
StatusCallback = Callable[[Status, Optional[Any], Optional[Any]], None]

# Reduction ops carried on allreduce and reducescatter requests
REDUCE_SUM = "sum"
REDUCE_AVERAGE = "average"
REDUCE_MIN = "min"
REDUCE_MAX = "max"
REDUCE_PRODUCT = "product"
REDUCE_OPS = (REDUCE_SUM, REDUCE_AVERAGE, REDUCE_MIN, REDUCE_MAX,
              REDUCE_PRODUCT)

#: what the runtime did since the last :func:`reset_counts`: collectives
#: issued on its data group per kind, responses executed (a fused bin is
#: one), requests answered from the response cache, fusion slabs
#: allocated, process groups created, cycles run, those that executed a
#: response (counted before any of their handles completes), and the
#: cycles' host ms
COUNTS = {"allreduce": 0, "broadcast": 0, "allgather": 0,
          "reducescatter": 0, "alltoall": 0, "responses": 0,
          "cache_hits": 0, "slabs": 0, "groups": 0, "cycles": 0,
          "busy_cycles": 0, "cycle_ms": 0.0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0.0 if key == "cycle_ms" else 0


def bump(key: str, metric, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[key]`` and to the registry counter ``metric``
    that counts the same event, so the two cannot drift apart (``cycles``
    and ``horovod_cycles_total``, ``slabs`` and
    ``horovod_fusion_buffer_allocs_total``)."""
    COUNTS[key] += n
    metric.inc(n)


# the cycle thread and stop() can race to complete the same entry
_complete_lock = threading.Lock()


@dataclasses.dataclass(slots=True)
class TensorTableEntry:
    """One enqueued named tensor (reference: common/common.h:225-242).

    ``tensor`` is the input; ``output`` is the input itself for an in-place
    allreduce or broadcast, or the tensor a gather or scatter writes,
    allocated at enqueue."""

    name: str
    tensor: Any
    request_type: str = ALLREDUCE
    root_rank: int = 0
    reduce_op: str = REDUCE_AVERAGE
    callback: Optional[StatusCallback] = None
    output: Any = None
    dtype: Any = None
    shape: tuple = ()
    # higher-priority tensors enter negotiation (and fusion) first
    priority: int = 0
    # on the card: the producer's stream at enqueue, and the event of the
    # result once queued
    ready: Any = None
    done: Any = None
    completed: bool = False

    def complete(self, status, output=None) -> None:
        """Fire the completion callback exactly once: success, error,
        shutdown and cycle-failure cleanup all funnel through here. The
        callback gets the status, the output and the ``done`` event."""
        with _complete_lock:
            if self.completed:
                return
            self.completed = True
        if self.callback is not None:
            self.callback(status, output, self.done)


def entry_nbytes(entry: TensorTableEntry) -> int:
    """Payload bytes of one enqueued tensor."""
    return entry.tensor.numel() * entry.tensor.element_size()
