"""The controller of a multi-process world: negotiation verbs on a gloo
process group (the port's counterpart of
``horovod_tpu/runtime/socket_controller.py``; the reference's own design,
horovod/common/gloo/gloo_controller.cc).

``init()`` creates the group (``dist.new_group(backend="gloo")``) beside
the runtime's data group. It is gloo on the card too: the cache
bitvectors are reduced with bitwise AND and OR, which NCCL does not have,
and the verbs move small host-side blobs. Only the runtime's cycle thread
issues collectives on it, so no caller's call interleaves with a cycle's.

``init()`` makes the group with ``HOROVOD_GLOO_TIMEOUT_SECONDS`` (default
30) as its timeout. A verb that fails because a peer went away (the
connection closed by the peer or reset, or the timeout ran out) raises
:class:`~horovod_tpu_torch.exceptions.WorkerLostError`, which the runtime
lifts into every waiting handle and ``@hvd.elastic.run`` answers with a
re-form (:func:`lost_worker`). Every verb passes the chaos seam
(``resilience.inject("ctrl", verb)``) first.

Not ported: the socket controller's reconnect, and the native TCP host ring
(``native.py``, ``cpp/net.cc``): the gloo group is also the CPU data plane.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.exceptions import WorkerLostError, WorkersDownError
from horovod_tpu_torch.runtime import message as msg
from horovod_tpu_torch.runtime.controller import Controller
from horovod_tpu_torch.runtime.response_cache import CacheCoordinator
from horovod_tpu_torch.utils import resilience

# what gloo and NCCL say when a peer went away: its process exited (the
# socket closed or reset), or it stopped answering (a timeout)
_LOST_MARKERS = ("closed by peer", "connection reset", "reset by peer",
                 "broken pipe", "connection refused", "timed out",
                 "timeout", "socket closed", "remote process exited",
                 "nccl communicator was aborted")


def lost_worker(exc: BaseException) -> Optional[WorkerLostError]:
    """The typed verdict of a transport error that means a peer went
    away, or None when ``exc`` says something else."""
    if isinstance(exc, WorkersDownError):
        return exc if isinstance(exc, WorkerLostError) else None
    text = str(exc).lower()
    if isinstance(exc, (ConnectionError, TimeoutError)) \
            or any(m in text for m in _LOST_MARKERS):
        return WorkerLostError(
            f"control-plane peer lost in generation "
            f"{resilience.current_generation()}: "
            f"{type(exc).__name__}: {exc}")
    return None


def _verb(fn):
    """A negotiation verb: the chaos seam first, and a lost peer's error
    raised as :class:`WorkerLostError`."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        try:
            resilience.inject("ctrl", fn.__name__)
            return fn(self, *args, **kwargs)
        except Exception as exc:
            lost = lost_worker(exc)
            if lost is None or lost is exc:
                raise
            raise lost from exc

    return wrapper

_WORD_BITS = 63  # bits per int64 word of the bitvector: every word >= 0


def _as_tensor(blob: bytes, length: int) -> torch.Tensor:
    buf = torch.zeros(length, dtype=torch.uint8)
    if blob:
        buf[:len(blob)] = torch.from_numpy(np.frombuffer(blob, np.uint8)
                                           .copy())
    return buf


class GlooController(Controller):
    """Rank 0 coordinates; the verbs are collectives on ``group``."""

    def __init__(self, rank: int, world: int, group,
                 cache_capacity: int = 1024, native_engine=None):
        super().__init__(rank, world, cache_capacity, native_engine)
        self.group = group
        # cache bits stay below the capacity (freed bits are reused first)
        self._words = max(1, -(-(max(cache_capacity, 0)
                                 + CacheCoordinator.NUM_STATUS_BITS)
                               // _WORD_BITS))

    @_verb
    def sync_bitvectors(self, bits: int) -> Tuple[int, int]:
        if bits >> (_WORD_BITS * self._words):
            raise ValueError(f"cache bitvector wider than {self._words} "
                             "words: a cache bit beyond the capacity")
        mask = (1 << _WORD_BITS) - 1
        words = [(bits >> (_WORD_BITS * i)) & mask
                 for i in range(self._words)]
        anded = torch.tensor(words, dtype=torch.int64)
        ored = anded.clone()
        dist.all_reduce(anded, op=dist.ReduceOp.BAND, group=self.group)
        dist.all_reduce(ored, op=dist.ReduceOp.BOR, group=self.group)

        def join(t):
            return sum(int(w) << (_WORD_BITS * i)
                       for i, w in enumerate(t.tolist()))

        return join(anded), join(ored)

    def _gather(self, blob: bytes) -> Optional[List[bytes]]:
        """Every worker's blob on rank 0 (None elsewhere)."""
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(self.world)]
        dist.all_gather(sizes, torch.tensor([len(blob)], dtype=torch.int64),
                        group=self.group)
        sizes = [int(s) for s in sizes]
        longest = max(max(sizes), 1)
        mine = _as_tensor(blob, longest)
        bufs = ([torch.empty(longest, dtype=torch.uint8)
                 for _ in range(self.world)] if self.is_coordinator else None)
        dist.gather(mine, bufs, dst=0, group=self.group)
        if not self.is_coordinator:
            return None
        return [b[:n].numpy().tobytes() for b, n in zip(bufs, sizes)]

    @_verb
    def bcast_blob(self, blob: Optional[bytes]) -> bytes:
        size = torch.tensor([len(blob) if self.is_coordinator else 0],
                            dtype=torch.int64)
        dist.broadcast(size, src=0, group=self.group)
        n = int(size)
        if n == 0:
            return b""
        buf = (_as_tensor(blob, n) if self.is_coordinator
               else torch.empty(n, dtype=torch.uint8))
        dist.broadcast(buf, src=0, group=self.group)
        return buf.numpy().tobytes()

    @_verb
    def allgather_blob(self, blob: bytes) -> List[bytes]:
        mine = _as_tensor(blob, len(blob))
        bufs = [torch.empty(len(blob), dtype=torch.uint8)
                for _ in range(self.world)]
        dist.all_gather(bufs, mine, group=self.group)
        return [b.numpy().tobytes() for b in bufs]

    @_verb
    def send_ready_tensors(self, requests):
        blobs = self._gather(msg.pack_request_list(requests))
        if blobs is None:
            return None
        return [msg.unpack_request_list(b) for b in blobs]

    def bcast_responses(self, responses):  # a verb through bcast_blob
        blob = (msg.pack_response_list(responses) if self.is_coordinator
                else None)
        return msg.unpack_response_list(self.bcast_blob(blob))

    @_verb
    def barrier(self) -> None:
        dist.barrier(group=self.group)
