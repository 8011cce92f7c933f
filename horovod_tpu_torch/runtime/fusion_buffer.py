"""Fusion buffers: the size-bucket policy of flat fused payloads and the
persistent slabs the executor packs fused allreduces into (port of
``bucket_elems`` and ``FusionBufferManager`` in
``horovod_tpu/runtime/fusion_buffer.py:91-105, 143``; reference:
horovod/common/fusion_buffer_manager.cc).

ZeRO's flat layout pads each per-rank shard to a bucket, so every rank's
shard has the same length. The executor leases one slab a fused bin: a
torch tensor on the op's device, sized by the bucket of the larger of the
bin and the fusion threshold, so bins that regroup from cycle to cycle
reuse the same slabs.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import torch

from horovod_tpu_torch.runtime import types


def bucket_elems(nelems: int, itemsize: int, quantum_bytes: int) -> int:
    """Element count of the size bucket holding ``nelems`` items.

    Payloads at or under the quantum keep their exact size; larger ones
    round up to the next power-of-two multiple of the quantum."""
    nbytes = nelems * itemsize
    if quantum_bytes <= 0 or nbytes <= quantum_bytes:
        return nelems
    bucket = quantum_bytes
    while bucket < nbytes:
        bucket <<= 1
    return -(-bucket // itemsize)  # ceil: quantum need not divide itemsize


class BufferLease:
    """One checked-out slab: ``tensor`` is 1-D with ``capacity`` elements;
    the bin uses ``tensor[:n]``."""

    __slots__ = ("tensor", "capacity", "_key", "_released")

    def __init__(self, tensor: torch.Tensor, key: tuple):
        self.tensor = tensor
        self.capacity = tensor.numel()
        self._key = key
        self._released = False


class FusionBufferManager:
    """Reusable slabs keyed by (bucket, dtype, device).

    ``acquire`` hands out a free slab of the key. A key's first acquire
    allocates all of its ``max_per_key`` slabs (the cycle pipeline depth,
    which bounds the leases out at once), so a run allocates slabs only for
    keys it has not seen: a model's bins take their keys in the first step
    (the threshold's bucket, or a tensor's own at threshold 0), and no
    later cycle allocates, however its bins come to be in flight together.
    Lazily, one slab a lease, a key's second slab waited for the first step
    in which two of its bins were in flight at once. ``release``
    returns a slab once the work that reads it is ordered before any reuse:
    on the card, every use of a slab is on the runtime's one comm stream.
    Slabs are allocated on the thread's current stream, the comm stream on
    the card.
    """

    def __init__(self, quantum_bytes: int, floor_bytes: int,
                 max_per_key: int):
        self.quantum_bytes = int(quantum_bytes)
        self.floor_bytes = int(floor_bytes)
        self.max_per_key = max(1, int(max_per_key))
        self._lock = threading.Lock()
        self._free: Dict[Tuple, List[torch.Tensor]] = {}  # guarded-by: _lock
        self._count: Dict[Tuple, int] = {}  # guarded-by: _lock

    def capacity(self, nelems: int, itemsize: int) -> int:
        floor = -(-self.floor_bytes // itemsize)
        return bucket_elems(max(int(nelems), floor), itemsize,
                            self.quantum_bytes)

    def acquire(self, nelems: int, dtype: torch.dtype,
                device: torch.device) -> BufferLease:
        key = (self.capacity(nelems, dtype.itemsize), dtype, device)
        with self._lock:
            if key not in self._count:
                self._count[key] = self.max_per_key
                self._free[key] = [
                    torch.empty(key[0], dtype=dtype, device=device)
                    for _ in range(self.max_per_key)]
                types.COUNTS["slabs"] += self.max_per_key
            free = self._free[key]
            if not free:
                raise RuntimeError(
                    f"fusion slab {key}: more than {self.max_per_key} leases "
                    "out at once (the pipeline depth bounds them)")
            return BufferLease(free.pop(), key)

    def release(self, lease: BufferLease) -> None:
        """Return a lease's slab. Idempotent: failure paths may release the
        same lease from more than one unwind."""
        with self._lock:
            if lease._released:
                return
            lease._released = True
            self._free.setdefault(lease._key, []).append(lease.tensor)

    def slabs(self) -> int:
        with self._lock:
            return sum(self._count.values())
