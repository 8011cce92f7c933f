"""Fusion buffers: the size-bucket policy of flat fused payloads and the
persistent slabs the executor packs fused allreduces into (port of
``bucket_elems`` and ``FusionBufferManager`` in
``horovod_tpu/runtime/fusion_buffer.py:91-105, 143``; reference:
horovod/common/fusion_buffer_manager.cc).

ZeRO's flat layout pads each per-rank shard to a bucket, so every rank's
shard has the same length. The executor leases one slab a fused bin: a
torch tensor on the op's device, sized by the bucket of the larger of the
bin and the fusion threshold, so bins that regroup from cycle to cycle
reuse the same slabs. Its allocations, reuses, bytes, live bytes and leases
out are metrics (purpose ``fusion``), summed over every live manager.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Tuple

import torch

from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.runtime import types

_BUF_ALLOCS = _metrics().counter(
    "horovod_fusion_buffer_allocs_total",
    "Persistent fusion-buffer allocations (new (rows, bucket, dtype) "
    "slabs; steady state stops growing).")
_BUF_REUSES = _metrics().counter(
    "horovod_fusion_buffer_reuses_total",
    "Fusion-buffer leases served from an existing slab (no allocation).")
_BUF_BYTES = _metrics().gauge(
    "horovod_fusion_buffer_bytes",
    "Total bytes held in persistent fusion buffers (resident slabs, "
    "leased or free), per purpose.", labelnames=("purpose",))
_BUF_LIVE_BYTES = _metrics().gauge(
    "horovod_fusion_buffer_live_bytes",
    "Bytes in fusion slabs currently checked out on a lease, per purpose. "
    "Returns to 0 between cycles; a leaked lease is visible here.",
    labelnames=("purpose",))
_BUF_LEASES_OUT = _metrics().gauge(
    "horovod_fusion_buffer_leases_outstanding",
    "Fusion-buffer leases acquired and not yet released, per purpose.",
    labelnames=("purpose",))
PURPOSE = "fusion"

# every live manager (weak: a stopped runtime's manager just goes away)
_managers_lock = threading.Lock()
_managers: "weakref.WeakSet" = weakref.WeakSet()  # guarded-by: _managers_lock


def _refresh_gauges() -> None:
    with _managers_lock:
        managers = list(_managers)
    total = live = leases = 0
    for mgr in managers:
        t, li, le = mgr.usage()
        total, live, leases = total + t, live + li, leases + le
    _BUF_BYTES.labels(purpose=PURPOSE).set(total)
    _BUF_LIVE_BYTES.labels(purpose=PURPOSE).set(live)
    _BUF_LEASES_OUT.labels(purpose=PURPOSE).set(leases)


def bytes_by_purpose() -> Dict[str, Dict[str, int]]:
    """Slab bytes over every live manager, keyed by purpose (``fusion``):
    the memory ledger's pull source (``horovod_tpu/runtime/fusion_buffer.
    py:63-76``). Empty while no manager exists."""
    with _managers_lock:
        managers = list(_managers)
    out: Dict[str, Dict[str, int]] = {}
    for mgr in managers:
        total, live, leases = mgr.usage()
        rec = out.setdefault(PURPOSE, {
            "allocated_bytes": 0, "live_bytes": 0, "leases_outstanding": 0})
        rec["allocated_bytes"] += total
        rec["live_bytes"] += live
        rec["leases_outstanding"] += leases
    return out


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
        self._total_bytes = 0  # guarded-by: _lock
        self._live_bytes = 0  # guarded-by: _lock
        self._leases_out = 0  # guarded-by: _lock
        with _managers_lock:
            _managers.add(self)

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
                types.bump("slabs", _BUF_ALLOCS, self.max_per_key)
                self._total_bytes += self.max_per_key * key[0] \
                    * dtype.itemsize
            else:
                _BUF_REUSES.inc()
            free = self._free[key]
            if not free:
                raise RuntimeError(
                    f"fusion slab {key}: more than {self.max_per_key} leases "
                    "out at once (the pipeline depth bounds them)")
            lease = BufferLease(free.pop(), key)
            self._live_bytes += lease.capacity * dtype.itemsize
            self._leases_out += 1
        _refresh_gauges()  # outside this lock: it takes every manager's
        return lease

    def grow(self, max_per_key: int) -> None:
        """Let each key lease ``max_per_key`` slabs at once (the autotuner
        deepened the pipeline): every key seen gets its extra slabs now,
        on the calling thread's stream; a smaller number changes
        nothing."""
        n = int(max_per_key)
        with self._lock:
            if n <= self.max_per_key:
                return
            for key in self._count:
                extra = n - self._count[key]
                self._free[key].extend(
                    torch.empty(key[0], dtype=key[1], device=key[2])
                    for _ in range(extra))
                self._count[key] = n
                types.bump("slabs", _BUF_ALLOCS, extra)
                self._total_bytes += extra * key[0] * key[1].itemsize
            self.max_per_key = n
        _refresh_gauges()

    def release(self, lease: BufferLease) -> None:
        """Return a lease's slab. Idempotent: failure paths may release the
        same lease from more than one unwind."""
        with self._lock:
            if lease._released:
                return
            lease._released = True
            self._free.setdefault(lease._key, []).append(lease.tensor)
            self._live_bytes -= lease.capacity * lease.tensor.element_size()
            self._leases_out -= 1
        _refresh_gauges()

    def usage(self) -> Tuple[int, int, int]:
        """(bytes of every slab, bytes leased out, leases out)."""
        with self._lock:
            return self._total_bytes, self._live_bytes, self._leases_out

    def slabs(self) -> int:
        with self._lock:
            return sum(self._count.values())
