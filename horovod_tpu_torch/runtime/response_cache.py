"""LRU response cache with stable cache bits: the negotiation fast path
(port of the Python ``ResponseCache`` and ``CacheCoordinator`` of
``horovod_tpu/runtime/response_cache.py``; reference:
horovod/common/response_cache.cc/.h).

Once a named tensor has been negotiated, its ``Response`` is cached under
a stable cache bit; on later cycles each worker contributes only a
bitvector of hit bits, the controller ANDs the bitvectors across workers
(two small collectives instead of a gather and broadcast of requests), and
when every queued tensor is a hit everywhere the responses come straight
from the cache (reference: controller.cc:151-179). In steady-state training
(the same named gradients every step) every cycle takes that path.

Two engines with one behaviour: :class:`NativeResponseCache`, whose LRU
order and bits live in the C++ engine (``cpp/cycle.cc``), and the Python
:class:`ResponseCache`. :func:`make_response_cache` picks by
``HOROVOD_NATIVE_CYCLE`` (default on, the native one); the Python one runs
only when the knob is off, never as a fallback for a library that fails to
build. The native cache keeps each entry's ``Response`` on the Python side
by bit and hands out that object on a hit, where the JAX package packs it
into wire bytes on ``put`` and unpacks them on every hit
(``horovod_tpu/runtime/response_cache.py:196-210``).
"""

from __future__ import annotations

import ctypes
import enum
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.runtime import message as msg
from horovod_tpu_torch.runtime import native
from horovod_tpu_torch.utils import env

_CACHE_HITS = _metrics().counter(
    "horovod_response_cache_hits_total",
    "Negotiation cache lookups that found a matching cached response.")
_CACHE_MISSES = _metrics().counter(
    "horovod_response_cache_misses_total",
    "Negotiation cache lookups that found no entry for the tensor name.")
_CACHE_INVALIDATIONS = _metrics().counter(
    "horovod_response_cache_invalidations_total",
    "Cached responses dropped (params changed or stale deferred hits).")


def _record_lookup(state: "CacheState") -> "CacheState":
    """The hit and miss counts of both engines: an INVALID lookup counts
    as a miss (it re-enters full negotiation); the invalidation itself is
    counted by ``invalidate``."""
    if state is CacheState.HIT:
        _CACHE_HITS.inc()
    else:
        _CACHE_MISSES.inc()
    return state


class CacheState(enum.Enum):
    # reference: response_cache.h:44-56
    MISS = 0
    HIT = 1
    INVALID = 2


class ResponseCache:
    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        # Every mutation happens on the background cycle thread, so the
        # cache takes no lock. bit -> (response, params_key) in LRU order.
        self._entries: "OrderedDict[int, Tuple[msg.Response, tuple]]" = OrderedDict()
        self._name_to_bit: Dict[str, int] = {}
        self._next_bit = 0
        # bits freed by eviction or invalidation, reused lowest first so the
        # bitvector stays bounded by the capacity (response_cache.cc:232+)
        self._free_bits: List[int] = []

    def _alloc_bit(self) -> int:
        if self._free_bits:
            return heapq.heappop(self._free_bits)
        bit = self._next_bit
        self._next_bit += 1
        return bit

    def _release_bit(self, bit: int) -> None:
        heapq.heappush(self._free_bits, bit)

    @staticmethod
    def _params_key(request: msg.Request) -> tuple:
        return (request.request_type, request.dtype, request.shape,
                request.root_rank, request.reduce_op)

    def cached(self, request: msg.Request) -> CacheState:
        """A name hit with changed shape, dtype or params is INVALID, not a
        HIT (reference: response_cache.cc:50-76).

        It does not touch the LRU order: announcements arrive at different
        times on different workers, and a touch here would let eviction
        orders diverge and map one bit to different tensors on different
        workers. The order changes only on the agreed paths (``get_by_bit``
        with common bits, ``put``/``invalidate`` with agreed responses),
        which every worker runs in the same sequence."""
        bit = self._name_to_bit.get(request.tensor_name)
        if bit is None or bit not in self._entries:
            return _record_lookup(CacheState.MISS)
        _, key = self._entries[bit]
        if key == self._params_key(request):
            return _record_lookup(CacheState.HIT)
        return _record_lookup(CacheState.INVALID)

    def put(self, response: msg.Response, request: msg.Request) -> int:
        """Insert (or refresh) a single-tensor response, evicting the least
        recently used at capacity (reference: response_cache.cc:144-230).
        A no-op at capacity 0 (``HOROVOD_CACHE_CAPACITY=0``)."""
        if len(response.tensor_names) != 1:
            raise ValueError(
                "response cache stores single-tensor responses only")
        if self.capacity <= 0:
            return -1
        name = request.tensor_name
        bit = self._name_to_bit.get(name)
        if bit is not None and bit in self._entries:
            self._entries.move_to_end(bit)
            self._entries[bit] = (response, self._params_key(request))
            return bit
        if len(self._entries) >= self.capacity:
            old_bit, (old_resp, _) = self._entries.popitem(last=False)
            for n in old_resp.tensor_names:
                self._name_to_bit.pop(n, None)
            self._release_bit(old_bit)
        bit = self._alloc_bit()
        self._entries[bit] = (response, self._params_key(request))
        self._name_to_bit[name] = bit
        return bit

    def get_by_bit(self, bit: int) -> Optional[msg.Response]:
        entry = self._entries.get(bit)
        if entry is None:
            return None
        self._entries.move_to_end(bit)  # touch for LRU
        return entry[0]

    def bit_for_name(self, name: str) -> Optional[int]:
        return self._name_to_bit.get(name)

    def invalidate(self, name: str) -> None:
        """Drop a cached entry: a stalled or changed tensor re-enters full
        negotiation."""
        bit = self._name_to_bit.pop(name, None)
        if bit is not None and self._entries.pop(bit, None) is not None:
            self._release_bit(bit)
            _CACHE_INVALIDATIONS.inc()

    def __len__(self) -> int:
        return len(self._entries)


def _pack_params_key(request: msg.Request) -> bytes:
    """The cache key as the bytes the native cache compares, derived from
    ``ResponseCache._params_key`` so the engines agree on what a key is."""
    return repr(ResponseCache._params_key(request)).encode()


class NativeResponseCache:
    """:class:`ResponseCache`'s interface and behaviour, with the LRU order,
    the bits and the keys in the C++ engine (``hvc_cache_*``). The C++ side
    stores an empty blob; the ``Response`` of each bit stays here, so a hit
    costs one call and no unpacking. ``get_by_bit`` asks the engine first:
    a bit it evicted or invalidated is absent, whatever this side still
    holds for it, and a reused bit's entry is overwritten by its ``put``."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._lib = native.load()
        self._h = self._lib.hvc_cache_new(capacity)
        if not self._h:
            raise native.NativeBuildError("hvc_cache_new failed")
        self._responses: Dict[int, msg.Response] = {}
        self._buf = ctypes.create_string_buffer(1)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.hvc_cache_free(h)

    def cached(self, request: msg.Request) -> CacheState:
        key = _pack_params_key(request)
        return _record_lookup(CacheState(self._lib.hvc_cache_cached(
            self._h, request.tensor_name.encode(), key, len(key))))

    def put(self, response: msg.Response, request: msg.Request) -> int:
        if len(response.tensor_names) != 1:
            raise ValueError(
                "response cache stores single-tensor responses only")
        if self.capacity <= 0:
            return -1
        key = _pack_params_key(request)
        bit = self._lib.hvc_cache_put(
            self._h, request.tensor_name.encode(), key, len(key), b"", 0)
        self._responses[bit] = response
        return bit

    def get_by_bit(self, bit: int) -> Optional[msg.Response]:
        # touches the LRU order; -1: no such bit
        if self._lib.hvc_cache_get(self._h, bit, self._buf, 0) < 0:
            return None
        return self._responses[bit]

    def bit_for_name(self, name: str) -> Optional[int]:
        bit = self._lib.hvc_cache_bit_for_name(self._h, name.encode())
        return None if bit < 0 else bit

    def invalidate(self, name: str) -> None:
        bit = self.bit_for_name(name)
        if bit is not None:  # count only real drops, as ResponseCache does
            _CACHE_INVALIDATIONS.inc()
            self._lib.hvc_cache_invalidate(self._h, name.encode())
            self._responses.pop(bit, None)

    def __len__(self) -> int:
        return int(self._lib.hvc_cache_size(self._h))


def native_cycle_enabled() -> bool:
    """``HOROVOD_NATIVE_CYCLE``: on (the default) unless "0", "false", "no"
    or "off"."""
    return env.native_cycle()


def make_response_cache(capacity: int = 1024, native_engine=None):
    """The native cache, or the Python one when ``native_engine`` is false
    (default: :func:`native_cycle_enabled`). Building or loading the native
    library raises :class:`native.NativeBuildError` on failure: there is no
    fallback to the Python cache."""
    if native_engine is None:
        native_engine = native_cycle_enabled()
    if native_engine:
        return NativeResponseCache(capacity)
    return ResponseCache(capacity)


class CacheCoordinator:
    """Packs a cycle's cache hits and status flags into an int bitvector,
    synchronized across workers with bitwise AND and OR (reference:
    response_cache.h:104-167, response_cache.cc:308-430). The status bits
    take the lowest positions (response_cache.h:128-132)."""

    SHOULD_SHUT_DOWN = 0
    UNCACHED_IN_QUEUE = 1
    INVALID_IN_QUEUE = 2
    NUM_STATUS_BITS = 3

    def __init__(self):
        self._bits = 0

    def record_hit(self, bit: int) -> None:
        self._bits |= 1 << (bit + self.NUM_STATUS_BITS)

    def set_uncached_in_queue(self) -> None:
        self._bits |= 1 << self.UNCACHED_IN_QUEUE

    def set_invalid_in_queue(self) -> None:
        self._bits |= 1 << self.INVALID_IN_QUEUE

    def set_should_shut_down(self) -> None:
        self._bits |= 1 << self.SHOULD_SHUT_DOWN

    @property
    def bitvector(self) -> int:
        return self._bits

    @staticmethod
    def common_hits(anded_bits: int) -> List[int]:
        """Cache bits hit on every worker, from the AND-reduced vector."""
        bits = anded_bits >> CacheCoordinator.NUM_STATUS_BITS
        out = []
        i = 0
        while bits:
            if bits & 1:
                out.append(i)
            bits >>= 1
            i += 1
        return out

    @staticmethod
    def flags(ored_bits: int) -> Tuple[bool, bool, bool]:
        """(should_shut_down, uncached_in_queue, invalid_in_queue) from the
        OR-reduced vector: any worker setting a flag sets it for all."""
        return (
            bool(ored_bits & (1 << CacheCoordinator.SHOULD_SHUT_DOWN)),
            bool(ored_bits & (1 << CacheCoordinator.UNCACHED_IN_QUEUE)),
            bool(ored_bits & (1 << CacheCoordinator.INVALID_IN_QUEUE)),
        )
