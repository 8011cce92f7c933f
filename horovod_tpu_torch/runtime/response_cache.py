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

The JAX package's native engine (``cpp/cycle.cc``) and its hit/miss
metrics are not ported yet (ROADMAP A3, A11).
"""

from __future__ import annotations

import enum
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.runtime import message as msg


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
            return CacheState.MISS
        _, key = self._entries[bit]
        if key == self._params_key(request):
            return CacheState.HIT
        return CacheState.INVALID

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

    def __len__(self) -> int:
        return len(self._entries)


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
