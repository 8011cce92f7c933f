"""Iteration-level continuous batcher (Orca-style scheduling; port of
``horovod_tpu/serve/batcher.py``, line for line).

One instance per replica, owned by the replica loop thread — all state
below is ``# guarded-by: <replica-thread>``. The batcher is pure
scheduling: it never touches a tensor, so the admission policy is unit-
testable with a fake clock (tests/test_torch_serve.py's policy matrix).

Admission policy, in priority order:

1. **Token budget is a hard cap.** A candidate is admitted only if the
   committed token total — every active slot's ``prompt_len +
   max_tokens`` plus the candidate's — stays within
   ``HOROVOD_SERVE_MAX_BATCH_TOKENS``. Committed (worst-case) rather
   than current lengths, so an admitted request can never be evicted
   mid-generation by later admissions. The admission deadline never
   overrides the budget. ``max_tokens`` is ``max_new_tokens`` capped at
   admission so no KV write can land past the cache length (the request
   then finishes with ``finish="cache_limit"``).
2. **Slots.** At most ``HOROVOD_SERVE_SLOTS`` concurrent requests (one
   KV-cache row each).
3. **Deadline beats the decode block.** Between admission checks the
   replica decodes ``HOROVOD_SERVE_DECODE_BLOCK`` uninterrupted steps
   (admission means a prefill, i.e. a latency bubble for running
   requests — batching those bubbles amortizes them). But a waiting
   request older than ``HOROVOD_SERVE_ADMISSION_MS`` pulls the check
   forward to the next step boundary: the block length bounds decode
   batching, the deadline bounds queueing delay, and the deadline wins.

FIFO order: requests are admitted in arrival order, and a budget-blocked
head does not let younger requests jump it (head-of-line blocking is the
price of no-starvation; the budget check is against the queue head).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.serve.queue import Request


@dataclasses.dataclass
class ActiveRequest:
    """One occupied KV-cache slot. ``max_tokens`` is the EFFECTIVE
    generation length: the request's ``max_new_tokens``, capped at
    admission so every KV write stays inside the cache
    (``prompt_len + max_tokens - 1 <= max_seq`` — the last generated
    token is returned, never written). Without the cap, positions past
    ``max_seq`` would silently clamp onto the last cache row and the
    request would complete with garbage tokens."""

    slot: int
    request: Request
    prompt_len: int
    position: int            # absolute index the NEXT token writes at
    max_tokens: int = 0      # 0 → request.max_new_tokens (uncapped)
    page_cost: int = 0       # committed KV pages charged at admission
    #                          (paged engines only; 0 under dense)
    admit_seq: int = 0       # admission order — preemption takes newest
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_s: float = 0.0
    admitted_s: float = 0.0
    # span bookkeeping (tracing.py; written by the replica loop): phase
    # durations for the slow-request exemplar, plus the open decode-block
    # span — block_t0 is EPOCH seconds (the trace clock), block_steps
    # counts decode steps since the block opened
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    block_t0: float = 0.0
    block_steps: int = 0
    blocks: int = 0

    def __post_init__(self):
        if self.max_tokens <= 0:
            self.max_tokens = self.request.max_new_tokens

    @property
    def capped(self) -> bool:
        return self.max_tokens < self.request.max_new_tokens

    @property
    def committed_tokens(self) -> int:
        return self.prompt_len + self.max_tokens

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_tokens


class ContinuousBatcher:
    """Slot assignment + admission timing for one replica."""

    def __init__(self, num_slots: int, max_batch_tokens: int,
                 admission_ms: float, decode_block: int,
                 max_seq: Optional[int] = None,
                 page_tokens: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefix_probe=None):
        self.num_slots = num_slots
        self.max_batch_tokens = max_batch_tokens
        self.admission_s = admission_ms / 1000.0
        self.decode_block = max(1, decode_block)
        self.max_seq = max_seq   # cache length; None → no generation cap
        # paged admission (serve/paging.py): when page_tokens is set the
        # pool — not dense slot rows — is the capacity being committed.
        # prefix_probe(prompt) -> currently-cached full-block pages, the
        # admission discount (optimistic: a later eviction shows up as a
        # PagePoolExhausted the replica answers with preemption).
        self.page_tokens = page_tokens
        self.pool_pages = pool_pages
        self.prefix_probe = prefix_probe
        # guarded-by: <replica-thread>
        self._waiting: deque = deque()   # (Request, offered_monotonic)
        self._active: Dict[int, ActiveRequest] = {}
        self._free: List[int] = sorted(range(num_slots), reverse=True)
        self._steps_since_admission = 0
        self._admission_seq = 0   # monotonic admission order (preemption)
        self.preemptions = 0

    # -- introspection -----------------------------------------------------
    def waiting(self) -> int:
        return len(self._waiting)

    def active(self) -> List[ActiveRequest]:
        return list(self._active.values())

    def occupancy(self) -> int:
        return len(self._active)

    def committed_tokens(self) -> int:
        return sum(a.committed_tokens for a in self._active.values())

    def committed_pages(self) -> int:
        return sum(a.page_cost for a in self._active.values())

    def oldest_wait_s(self, now: Optional[float] = None) -> float:
        if not self._waiting:
            return 0.0
        now = time.monotonic() if now is None else now
        return now - self._waiting[0][1]

    # -- scheduling --------------------------------------------------------
    def offer(self, request: Request, now: Optional[float] = None) -> None:
        self._waiting.append((request,
                              time.monotonic() if now is None else now))

    def note_step(self) -> None:
        self._steps_since_admission += 1

    def admission_due(self, now: Optional[float] = None) -> bool:
        """Check admission this iteration? True at every decode-block
        boundary, immediately when the replica is idle, and early when
        the queue head has waited past the admission deadline."""
        if not self._waiting:
            return False
        if not self._active:
            return True
        if self._steps_since_admission >= self.decode_block:
            return True
        return self.oldest_wait_s(now) >= self.admission_s

    def admit(self, now: Optional[float] = None) -> List[ActiveRequest]:
        """Admit FIFO from the waiting line while slots and the token
        budget allow; resets the decode-block counter."""
        now = time.monotonic() if now is None else now
        admitted: List[ActiveRequest] = []
        budget = self.committed_tokens()
        pages = self.committed_pages()
        while self._waiting and self._free:
            req, _ = self._waiting[0]
            max_tokens = req.max_new_tokens
            if self.max_seq is not None:
                # last generated token is returned, never written, so
                # prompt_len + max_tokens - 1 must fit the cache
                max_tokens = max(
                    1, min(max_tokens, self.max_seq - len(req.prompt) + 1))
            page_cost = 0
            if self.page_tokens and self.pool_pages:
                # a single request must fit the whole pool — the paged
                # analogue of the max_seq cap, same cache_limit finish
                cap = self.pool_pages * self.page_tokens \
                    - len(req.prompt) + 1
                max_tokens = max(1, min(max_tokens, cap))
                # committed pages: worst-case written positions
                # (prompt + generated - 1), discounted by the prefix
                # pages currently shared in the engine's cache
                written = len(req.prompt) + max_tokens - 1
                discount = (self.prefix_probe(req.prompt)
                            if self.prefix_probe is not None else 0)
                page_cost = max(
                    1, -(-written // self.page_tokens) - discount)
                if pages + page_cost > self.pool_pages:
                    break   # pool committed — wait for retires
            cost = len(req.prompt) + max_tokens
            if budget + cost > self.max_batch_tokens:
                break   # hard cap — the deadline never overrides it
            self._waiting.popleft()
            slot = self._free.pop()
            self._admission_seq += 1
            active = ActiveRequest(slot=slot, request=req,
                                   prompt_len=len(req.prompt),
                                   position=len(req.prompt),
                                   max_tokens=max_tokens,
                                   page_cost=page_cost,
                                   admit_seq=self._admission_seq,
                                   admitted_s=now)
            self._active[slot] = active
            admitted.append(active)
            budget += cost
            pages += page_cost
        self._steps_since_admission = 0
        return admitted

    def retire_done(self) -> List[ActiveRequest]:
        """Free the slots of finished requests (iteration-level retire:
        called after every decode step, not at batch boundaries)."""
        done = [a for a in self._active.values() if a.done]
        for a in done:
            del self._active[a.slot]
            self._free.append(a.slot)
        self._free.sort(reverse=True)
        return done

    def preempt_slot(self, slot: int,
                     now: Optional[float] = None) -> Optional[ActiveRequest]:
        """Pool-exhaustion path (paged engines): push ``slot``'s request
        back to the FRONT of the waiting line — it is older than
        anything queued behind it, so FIFO fairness holds — free its
        slot, and count the requeue. Pages are the ENGINE's to reclaim
        (``release_slot``); the batcher only schedules. The generated
        prefix is dropped: greedy decoding regenerates it
        deterministically on resume, so nothing is lost — the same
        invariant the quarantine requeue rides."""
        active = self._active.pop(slot, None)
        if active is None:
            return None
        self._free.append(slot)
        self._free.sort(reverse=True)
        active.request.requeues += 1
        self._waiting.appendleft(
            (active.request, time.monotonic() if now is None else now))
        self.preemptions += 1
        return active

    def preempt_newest(self, exclude_slot: Optional[int] = None,
                       now: Optional[float] = None
                       ) -> Optional[ActiveRequest]:
        """Pick the NEWEST-admitted active request (it has done the
        least work and, having been admitted last, is the fairest to
        defer) and preempt it. ``exclude_slot`` protects the request
        the caller is currently operating on (e.g. mid-prefill)."""
        candidates = [a for a in self._active.values()
                      if a.slot != exclude_slot]
        if not candidates:
            return None
        victim = max(candidates, key=lambda a: a.admit_seq)
        return self.preempt_slot(victim.slot, now=now)

    def evict_all(self) -> List[Request]:
        """Drop every active request (quarantine / worker-loss path) and
        return them for requeueing — nothing is lost, the generated
        prefix is (tokens are regenerated deterministically on replay)."""
        evicted = [a.request for a in
                   sorted(self._active.values(), key=lambda a: a.slot)]
        self._active.clear()
        self._free = sorted(range(self.num_slots), reverse=True)
        return evicted

    def drain_waiting(self) -> List[Request]:
        out = [req for req, _ in self._waiting]
        self._waiting.clear()
        return out

    def batch_rows(self) -> Tuple[List[int], List[int], List[int]]:
        """(slots, token_ids, positions) for the next decode step: each
        active row's last generated token (or last prompt token right
        after prefill) at its current position."""
        slots, tokens, positions = [], [], []
        for a in sorted(self._active.values(), key=lambda a: a.slot):
            if a.done:
                continue
            tokens.append(a.generated[-1] if a.generated
                          else a.request.prompt[-1])
            positions.append(a.position)
            slots.append(a.slot)
        return slots, tokens, positions
