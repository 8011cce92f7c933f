"""``hvd.serve()`` — the public face of the serving plane (port of
``horovod_tpu/serve/api.py``).

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import GPT2Small

    model = GPT2Small(vocab_size=50257)          # on the card
    handle = hvd.serve(model, replicas=2, max_new_tokens=32)
    uid = handle.submit([12, 7, 99])
    out = handle.result(uid, timeout=30.0)   # Completion(tokens=...)
    handle.close()

The model carries its parameters (the JAX package's ``serve(model,
params, ...)`` takes them apart) and its device: build it with
``device="cpu"`` to serve on the CPU. In-process mode (above) runs
``replicas`` replica threads — each with its own
:class:`~horovod_tpu_torch.serve.kv_cache.DecodeEngine` (own cache, own
decode graph) — against one shared in-memory
:class:`~horovod_tpu_torch.serve.queue.RequestQueue`. Cross-process fleets
(``python -m horovod_tpu_torch.serve`` workers) run
:func:`~horovod_tpu_torch.serve.replica.run_kv_replica` per rank against
the rendezvous KV queue instead; the policy/metrics/guard machinery is
identical.

Every policy knob has a ``HOROVOD_SERVE_*`` env default
(:meth:`ServePolicy.from_env`; ``utils/env.py`` lists them) and a keyword
override on :func:`serve`.

``serve_state()`` is the ``/serve`` route of the metrics server: a
JSON snapshot of every live handle's replicas, queue, and program
caches.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

from horovod_tpu_torch import flight_recorder, tracing
from horovod_tpu_torch.integrity.guards import StepGuard
from horovod_tpu_torch.serve.kv_cache import DecodeEngine
from horovod_tpu_torch.serve.paging import (DEFAULT_PAGE_TOKENS,
                                            DEFAULT_PREFIX_ENTRIES,
                                            PagedDecodeEngine)
from horovod_tpu_torch.serve.queue import Completion, RequestQueue
from horovod_tpu_torch.serve.replica import Replica, _LocalTransport
from horovod_tpu_torch.utils.env import (
    HOROVOD_INTEGRITY_SPIKE_SIGMA, HOROVOD_SERVE_ADMISSION_MS,
    HOROVOD_SERVE_DECODE_BLOCK, HOROVOD_SERVE_MAX_BATCH_TOKENS,
    HOROVOD_SERVE_MAX_NEW_TOKENS, HOROVOD_SERVE_PAGE_POOL,
    HOROVOD_SERVE_PAGE_TOKENS, HOROVOD_SERVE_PAGED,
    HOROVOD_SERVE_PREFIX_CACHE, HOROVOD_SERVE_QUARANTINE,
    HOROVOD_SERVE_QUEUE_CAPACITY, HOROVOD_SERVE_SLOTS, _get_bool,
    _get_float, _get_int)


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Continuous-batching policy; ``utils/env.py`` says what each knob
    is and batcher.py gives the precedence (budget > slots > deadline >
    block)."""

    max_batch_tokens: int = 4096
    admission_ms: float = 50.0
    queue_capacity: int = 1024
    decode_block: int = 8
    slots: int = 8
    max_new_tokens: int = 64
    quarantine: bool = True
    # paged KV cache (serve/paging.py): page_pool=0
    # sizes the pool to half the dense slots x max_seq capacity,
    # prefix_cache=0 disables prefix reuse
    paged: bool = False
    page_tokens: int = DEFAULT_PAGE_TOKENS
    page_pool: int = 0
    prefix_cache: int = DEFAULT_PREFIX_ENTRIES

    @classmethod
    def from_env(cls, **overrides) -> "ServePolicy":
        base = {
            "max_batch_tokens": _get_int(HOROVOD_SERVE_MAX_BATCH_TOKENS,
                                         cls.max_batch_tokens),
            "admission_ms": _get_float(HOROVOD_SERVE_ADMISSION_MS,
                                       cls.admission_ms),
            "queue_capacity": _get_int(HOROVOD_SERVE_QUEUE_CAPACITY,
                                       cls.queue_capacity),
            "decode_block": _get_int(HOROVOD_SERVE_DECODE_BLOCK,
                                     cls.decode_block),
            "slots": _get_int(HOROVOD_SERVE_SLOTS, cls.slots),
            "max_new_tokens": _get_int(HOROVOD_SERVE_MAX_NEW_TOKENS,
                                       cls.max_new_tokens),
            "quarantine": _get_bool(HOROVOD_SERVE_QUARANTINE,
                                    cls.quarantine),
            "paged": _get_bool(HOROVOD_SERVE_PAGED, cls.paged),
            "page_tokens": _get_int(HOROVOD_SERVE_PAGE_TOKENS,
                                    cls.page_tokens),
            "page_pool": _get_int(HOROVOD_SERVE_PAGE_POOL, cls.page_pool),
            "prefix_cache": _get_int(HOROVOD_SERVE_PREFIX_CACHE,
                                     cls.prefix_cache),
        }
        unknown = set(overrides) - set(base)
        if unknown:
            raise TypeError(f"unknown serve policy knob(s): "
                            f"{sorted(unknown)}")
        base.update(overrides)
        return cls(**base)


def _serve_guard(rank: int) -> StepGuard:
    """The serving integrity guard watches per-step max-|logit|, which
    legitimately swings with the prompt mix — unlike the allreduced loss
    the training default (sigma=6, warmup=5) was tuned for. Serving
    relaxes to sigma=12 / warmup=32 so healthy variation only ever costs
    a skipped observation, while non-finite values and persistent
    divergence still quarantine. HOROVOD_INTEGRITY_SPIKE_SIGMA
    overrides the sigma here too."""
    return StepGuard(sigma=_get_float(HOROVOD_INTEGRITY_SPIKE_SIGMA, 12.0),
                     warmup=32, decay=0.98, name=f"serve_r{rank}")


# live handles, for serve_state() / the /serve route
_state_lock = threading.Lock()
_handles: List["ServeHandle"] = []   # guarded-by: _state_lock


class ServeHandle:
    """A running in-process replica set + its shared queue."""

    def __init__(self, replicas: List[Replica], queue: RequestQueue,
                 policy: ServePolicy, tokenizer=None):
        self._replicas = replicas
        self._queue = queue
        self._policy = policy
        self._tokenizer = tokenizer
        self._max_seq = min((r.engine.max_seq for r in replicas),
                            default=0)
        self._threads: List[threading.Thread] = []
        self._closed = False
        self.started_s = time.monotonic()
        # /healthz flips to "serving": not ready again until a replica
        # loop (or KV heartbeat) proves the fleet actually came up
        tracing.note_serve_started()
        for replica in replicas:
            t = threading.Thread(target=replica.run, daemon=True,
                                 name=replica.name)
            self._threads.append(t)
            t.start()
        with _state_lock:
            _handles.append(self)
        # flight-recorder "serve" provider: every postmortem dump now
        # carries the serving snapshot — replica/queue state and, under
        # HOROVOD_SERVE_PAGED, pool occupancy at death
        flight_recorder.set_state_provider("serve", serve_state)

    # -- request API -------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None) -> str:
        """Enqueue a prompt (token-id list, or text when a tokenizer was
        given); returns the request id.

        Raises :class:`ValueError` for a prompt the replicas could
        never serve (empty, or longer than the model's ``max_seq``) —
        admission would otherwise fail deep inside a replica thread and
        the caller would hang in :meth:`result` until timeout. A prompt
        that FITS but whose ``prompt + max_new_tokens`` overruns the KV
        cache is accepted and truncated (``finish="cache_limit"`` on the
        completion)."""
        if self._closed:
            raise RuntimeError(
                "serve handle is closed; nothing would ever complete "
                "this request")
        if self._tokenizer is not None and isinstance(prompt, str):
            prompt = list(self._tokenizer.encode(prompt))
        prompt = list(prompt)
        if not prompt:
            raise ValueError("serve: empty prompt")
        if self._max_seq and len(prompt) > self._max_seq:
            raise ValueError(
                f"serve: prompt length {len(prompt)} exceeds the "
                f"model's max_seq ({self._max_seq})")
        # the trace context is minted HERE, at the public API edge —
        # every span and serve-path flight event downstream carries it
        trace_id = tracing.new_trace_id()
        uid = self._queue.submit(
            prompt,
            max_new_tokens=(self._policy.max_new_tokens
                            if max_new_tokens is None else max_new_tokens),
            trace_id=trace_id)
        flight_recorder.emit("serve_submit", uid=uid, trace_id=trace_id,
                             prompt_len=len(prompt))
        return uid

    def result(self, uid: str, timeout: Optional[float] = None
               ) -> Completion:
        return self._queue.result(uid, timeout=timeout)

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = 60.0) -> Completion:
        return self.result(self.submit(prompt, max_new_tokens),
                           timeout=timeout)

    # -- introspection -----------------------------------------------------
    @property
    def policy(self) -> ServePolicy:
        return self._policy

    def queue_depth(self) -> int:
        return self._queue.depth()

    def compiles_total(self) -> int:
        return sum(r.engine.compiles_total() for r in self._replicas)

    def stats(self) -> dict:
        return {
            "policy": dataclasses.asdict(self._policy),
            "uptime_s": round(time.monotonic() - self.started_s, 3),
            "queue": self._queue.stats(),
            "replicas": [r.stats() for r in self._replicas],
        }

    def close(self, timeout: float = 10.0) -> None:
        if self._closed:
            return
        self._closed = True
        for replica in self._replicas:
            replica.stop()
        for t in self._threads:
            t.join(timeout=timeout)
        with _state_lock:
            if self in _handles:
                _handles.remove(self)

    def __enter__(self) -> "ServeHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve(model, tokenizer=None, *, replicas: int = 1,
          policy: Optional[ServePolicy] = None, **overrides) -> ServeHandle:
    """Start an in-process continuous-batching replica set over ``model``
    and return its :class:`ServeHandle`.

    ``model`` must be a causal :class:`~horovod_tpu_torch.models.
    transformer.Transformer` holding its trained parameters, on the
    device it serves from. ``**overrides`` are :class:`ServePolicy`
    fields; anything not overridden comes from ``HOROVOD_SERVE_*`` env
    knobs.
    """
    if policy is None:
        policy = ServePolicy.from_env(**overrides)
    elif overrides:
        policy = dataclasses.replace(policy, **overrides)
    queue = RequestQueue(capacity=policy.queue_capacity)
    fleet: List[Replica] = []
    for rank in range(replicas):
        if policy.paged:
            engine = PagedDecodeEngine(
                model, num_slots=policy.slots, name=f"r{rank}",
                page_tokens=policy.page_tokens,
                pool_pages=policy.page_pool,
                prefix_entries=policy.prefix_cache)
        else:
            engine = DecodeEngine(model, num_slots=policy.slots,
                                  name=f"r{rank}")
        guard = _serve_guard(rank) if policy.quarantine else None
        fleet.append(Replica(engine, _LocalTransport(queue, rank), policy,
                             rank=rank, guard=guard))
    return ServeHandle(fleet, queue, policy, tokenizer=tokenizer)


def serve_state() -> dict:
    """JSON-ready snapshot of every live handle — the ``/serve`` route
    on the metrics server."""
    with _state_lock:
        handles = list(_handles)
    return {"handles": [h.stats() for h in handles],
            "count": len(handles)}
