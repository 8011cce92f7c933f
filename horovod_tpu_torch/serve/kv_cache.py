"""Per-slot KV cache and the serving step programs (port of
``horovod_tpu/serve/kv_cache.py``).

:class:`DecodeEngine` owns one replica's device state:

* the user's causal :class:`~horovod_tpu_torch.models.transformer.
  Transformer`, run on its serving path (the same module and parameters)
  with a dense :class:`~horovod_tpu_torch.models.transformer.KVCache` of
  ``(slots, max_seq, heads, head_dim)`` key and value tensors a layer;
* ONE fixed-shape decode step over ALL slots every time (inactive rows
  run token 0 at position 0, which the next prefill of their slot
  overwrites). On the card the step is captured once as a CUDA graph
  (:class:`DecodeStep`): its token, position and page-table inputs are
  static device buffers filled in place before each replay, and the cache
  is written in place, so the graph's addresses never change. This is the
  port's counterpart of the JAX package's one jitted decode program. The
  capture runs on a side stream with ``capture_error_mode="thread_local"``
  (other replica threads may launch meanwhile) after two warm-up steps
  there; each engine has its own graph, memory pool and buffers. A
  capture that fails raises: there is no eager fallback. On the CPU the
  same step runs eagerly;
* one prefill per PROMPT-LENGTH BUCKET, batch 1, eager. Bucketing reuses
  the runtime's size-bucket policy (``fusion_buffer.bucket_elems``:
  identity up to the quantum, then power-of-two multiples), floored at
  the quantum, so the bucket set is O(log(max_seq)). A dense prefill
  zeroes the slot's whole row before writing the padded prompt's keys and
  values into it: the row ends as the JAX package leaves it (the prompt's
  KV, then zeros up to ``max_seq``), so nothing of an earlier occupant
  (a NaN of a quarantined request included: ``0 * NaN`` is no zero)
  survives into the next request.

``compiles_total`` keeps the JAX package's meaning: one count per program
key (``prefill_<bucket>``, ``decode``; ``page_copy`` for the paged
engine) at its first use, so steady state adds none
(``horovod_serve_compiles_total``).

Padded prefill rows and stale rows are safe without length bookkeeping:
they sit at positions ``>= prompt_len``, which ``cached_attention`` masks
for every query that has not reached them, and decode overwrites each
before its query arrives.

Sampling is greedy (``argmax``, the first maximum as ``jnp.argmax``
takes it); only the winning ids and one max-|logit| a slot (for the
integrity guard) leave the device each step.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.models.transformer import KVCache
from horovod_tpu_torch.runtime.fusion_buffer import bucket_elems

# prompt-length bucket quantum (tokens). Not a knob: the policy is the
# runtime's, only the unit differs (tokens, not bytes).
PREFILL_BUCKET_QUANTUM = 16

_COMPILES = _metrics().counter(
    "horovod_serve_compiles_total",
    "Serving programs compiled, by kind (steady state adds none).",
    labelnames=("program",))
_KV_BYTES = _metrics().gauge(
    "horovod_serve_kv_cache_bytes",
    "KV-cache bytes resident per decode engine (replica).",
    labelnames=("replica",))

# every live engine, so the memory ledger's "serve_kv" subsystem can sum
# resident cache bytes without the serve plane pushing on its hot path
_engines_lock = threading.Lock()
_engines: "weakref.WeakSet" = weakref.WeakSet()  # guarded-by: _engines_lock


def total_cache_bytes() -> int:
    """Resident KV-cache bytes across every live dense engine of this
    process: the memory ledger's pull source for ``serve_kv``."""
    with _engines_lock:
        engines = list(_engines)
    return sum(e.cache_bytes() for e in engines)


def prompt_bucket(prompt_len: int, max_seq: int,
                  quantum: int = PREFILL_BUCKET_QUANTUM) -> int:
    """Padded prompt length: the fusion-buffer size-bucket policy in token
    units, floored at the quantum (identity below it would mean one
    program per distinct short-prompt length)."""
    return min(max_seq, bucket_elems(max(prompt_len, quantum), 1, quantum))


def check_causal(model) -> None:
    if not getattr(model.layers[0].attention, "causal", True):
        raise ValueError("hvd.serve() needs a causal (decoder) model")


def greedy(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmax ids, max |logit|) over the last dimension."""
    return logits.argmax(-1), logits.abs().amax(-1)


def padded_prompt(tokens: List[int], bucket: int, device) -> torch.Tensor:
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :len(tokens)] = tokens
    return torch.from_numpy(padded).to(device)


def last_logits(model, hidden: torch.Tensor, index: int) -> torch.Tensor:
    """The tied vocab projection of ``hidden[0, index]`` alone, float32."""
    return (hidden[0, index] @ model.token_embed.to(model.dtype).T).float()


class ProgramCounts:
    """The first use of each program key, counted once
    (``horovod_serve_compiles_total``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}    # guarded-by: _lock

    def note(self, program: str) -> None:
        _COMPILES.labels(program=program).inc()
        with self._lock:
            self._counts[program] = self._counts.get(program, 0) + 1

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


class DecodeStep:
    """One decode step of ``model`` over every slot of ``cache``: static
    token, position (and page-table) buffers, the step's outputs, and on
    the card its CUDA graph, captured at the first :meth:`run`."""

    def __init__(self, model, cache: KVCache, num_slots: int,
                 table_width: Optional[int] = None):
        self.model, self.cache = model, cache
        dev = model.token_embed.device
        self.device = dev
        self.tokens = torch.zeros((num_slots, 1), dtype=torch.long,
                                  device=dev)
        self.positions = torch.zeros((num_slots,), dtype=torch.long,
                                     device=dev)
        self.table = None if table_width is None else torch.zeros(
            (num_slots, table_width), dtype=torch.long, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def load(self, tokens: np.ndarray, positions: np.ndarray,
             table: Optional[np.ndarray] = None) -> None:
        """Fill the static inputs in place (their addresses are the
        graph's)."""
        self.tokens.copy_(torch.from_numpy(tokens))
        self.positions.copy_(torch.from_numpy(positions))
        if table is not None:
            self.table.copy_(torch.from_numpy(table))

    def eager(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step on the loaded inputs, launched op by op. It writes the
        loaded tokens' keys and values at their positions, so running it
        again on the same inputs leaves the cache as it was."""
        with torch.no_grad():
            logits = self.model(self.tokens, positions=self.positions,
                                cache=self.cache, page_table=self.table)
            return greedy(logits[:, 0])

    def run(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step on the loaded inputs: a graph replay on the card (the
        graph captured first if need be), eager on the CPU. Returns (ids,
        max |logit|) a slot, static tensors on the card."""
        if self.device.type != "cuda":
            return self.eager()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return self.out

    def _capture(self) -> None:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(2):  # warm-up: idempotent on the cache
                self.eager()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self.out = self.eager()
        self.graph = graph


class StepEngine:
    """What the dense and the paged engine share: the model, its cache and
    decode step, the program keys and the step's timing. A subclass calls
    :meth:`_start` from its constructor."""

    def _start(self, model, num_slots: int, name: str, cache: KVCache,
               table_width: Optional[int] = None) -> None:
        self.name = name
        self.num_slots = int(num_slots)
        self.max_seq = int(model.max_seq)
        self.vocab_size = int(model.vocab_size)
        self._model = model
        self._cache = cache
        self._step = DecodeStep(model, cache, self.num_slots, table_width)
        self._prefill_buckets: set = set()  # guarded-by: <replica-thread>
        self._programs = ProgramCounts()
        self._decode_used = False
        self.decode_steps = 0
        self.step_ms_ewma = 0.0

    @property
    def step(self) -> DecodeStep:
        return self._step

    def cache_bytes(self) -> int:
        return self._cache.nbytes()

    def compiles_total(self) -> int:
        return self._programs.total()

    def _check_prompt(self, prompt: List[int]) -> None:
        if not 0 < len(prompt) <= self.max_seq:
            # callers (ServeHandle.submit, Replica._reject) screen this
            # out; fail loudly inside a replica thread all the same
            raise ValueError(
                f"prefill: prompt length {len(prompt)} outside "
                f"(0, max_seq={self.max_seq}]")

    def _bucket(self, n: int) -> int:
        bucket = prompt_bucket(n, self.max_seq)
        if bucket not in self._prefill_buckets:
            self._prefill_buckets.add(bucket)
            self._programs.note(f"prefill_{bucket}")
        return bucket

    def _note_decode(self) -> None:
        if not self._decode_used:
            self._decode_used = True
            self._programs.note("decode")

    def _step_inputs(self, slots, tokens, positions):
        """The step's (tokens, positions) over every slot: the active rows'
        values, token 0 at position 0 elsewhere."""
        step_tokens = np.zeros((self.num_slots, 1), np.int64)
        step_pos = np.zeros((self.num_slots,), np.int64)
        for s, t, p in zip(slots, tokens, positions):
            if p >= self.max_seq:
                # admission caps max_tokens so no write lands past the
                # cache (batcher.ActiveRequest)
                raise ValueError(
                    f"decode: slot {s} position {p} >= max_seq "
                    f"{self.max_seq} (admission cap violated)")
            step_tokens[s, 0] = t
            step_pos[s] = p
        return step_tokens, step_pos

    def _run_step(self, slots, step_tokens, step_pos, step_table=None
                  ) -> Tuple[List[int], List[float]]:
        start = time.monotonic()
        self._step.load(step_tokens, step_pos, step_table)
        ids, max_abs = (t.cpu().numpy() for t in self._step.run())
        ms = (time.monotonic() - start) * 1000.0
        self.decode_steps += 1
        self.step_ms_ewma = (ms if self.decode_steps == 1
                             else 0.9 * self.step_ms_ewma + 0.1 * ms)
        return ([int(ids[s]) for s in slots],
                [float(max_abs[s]) for s in slots])


class DecodeEngine(StepEngine):
    """The serving programs and the slot cache of one replica."""

    paged = False

    def __init__(self, model, num_slots: int, name: str = "r0"):
        check_causal(model)
        self._start(model, num_slots, name,
                    KVCache.dense(model, int(num_slots)))
        with _engines_lock:
            _engines.add(self)
        _KV_BYTES.labels(replica=self.name).set(self.cache_bytes())

    def prefill(self, slot: int, prompt: List[int]) -> Tuple[int, float]:
        """Run the prompt through its bucket's prefill into ``slot``'s
        cache row. Returns (first generated token id, max |logit|): the
        first token comes from prefill itself."""
        self._check_prompt(prompt)
        bucket = self._bucket(len(prompt))
        dev = self._step.device
        row = self._cache.rows(slot).zero_()
        with torch.no_grad():
            hidden = self._model(padded_prompt(prompt, bucket, dev),
                                 positions=torch.zeros(1, dtype=torch.long,
                                                       device=dev),
                                 cache=row, output="hidden")
            token, max_abs = greedy(last_logits(self._model, hidden,
                                                len(prompt) - 1))
        return int(token), float(max_abs)

    def decode(self, slots: List[int], tokens: List[int],
               positions: List[int]) -> Tuple[List[int], List[float]]:
        """One decode step over ALL cache rows (fixed shape). Active rows
        get their token and position; inactive rows run token 0 at
        position 0 of their own row, which the next prefill overwrites."""
        self._note_decode()
        return self._run_step(slots, *self._step_inputs(slots, tokens,
                                                        positions))

    def stats(self) -> dict:
        compiles = self._programs.counts()
        return {"compiles": compiles,
                "compiles_total": sum(compiles.values()),
                "decode_steps": self.decode_steps,
                "decode_step_ms_ewma": round(self.step_ms_ewma, 3),
                "cache_bytes": self.cache_bytes(),
                "slots": self.num_slots}
