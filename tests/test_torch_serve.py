"""The port's serving plane (``horovod_tpu_torch/serve``) against the JAX
package's (``horovod_tpu/serve``), case by case after tests/test_serve.py.

* The continuous batcher's admission matrix, the request queue's zero-lost
  invariant, the replica loop's integrity paths (on an engine double) and
  the KV transport's re-dispatch are pure scheduling: they run on the port
  alone.
* The engines are held against the JAX package's on the same weights: the
  tiny float32 model of tests/test_serve.py (vocab 61, d 32, 2 layers, 2
  heads, max_seq 48) is built in JAX from ``PRNGKey(0)`` and carried over
  with ``params_from_flax``. One scripted call sequence (two prompt
  buckets in concurrent slots, a long occupant then a short prompt in the
  same slot, a third bucket, a request evicted and prefilled again) runs
  through JAX's ``DecodeEngine`` once per module and through the port's:
  the tokens must be equal, max|logit| within 1e-5 relative, and
  ``compiles_total`` equal after every call.
* ``cached_attention`` and the model's serving path match JAX's within
  1e-6 of the output's norm (float32), dense, with one row's prompt
  padded.
* ``hvd.serve`` end to end on the CPU, and one ``python -m
  horovod_tpu_torch.serve --device cpu`` worker driven through the
  rendezvous KV queue.
"""

import json
import math
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as jtr
from horovod_tpu.serve import kv_cache as jkv
from horovod_tpu_torch.exceptions import WorkersDownError
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.serve import kv_cache as tkv
from horovod_tpu_torch.serve.api import ServeHandle, ServePolicy
from horovod_tpu_torch.serve.batcher import ContinuousBatcher
from horovod_tpu_torch.serve.queue import (Completion, KVQueueFrontend,
                                           KVQueueReplica, QueueFull,
                                           Request, RequestQueue)
from horovod_tpu_torch.serve.replica import Replica, _LocalTransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=61, d_model=32, num_layers=2, num_heads=2, d_ff=64,
            max_seq=48, causal=True)
MAX_ABS_RTOL = 1e-5


def _req(uid, prompt_len=8, max_new=4):
    return Request(uid=uid, prompt=list(range(1, prompt_len + 1)),
                   max_new_tokens=max_new, submitted_s=0.0)


# ---------------------------------------------------------------- batcher

class TestBatcherPolicy:
    def _batcher(self, slots=4, budget=10_000, admission_ms=50.0,
                 block=8):
        return ContinuousBatcher(num_slots=slots, max_batch_tokens=budget,
                                 admission_ms=admission_ms,
                                 decode_block=block)

    def test_idle_replica_admits_immediately(self):
        b = self._batcher()
        assert not b.admission_due(0.0)
        b.offer(_req("a"), now=0.0)
        assert b.admission_due(0.0)
        assert [a.request.uid for a in b.admit(0.0)] == ["a"]
        assert b.occupancy() == 1 and b.waiting() == 0

    def test_token_budget_is_a_hard_cap(self):
        b = self._batcher(budget=25, admission_ms=50.0)
        for uid in ("a", "b", "c"):
            b.offer(_req(uid), now=0.0)
        assert [a.request.uid for a in b.admit(0.0)] == ["a", "b"]
        assert b.committed_tokens() == 24
        assert b.admission_due(9.0)
        assert b.admit(9.0) == []          # the deadline never overrides
        b.active()[0].generated.extend([1, 2, 3, 4])
        assert [a.request.uid for a in b.retire_done()] == ["a"]
        assert [a.request.uid for a in b.admit(9.0)] == ["c"]

    def test_budget_blocked_head_blocks_younger(self):
        b = self._batcher(budget=20)
        b.offer(_req("big", prompt_len=30, max_new=4), now=0.0)
        b.offer(_req("small", prompt_len=2, max_new=4), now=0.0)
        assert b.admit(0.0) == []
        assert b.waiting() == 2

    def test_deadline_beats_decode_block(self):
        b = self._batcher(admission_ms=50.0, block=1000)
        b.offer(_req("a"), now=0.0)
        b.admit(0.0)
        b.offer(_req("b"), now=1.0)
        assert not b.admission_due(1.04)
        assert b.admission_due(1.051)

    def test_decode_block_boundary(self):
        b = self._batcher(slots=1, admission_ms=1e9, block=3)
        b.offer(_req("a", max_new=100), now=0.0)
        b.admit(0.0)
        b.offer(_req("b"), now=0.0)
        for _ in range(2):
            assert not b.admission_due(0.0)
            b.note_step()
        b.note_step()
        assert b.admission_due(0.0)
        b.admit(0.0)
        assert b.occupancy() == 1
        assert not b.admission_due(0.0)

    def test_admission_caps_generation_to_cache(self):
        b = ContinuousBatcher(num_slots=2, max_batch_tokens=10_000,
                              admission_ms=50.0, decode_block=8,
                              max_seq=16)
        b.offer(_req("a", prompt_len=12, max_new=10), now=0.0)
        b.offer(_req("b", prompt_len=4, max_new=10), now=0.0)
        capped, fits = b.admit(0.0)
        assert capped.max_tokens == 5 and capped.capped
        assert fits.max_tokens == 10 and not fits.capped
        assert b.committed_tokens() == (12 + 5) + (4 + 10)
        capped.generated.extend([1] * 5)
        assert capped.done

    def test_slots_cap(self):
        b = self._batcher(slots=2)
        for uid in ("a", "b", "c"):
            b.offer(_req(uid), now=0.0)
        assert len(b.admit(0.0)) == 2
        assert b.waiting() == 1

    def test_batch_rows_retire_evict_drain(self):
        b = self._batcher(slots=2)
        b.offer(_req("a", prompt_len=3, max_new=2), now=0.0)
        b.offer(_req("b", prompt_len=5, max_new=9), now=0.0)
        b.offer(_req("c"), now=0.0)
        b.admit(0.0)
        slots, tokens, positions = b.batch_rows()
        assert slots == [0, 1] and tokens == [3, 5] and positions == [3, 5]
        a = b.active()[0]
        a.generated.extend([7, 8])
        a.position += 2
        assert [d.request.uid for d in b.retire_done()] == ["a"]
        slots, tokens, positions = b.batch_rows()
        assert slots == [1] and tokens == [5]
        assert [r.uid for r in b.evict_all()] == ["b"]
        assert [r.uid for r in b.drain_waiting()] == ["c"]
        assert b.occupancy() == 0 and b.waiting() == 0
        assert len(b.admit(0.0)) == 0


# ------------------------------------------------------------------ queue

class TestRequestQueue:
    def test_submit_pull_complete_result(self):
        q = RequestQueue()
        uid = q.submit([1, 2, 3], max_new_tokens=4)
        assert q.try_result(uid) is None
        (req,) = q.pull(rank=0, max_n=8)
        assert req.uid == uid and q.depth() == 0
        q.complete(Completion(uid=uid, tokens=[9], prompt_len=3, rank=0))
        assert q.result(uid, timeout=1.0).tokens == [9]
        assert q.stats()["inflight"] == 0

    def test_requeue_worker_front_oldest_first(self):
        q = RequestQueue()
        uids = [q.submit([i], max_new_tokens=1) for i in range(3)]
        later = q.submit([9], max_new_tokens=1)
        assert [r.uid for r in q.pull(rank=0, max_n=3)] == uids
        assert q.requeue_worker(0) == 3
        assert [r.uid for r in q.pull(rank=1, max_n=10)] == uids + [later]
        assert q.requeue_worker(0) == 0
        assert q.stats()["requeued"] == 3

    def test_first_completion_wins(self):
        q = RequestQueue()
        uid = q.submit([1], max_new_tokens=1)
        q.pull(rank=0, max_n=1)
        q.complete(Completion(uid=uid, tokens=[1], prompt_len=1, rank=0))
        q.complete(Completion(uid=uid, tokens=[2], prompt_len=1, rank=1))
        assert q.result(uid).rank == 0

    def test_results_evicted_after_ttl(self):
        q = RequestQueue(result_ttl=0.05)
        uid = q.submit([1], max_new_tokens=1)
        q.pull(rank=0, max_n=1)
        q.complete(Completion(uid=uid, tokens=[1], prompt_len=1, rank=0))
        assert q.result(uid, timeout=1.0).tokens == [1]
        time.sleep(0.06)
        uid2 = q.submit([2], max_new_tokens=1)
        q.pull(rank=0, max_n=1)
        q.complete(Completion(uid=uid2, tokens=[2], prompt_len=1, rank=0))
        assert q.try_result(uid) is None
        assert q.try_result(uid2) is not None
        stats = q.stats()
        assert stats["completed"] == 2 and stats["results_held"] == 1

    def test_capacity_and_timeout(self):
        q = RequestQueue(capacity=1)
        q.submit([1], max_new_tokens=1)
        with pytest.raises(QueueFull):
            q.submit([2], max_new_tokens=1)
        with pytest.raises(TimeoutError):
            q.result("nope", timeout=0.05)


# ---------------------------------------------------------- prompt buckets

def test_prompt_bucket_policy_is_the_jax_packages():
    assert tkv.PREFILL_BUCKET_QUANTUM == jkv.PREFILL_BUCKET_QUANTUM == 16
    for max_seq in (48, 128, 1024):
        for n in range(1, max_seq + 1):
            assert tkv.prompt_bucket(n, max_seq) == \
                jkv.prompt_bucket(n, max_seq), (n, max_seq)
    assert tkv.prompt_bucket(1, 128) == 16
    assert len({tkv.prompt_bucket(n, 1024) for n in range(1, 1025)}) <= 8


# ------------------------------------------------------------------ engine

@pytest.fixture(scope="module")
def tiny():
    """The JAX test's tiny model and the port's on the same weights."""
    jm = jtr.Transformer(dtype=jnp.float32, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = ttr.Transformer(dtype=torch.float32, device="cpu", **TINY)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _uncached_greedy(tm, prompt, n):
    toks, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            logits = tm(torch.tensor([toks]))
            out.append(int(logits[0, len(toks) - 1].argmax()))
            toks.append(out[-1])
    return out


def _gen(eng, slot, prompt, n, log):
    token, max_abs = eng.prefill(slot, prompt)
    log.append(("prefill", slot, token, max_abs, eng.compiles_total()))
    out, pos = [token], len(prompt)
    for _ in range(n - 1):
        (t,), (m,) = eng.decode([slot], [out[-1]], [pos])
        log.append(("decode", slot, t, m, eng.compiles_total()))
        out.append(t)
        pos += 1
    return out


def _dense_script(eng):
    """Every engine call of the dense cases, with its outputs and the
    compile count after it."""
    log, gen = [], {}
    # two prompt buckets in concurrent slots (parity and isolation)
    prompts = {0: [5, 4, 3, 2, 1], 2: list(range(1, 18))}
    pos = {}
    for slot, p in prompts.items():
        token, max_abs = eng.prefill(slot, p)
        log.append(("prefill", slot, token, max_abs, eng.compiles_total()))
        gen[slot] = [token]
        pos[slot] = len(p)
    for _ in range(5):
        slots = sorted(prompts)
        ids, max_abs = eng.decode(slots, [gen[s][-1] for s in slots],
                                  [pos[s] for s in slots])
        for s, t, m in zip(slots, ids, max_abs):
            log.append(("decode", s, t, m, eng.compiles_total()))
            gen[s].append(t)
            pos[s] += 1
    # a long occupant, then a short prompt in the same slot
    gen["long"] = _gen(eng, 1, list(range(1, 31)), 8, log)
    gen["short"] = _gen(eng, 1, [9, 8, 7, 6], 6, log)
    # a third bucket, and a request evicted mid-generation, then resumed
    gen["b48"] = _gen(eng, 0, list(range(1, 40)), 4, log)
    _gen(eng, 2, [3, 1, 4, 1, 5], 3, log)
    _gen(eng, 2, [2, 7, 1, 8], 2, log)
    gen["resumed"] = _gen(eng, 0, [3, 1, 4, 1, 5], 6, log)
    return gen, log


@pytest.fixture(scope="module")
def dense_jax(tiny):
    jm, params, _ = tiny
    eng = jkv.DecodeEngine(jm, params, num_slots=3)
    gen, log = _dense_script(eng)
    return gen, log, eng.stats()


def _same_log(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a[:3] == b[:3] and a[4] == b[4], (a, b)
        assert math.isfinite(a[3])
        assert abs(a[3] - b[3]) <= MAX_ABS_RTOL * abs(b[3]), (a, b)


def test_dense_engine_generates_the_jax_engines_tokens(tiny, dense_jax):
    """Token for token, max|logit| within 1e-5 relative and the compile
    count equal after every call, across prompt buckets, concurrent slots,
    slot reuse and an evicted-then-resumed request."""
    _, _, tm = tiny
    eng = tkv.DecodeEngine(tm, num_slots=3)
    gen, log = _dense_script(eng)
    jgen, jlog, jstats = dense_jax
    assert gen == jgen
    _same_log(log, jlog)
    assert eng.stats()["compiles"] == jstats["compiles"]
    assert eng.stats()["decode_steps"] == jstats["decode_steps"]
    # the port's own uncached forward agrees too
    assert gen[0] == _uncached_greedy(tm, [5, 4, 3, 2, 1], 6)
    assert gen[2] == _uncached_greedy(tm, list(range(1, 18)), 6)
    assert gen["short"] == _uncached_greedy(tm, [9, 8, 7, 6], 6)
    assert gen["resumed"] == _uncached_greedy(tm, [3, 1, 4, 1, 5], 6)


def test_slot_reuse_leaves_no_stale_row(tiny):
    """A short prompt in the slot a longer request vacated generates what
    it generates in a fresh engine; the prefill zeroed the whole row, so
    even a NaN left by the earlier occupant cannot leak (0 * NaN)."""
    _, _, tm = tiny

    def run(eng, slot, prompt, n):
        return _gen(eng, slot, prompt, n, [])

    used = tkv.DecodeEngine(tm, num_slots=2)
    run(used, 1, list(range(1, 31)), 8)
    for t in used._cache.k + used._cache.v:
        t[1, 20:30] = float("nan")    # a poisoned earlier occupant
    fresh = tkv.DecodeEngine(tm, num_slots=2)
    short = [9, 8, 7, 6]
    assert run(used, 1, short, 6) == run(fresh, 1, short, 6)
    row = used._cache.k[0][1]
    assert torch.isfinite(row).all() and not row[16:].any()


def test_zero_steady_state_compiles(tiny):
    _, _, tm = tiny
    eng = tkv.DecodeEngine(tm, num_slots=2)
    eng.prefill(0, [1, 2, 3])
    eng.decode([0], [1], [3])
    eng.prefill(1, [4, 5])
    warm = eng.compiles_total()
    assert warm == 2
    for step in range(5):
        eng.prefill(step % 2, [7, 8, 9])
        eng.decode([0, 1], [1, 2], [4, 5])
    assert eng.compiles_total() == warm
    assert eng.prefill(0, list(range(1, 20)))
    assert eng.compiles_total() == warm + 1
    assert eng.stats()["decode_steps"] == 6
    # the decode step's buffers and the cache keep their storage
    ptrs = [t.data_ptr() for t in eng._cache.k]
    eng.decode([0], [3], [19])
    assert [t.data_ptr() for t in eng._cache.k] == ptrs


def test_noncausal_model_rejected():
    enc = ttr.Transformer(dtype=torch.float32, device="cpu",
                          **dict(TINY, causal=False))
    with pytest.raises(ValueError, match="causal"):
        tkv.DecodeEngine(enc, num_slots=1)


def test_cached_attention_is_the_jax_function():
    rng = np.random.RandomState(0)
    b, h, new, length, d = 2, 3, 5, 24, 8
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32)
               for n in (new, length, length))
    qpos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    want = np.asarray(jtr.cached_attention(q, k, v, qpos))
    got = ttr.cached_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.from_numpy(qpos)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.linalg.norm(want)


def test_serving_path_is_the_jax_decode_branch(tiny):
    """The model's dense serving path against the JAX decode clone: a
    batch-2 prefill where row 1's prompt is padded (its rows past the
    prompt hold garbage), then a decode step at each row's own position.
    Logits at the real positions and the whole cache within 1e-6 of the
    norm."""
    jm, params, tm = tiny
    jdec = jm.clone(decode=True)
    toks = np.array([[5, 4, 3, 2, 1, 9], [7, 8, 6, 0, 0, 0]], np.int32)
    lens = [6, 3]
    apply = jax.jit(lambda v, t, pos: jdec.apply(
        v, t, positions=pos, train=False, mutable=["cache"]))
    logits, state = apply({"params": params}, toks, np.zeros(2, np.int32))
    step = np.array([[11], [12]], np.int32)
    logits2, state = apply({"params": params, **state}, step,
                           np.array(lens, np.int32))
    cache = ttr.KVCache.dense(tm, 2)
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long(),
                 positions=torch.zeros(2, dtype=torch.long), cache=cache)
        got2 = tm(torch.from_numpy(step).long(),
                  positions=torch.tensor(lens), cache=cache)
    for r, n in enumerate(lens):
        want = np.asarray(logits)[r, :n]
        assert np.abs(got[r, :n].numpy() - want).max() <= \
            1e-6 * np.linalg.norm(want)
    want2 = np.asarray(logits2)
    assert np.abs(got2.numpy() - want2).max() <= 1e-6 * np.linalg.norm(want2)
    jcache = state["cache"]
    for i in range(TINY["num_layers"]):
        for name, ours in (("cached_key", cache.k[i]),
                           ("cached_value", cache.v[i])):
            want = np.asarray(jcache[f"layer_{i}"]["attention"][name])
            assert np.abs(ours.numpy() - want).max() <= \
                1e-6 * np.linalg.norm(want)


# ----------------------------------------------------- replica integrity

class _FakeEngine:
    """Minimal engine double for the replica loop (no model)."""

    def __init__(self, num_slots=2, prefill_abs=1.0, decode_abs=1.0,
                 decode_exc=None):
        self.num_slots = num_slots
        self.max_seq = 64
        self.decode_steps = 0
        self._prefill_abs = prefill_abs
        self._decode_abs = decode_abs
        self._decode_exc = decode_exc

    def prefill(self, slot, prompt):
        return 1, self._prefill_abs

    def decode(self, slots, tokens, positions):
        if self._decode_exc is not None:
            raise self._decode_exc
        self.decode_steps += 1
        abs_ = (list(self._decode_abs)
                if isinstance(self._decode_abs, (list, tuple))
                else [self._decode_abs] * len(slots))
        return [2] * len(slots), abs_[:len(slots)]

    def compiles_total(self):
        return 0

    def cache_bytes(self):
        return 0

    def stats(self):
        return {"decode_steps": self.decode_steps}


def _replica(engine, queue, rank=0):
    return Replica(engine, _LocalTransport(queue, rank),
                   ServePolicy(slots=engine.num_slots, max_new_tokens=4,
                               admission_ms=1.0, decode_block=2),
                   rank=rank)


def test_nan_prefill_quarantines_and_requeues():
    q = RequestQueue()
    rep = _replica(_FakeEngine(prefill_abs=float("nan")), q)
    q.submit([1, 2], max_new_tokens=4)
    rep._iterate()
    assert rep.quarantined
    assert q.depth() == 1 and q.stats()["requeued"] == 1


def test_nan_decode_quarantines_and_requeues():
    q = RequestQueue()
    rep = _replica(_FakeEngine(decode_abs=float("inf")), q)
    q.submit([1, 2], max_new_tokens=4)
    rep._iterate()
    assert rep.quarantined
    assert q.depth() == 1 and q.stats()["requeued"] == 1


def test_workers_down_requeues_and_reraises():
    q = RequestQueue()
    rep = _replica(_FakeEngine(decode_exc=WorkersDownError("reform")), q)
    q.submit([1, 2], max_new_tokens=4)
    with pytest.raises(WorkersDownError):
        rep.run()
    assert not rep.quarantined
    assert q.depth() == 1 and q.stats()["requeued"] == 1


def test_replica_rejects_unservable_prompts():
    q = RequestQueue()
    rep = _replica(_FakeEngine(), q)
    uid_long = q.submit(list(range(100)), max_new_tokens=4)
    uid_empty = q.submit([], max_new_tokens=4)
    rep._iterate()
    assert q.result(uid_long, timeout=1.0).finish == "rejected"
    assert q.result(uid_empty, timeout=1.0).finish == "rejected"
    assert not rep.quarantined and q.stats()["inflight"] == 0


def test_loop_error_quarantines_and_requeues():
    """A device error escaping the step parks the replica quarantined, with
    its work requeued, and ``stats()`` says so."""
    q = RequestQueue()
    rep = _replica(_FakeEngine(decode_exc=RuntimeError("boom")), q)
    q.submit([1, 2], max_new_tokens=4)
    t = threading.Thread(target=rep.run, daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while not rep.quarantined and time.monotonic() < deadline:
        time.sleep(0.01)
    rep.stop()
    t.join(timeout=5.0)
    assert rep.quarantined and not t.is_alive()
    assert q.depth() == 1 and q.stats()["requeued"] == 1
    assert rep.stats()["quarantined"] is True


def test_guard_observes_every_slot():
    class _CountingGuard:
        def __init__(self):
            self.seen = []

        def observe(self, value):
            self.seen.append(value)

    q = RequestQueue()
    rep = _replica(_FakeEngine(decode_abs=[float("nan"), 5.0]), q)
    rep.guard = _CountingGuard()
    q.submit([1, 2], max_new_tokens=4)
    q.submit([3, 4], max_new_tokens=4)
    rep._iterate()
    assert rep.quarantined
    assert 5.0 in rep.guard.seen


def test_healthy_replica_completes():
    q = RequestQueue()
    rep = _replica(_FakeEngine(), q)
    uid = q.submit([1, 2], max_new_tokens=3)
    for _ in range(4):
        rep._iterate()
    done = q.result(uid, timeout=1.0)
    assert done.tokens == [1, 2, 2] and done.rank == 0
    assert not rep.quarantined and rep.completed == 1


# ----------------------------------------------------------- policy / api

def test_policy_from_env_and_overrides(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_SLOTS", "3")
    monkeypatch.setenv("HOROVOD_SERVE_ADMISSION_MS", "12.5")
    p = ServePolicy.from_env(max_new_tokens=7)
    assert p.slots == 3 and p.admission_ms == 12.5
    assert p.max_new_tokens == 7
    with pytest.raises(TypeError, match="unknown serve policy knob"):
        ServePolicy.from_env(slotz=3)


def test_policy_defaults_are_the_jax_packages():
    from horovod_tpu.serve.api import ServePolicy as JaxPolicy

    assert ServePolicy() == ServePolicy(**vars(JaxPolicy()))


class _Tokenizer:
    def encode(self, text):
        return [ord(c) % 50 + 1 for c in text]


def test_submit_validates_prompt_against_max_seq():
    q = RequestQueue()
    rep = _replica(_FakeEngine(), q)
    handle = ServeHandle([rep], q, ServePolicy(max_new_tokens=4))
    try:
        with pytest.raises(ValueError, match="empty"):
            handle.submit([])
        with pytest.raises(ValueError, match="max_seq"):
            handle.submit([1] * 65)
        done = handle.generate([1] * 64, timeout=10.0)
        assert done.finish == "cache_limit" and len(done.tokens) == 1
        done = handle.generate([1] * 8, timeout=10.0)
        assert done.finish == "length" and len(done.tokens) == 4
    finally:
        handle.close()
    with pytest.raises(RuntimeError, match="closed"):
        handle.submit([1])


def test_serve_end_to_end_in_process(tiny, dense_jax):
    """``hvd.serve`` with two replica threads over the tiny model: every
    request completes with its budget, the tokens of [5, 4, 3, 2, 1] are
    the JAX engine's, and each replica adds at most one prompt bucket and
    the decode program."""
    from horovod_tpu_torch.serve import serve_state

    _, _, tm = tiny
    with hvd.serve(tm, tokenizer=_Tokenizer(), replicas=2, slots=2,
                   max_new_tokens=6, admission_ms=5.0,
                   decode_block=2) as handle:
        assert serve_state()["count"] == 1
        uids = [handle.submit([5, 4, 3, 2, 1]) for _ in range(3)]
        uids += [handle.submit([1 + i, 2, 3]) for i in range(3)]
        uids.append(handle.submit("hi"))
        outs = [handle.result(u, timeout=120.0) for u in uids]
        assert all(len(o.tokens) == 6 for o in outs)
        assert all(0 <= t < TINY["vocab_size"]
                   for o in outs for t in o.tokens)
        assert all(o.latency_s >= o.ttft_s >= 0.0 for o in outs)
        assert all(o.tokens == dense_jax[0][0] for o in outs[:3])
        assert handle.compiles_total() <= 4
        assert handle.stats()["queue"]["completed"] == 7
        assert not any(r["quarantined"]
                       for r in serve_state()["handles"][0]["replicas"])
    assert serve_state()["count"] == 0


# --------------------------------------------------------- KV transport

def test_kv_frontend_redispatches_dead_replica():
    from horovod_tpu_torch.run.rendezvous import (KVStoreClient,
                                                  RendezvousServer)

    server = RendezvousServer(host="127.0.0.1")
    port = server.start()
    try:
        def client():
            return KVStoreClient("127.0.0.1", port, scope="serve",
                                 timeout=5.0)

        front = KVQueueFrontend(client(), stale_seconds=0.4)
        dead = KVQueueReplica(client(), rank=1)
        live = KVQueueReplica(client(), rank=2)
        dead.heartbeat()
        live.heartbeat()
        assert front.wait_for_replicas(2, timeout=5.0) == [1, 2]
        req = Request(uid="r1", prompt=[1, 2, 3], max_new_tokens=2)
        assert front.submit(req, rank=1) == 1
        (got,) = dead.poll(4)
        assert got.uid == "r1"
        deadline = time.monotonic() + 5.0
        while 1 in front.live_replicas() and time.monotonic() < deadline:
            live.heartbeat()
            time.sleep(0.05)
        assert front.live_replicas() == [2]
        assert front.poll_responses() == []
        assert front.requeued == 1 and front.dead_ranks == {1}
        (redis,) = live.poll(4)
        assert redis.uid == "r1"
        live.complete(Completion(uid="r1", tokens=[5, 6], prompt_len=3,
                                 rank=2))
        deadline = time.monotonic() + 5.0
        while front.pending() and time.monotonic() < deadline:
            front.poll_responses()
            time.sleep(0.02)
        assert front.pending() == 0
        assert front._done["r1"].rank == 2
        dead.complete(Completion(uid="r1", tokens=[9, 9], prompt_len=3,
                                 rank=1))
        assert front.poll_responses() == []
        assert front._done["r1"].rank == 2
        front.stop_fleet()
        assert dead.stopped() and live.stopped()
    finally:
        server.stop()


def test_worker_process_serves_through_the_kv_queue(tmp_path):
    """One ``python -m horovod_tpu_torch.serve --device cpu`` replica (rank
    1) against an in-process rendezvous server: two requests through
    ``KVQueueFrontend`` complete with their budgets, the stop key drains
    the worker (exit 0), and its profile dump carries the request spans
    under the trace ids the frontend minted."""
    from horovod_tpu_torch.run.rendezvous import (KVStoreClient,
                                                  RendezvousServer)

    server = RendezvousServer(host="127.0.0.1")
    port = server.start()
    proc = None
    try:
        env = dict(os.environ, HOROVOD_RANK="1",
                   HOROVOD_RENDEZVOUS_HTTP_ADDR="127.0.0.1",
                   HOROVOD_RENDEZVOUS_HTTP_PORT=str(port),
                   HOROVOD_PROFILE_DIR=str(tmp_path),
                   HOROVOD_SERVE_ADMISSION_MS="1",
                   PYTHONPATH=REPO)
        proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.serve", "--device",
             "cpu", "--vocab", "64", "--d-model", "16", "--layers", "1",
             "--heads", "1", "--d-ff", "32", "--max-seq", "32"],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        front = KVQueueFrontend(
            KVStoreClient("127.0.0.1", port, scope="serve", timeout=10.0))
        assert front.wait_for_replicas(1, timeout=90.0) == [1]
        reqs = [Request(uid=f"w{i}", prompt=[1 + i, 2, 3, 4],
                        max_new_tokens=4, submitted_s=time.monotonic())
                for i in range(2)]
        for req in reqs:
            front.submit(req, rank=1)
        deadline = time.monotonic() + 90.0
        while front.pending() and time.monotonic() < deadline:
            front.poll_responses()
            time.sleep(0.05)
        assert front.pending() == 0
        for req in reqs:
            done = front._done[req.uid]
            assert len(done.tokens) == 4 and done.rank == 1
            assert done.trace_id == req.trace_id
        front.stop_fleet()
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out[-2000:]
        assert "rank 1 drained (2 completed)" in out
        with open(tmp_path / "profile-rank-1.json") as f:
            spans = json.load(f)["request_spans"]
        for req in reqs:
            names = {s["name"] for s in spans
                     if s.get("trace_id") == req.trace_id}
            assert {"request.queue_wait", "request.prefill",
                    "request.serve"} <= names
            assert all(s["rank"] == 1 for s in spans
                       if s.get("trace_id") == req.trace_id)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
        server.stop()
