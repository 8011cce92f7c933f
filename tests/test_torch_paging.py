"""The port's paged KV cache (``horovod_tpu_torch/serve/paging.py``) against
the JAX package's (``horovod_tpu/serve/paging.py``), case by case after
tests/test_paging.py.

* The page pool, the prefix cache and page-aware admission are pure
  bookkeeping: they run on the port alone.
* The paged engine is held against the JAX package's on the tiny float32
  model of tests/test_paging.py (built in JAX from ``PRNGKey(0)``, carried
  over with ``params_from_flax``): one scripted call sequence (three prompt
  buckets, prompts over several pages, a shared 16-token prefix whose
  sharers copy-on-write, an exact repeat with no prefill compute, a
  request released mid-generation and prefilled again) runs through JAX's
  ``PagedDecodeEngine`` once per module and through the port's: tokens
  equal, max|logit| within 1e-5 relative, and the compile count, COW
  copies, reused and computed tokens and exact hits equal after every
  call.
* The model's paged serving path matches the JAX decode branch within
  1e-6 of the norm, one row's prompt padded, a table column on the scratch
  page.
* ``hvd.serve(paged=True)`` end to end: preemption under pool pressure
  still delivers the full budget, and a replica killed mid-decode returns
  every request-held page.
"""

import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtr
from horovod_tpu.serve import paging as jpg
from horovod_tpu_torch import memory
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.serve import paging
from horovod_tpu_torch.serve import serve as hvd_serve
from horovod_tpu_torch.serve.api import ServePolicy
from horovod_tpu_torch.serve.batcher import ContinuousBatcher
from horovod_tpu_torch.serve.paging import (PagedDecodeEngine, PagePool,
                                            PagePoolExhausted, PrefixCache,
                                            auto_pool_pages)
from horovod_tpu_torch.serve.queue import Request

TINY = dict(vocab_size=61, d_model=32, num_layers=2, num_heads=2, d_ff=64,
            max_seq=48, causal=True)
MAX_ABS_RTOL = 1e-5


def _req(uid, prompt, max_new=8):
    return Request(uid=uid, prompt=list(prompt), max_new_tokens=max_new,
                   submitted_s=0.0)


# --------------------------------------------------------------- PagePool

class TestPagePool:
    def test_alloc_ref_unref_cycle(self):
        pool = PagePool(pages=5, page_tokens=16)
        assert pool.allocatable == 4
        got = [pool.alloc() for _ in range(4)]
        assert sorted(got) == [1, 2, 3, 4]
        assert pool.free_count() == 0 and pool.used_count() == 4
        pool.ref(got[0])
        assert pool.refcount(got[0]) == 2
        assert pool.unref(got[0]) is False
        assert pool.unref(got[0]) is True
        assert pool.free_count() == 1
        assert pool.alloc() == got[0]

    def test_exhaustion_and_bad_refs(self):
        pool = PagePool(pages=3, page_tokens=16)
        pool.alloc(), pool.alloc()
        with pytest.raises(PagePoolExhausted):
            pool.alloc()
        with pytest.raises(ValueError):
            pool.ref(0)
        with pytest.raises(ValueError):
            pool.unref(1_000)

    def test_reclaim_hook_runs_outside_lock(self):
        pool = PagePool(pages=3, page_tokens=16)
        held = [pool.alloc(), pool.alloc()]
        pool.set_reclaim_hook(lambda: pool.unref(held.pop()))
        assert pool.alloc() in (1, 2)
        assert pool.stats()["reclaims"] == 1

    def test_too_small_pool_rejected(self):
        with pytest.raises(ValueError):
            PagePool(pages=1, page_tokens=16)

    def test_auto_pool_pages_is_the_jax_packages(self):
        assert auto_pool_pages(4, 96, 16) == 12
        assert auto_pool_pages(1, 48, 16) == 4
        assert auto_pool_pages(8, 1024, 16) == 256
        for args in ((4, 96, 16), (1, 48, 16), (8, 1024, 16), (3, 100, 8)):
            assert auto_pool_pages(*args) == jpg.auto_pool_pages(*args)
        assert (paging.DEFAULT_PAGE_TOKENS, paging.DEFAULT_PREFIX_ENTRIES) \
            == (jpg.DEFAULT_PAGE_TOKENS, jpg.DEFAULT_PREFIX_ENTRIES)


# ------------------------------------------------------------ PrefixCache

class TestPrefixCache:
    def _cache(self, pages=8, capacity=16):
        pool = PagePool(pages=pages, page_tokens=4)
        return pool, PrefixCache(pool, capacity)

    def test_block_walk_and_probe(self):
        pool, cache = self._cache()
        prompt = list(range(10))
        pages = [pool.alloc() for _ in range(3)]
        cache.insert(prompt, pages, first_token=7, max_abs=1.0)
        assert cache.probe(prompt) == 2
        assert cache.probe(prompt[:8] + [99, 98]) == 2
        assert cache.probe([99] + prompt[1:]) == 0
        hit, exact = cache.lookup(prompt[:8] + [99, 98])
        assert hit == pages[:2] and exact is None
        hit, exact = cache.lookup(prompt)
        assert exact is not None
        assert list(exact[0]) == pages and exact[1] == 7

    def test_insert_refs_and_eviction_unrefs(self):
        pool, cache = self._cache()
        prompt = list(range(8))
        pages = [pool.alloc(), pool.alloc()]
        cache.insert(prompt, pages, 1, 1.0)
        assert len(cache) == 3
        assert pool.refcount(pages[0]) == 3
        assert pool.refcount(pages[1]) == 3
        cache.release_all()
        assert len(cache) == 0
        assert pool.refcount(pages[0]) == 1
        assert pool.refcount(pages[1]) == 1

    def test_capacity_trim_evicts_lru(self):
        pool, cache = self._cache(capacity=2)
        pages = [pool.alloc(), pool.alloc()]
        cache.insert(list(range(8)), pages, 1, 1.0)
        assert len(cache) == 2
        assert cache.evictions == 1
        assert cache.probe(list(range(8))) == 0

    def test_reclaim_one_frees_under_pressure(self):
        pool, cache = self._cache(pages=4)
        pages = [pool.alloc(), pool.alloc()]
        cache.insert(list(range(8)), pages, 1, 1.0)
        pool.unref(pages[0]), pool.unref(pages[1])
        pool.set_reclaim_hook(cache.reclaim_one)
        for _ in range(3):
            pool.alloc()
        assert len(cache) == 0
        with pytest.raises(PagePoolExhausted):
            pool.alloc()

    def test_hash_collision_verified_against_tokens(self):
        pool, cache = self._cache()
        page = pool.alloc()
        cache.insert([1, 2, 3, 4], [page], 1, 1.0)
        hit, _ = cache.lookup([1, 2, 3, 5])
        assert hit == []


# ----------------------------------------------- page-aware admission

class TestPagedAdmission:
    def _batcher(self, pool_pages=4, page_tokens=16, probe=None,
                 slots=4, max_seq=48):
        return ContinuousBatcher(
            num_slots=slots, max_batch_tokens=10_000, admission_ms=50.0,
            decode_block=8, max_seq=max_seq, page_tokens=page_tokens,
            pool_pages=pool_pages, prefix_probe=probe)

    def test_pool_pages_cap_admission(self):
        b = self._batcher()
        for uid in ("a", "b"):
            b.offer(_req(uid, range(1, 18), max_new=32), now=0.0)
        admitted = b.admit(0.0)
        assert [a.request.uid for a in admitted] == ["a"]
        assert admitted[0].page_cost == 3
        assert b.committed_pages() == 3
        assert b.waiting() == 1

    def test_prefix_probe_discounts_page_cost(self):
        b = self._batcher(probe=lambda prompt: 1)
        for uid in ("a", "b"):
            b.offer(_req(uid, range(1, 18), max_new=32), now=0.0)
        admitted = b.admit(0.0)
        assert [a.request.uid for a in admitted] == ["a", "b"]
        assert all(a.page_cost == 2 for a in admitted)

    def test_single_request_capped_to_pool(self):
        b = self._batcher(max_seq=None)
        b.offer(_req("a", range(40), max_new=64), now=0.0)
        (a,) = b.admit(0.0)
        assert a.max_tokens == 4 * 16 - 40 + 1 == 25
        assert a.capped

    def test_preempt_newest_to_queue_front(self):
        b = self._batcher(pool_pages=100)
        for uid in ("old", "mid", "new"):
            b.offer(_req(uid, range(1, 9)), now=0.0)
        b.admit(0.0)
        assert b.occupancy() == 3
        victim = b.preempt_newest(now=1.0)
        assert victim.request.uid == "new"
        assert b.preemptions == 1 and victim.request.requeues == 1
        b.offer(_req("younger", range(1, 9)), now=1.0)
        readmitted = b.admit(1.0)
        assert [a.request.uid for a in readmitted] == ["new", "younger"]
        mid = next(a for a in b.active() if a.request.uid == "mid")
        survivor = b.preempt_newest(exclude_slot=None, now=2.0)
        assert survivor.request.uid == "younger"
        assert b.preempt_newest(exclude_slot=mid.slot, now=2.0) \
               .request.uid != "mid"

    def test_dense_batcher_unaffected(self):
        b = ContinuousBatcher(num_slots=4, max_batch_tokens=10_000,
                              admission_ms=50.0, decode_block=8)
        b.offer(_req("a", range(1, 9)), now=0.0)
        (a,) = b.admit(0.0)
        assert a.page_cost == 0
        assert b.committed_pages() == 0


# ------------------------------------------------------------------ engine

@pytest.fixture(scope="module")
def tiny():
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


def _counters(eng):
    return (eng.compiles_total(), eng.cow_copies, eng.reused_tokens,
            eng.computed_tokens, eng.exact_hits, eng.pool.free_count())


def _gen(eng, slot, prompt, n, log):
    token, max_abs = eng.prefill(slot, prompt)
    log.append(("prefill", slot, token, max_abs, _counters(eng)))
    out, pos = [token], len(prompt)
    for _ in range(n - 1):
        (t,), (m,) = eng.decode([slot], [out[-1]], [pos])
        log.append(("decode", slot, t, m, _counters(eng)))
        out.append(t)
        pos += 1
    return out


def _paged_script(eng):
    log, gen = [], {}
    # three prompt buckets, prompts over one, two and three pages
    for slot, prompt in ((0, [5, 4, 3, 2, 1]), (1, list(range(1, 18))),
                         (2, list(range(2, 37)))):
        gen[len(prompt)] = _gen(eng, slot, prompt, 6, log)
    for slot in range(3):
        eng.release_slot(slot)
    # a shared 16-token prefix block: the second sharer reuses the page
    # and copies it on its first divergent write
    shared = list(range(1, 17))
    a, b = shared + [20, 21], shared + [30]
    pos, cur = {}, {}
    for slot, p in ((0, a), (1, b)):
        token, max_abs = eng.prefill(slot, p)
        log.append(("prefill", slot, token, max_abs, _counters(eng)))
        cur[slot], pos[slot] = [token], len(p)
    for _ in range(5):
        ids, max_abs = eng.decode([0, 1], [cur[0][-1], cur[1][-1]],
                                  [pos[0], pos[1]])
        for s, t, m in zip((0, 1), ids, max_abs):
            log.append(("decode", s, t, m, _counters(eng)))
            cur[s].append(t)
            pos[s] += 1
    gen["a"], gen["b"] = cur[0], cur[1]
    for slot in range(2):
        eng.release_slot(slot)
    # an exact repeat replays the cached pages and first token
    prompt = list(range(3, 24))
    gen["first"] = _gen(eng, 0, prompt, 4, log)
    gen["repeat"] = _gen(eng, 1, prompt, 4, log)
    # preempted mid-generation (its pages released), then resumed
    _gen(eng, 2, [3, 1, 4, 1, 5, 9, 2, 6], 3, log)
    eng.release_slot(2)
    gen["resumed"] = _gen(eng, 2, [3, 1, 4, 1, 5, 9, 2, 6], 6, log)
    return gen, log


@pytest.fixture(scope="module")
def paged_jax(tiny):
    jm, params, _ = tiny
    eng = jpg.PagedDecodeEngine(jm, params, num_slots=3, page_tokens=16,
                                pool_pages=12)
    gen, log = _paged_script(eng)
    return gen, log, eng.stats()


def _engine(tm, slots=3, **kw):
    kw.setdefault("page_tokens", 16)
    kw.setdefault("pool_pages", 12)
    return PagedDecodeEngine(tm, num_slots=slots, **kw)


def test_paged_engine_generates_the_jax_engines_tokens(tiny, paged_jax):
    _, _, tm = tiny
    eng = _engine(tm)
    gen, log = _paged_script(eng)
    jgen, jlog, jstats = paged_jax
    assert gen == jgen
    assert len(log) == len(jlog)
    for a, b in zip(log, jlog):
        assert a[:3] == b[:3] and a[4] == b[4], (a, b)
        assert math.isfinite(a[3])
        assert abs(a[3] - b[3]) <= MAX_ABS_RTOL * abs(b[3]), (a, b)
    stats = eng.stats()
    assert stats["compiles"] == jstats["compiles"]
    assert stats["pages"] == jstats["pages"]
    assert gen["a"] == _uncached_greedy(tm, list(range(1, 17)) + [20, 21], 6)
    assert gen["b"] == _uncached_greedy(tm, list(range(1, 17)) + [30], 6)
    assert gen["repeat"] == gen["first"]
    assert gen[35] == _uncached_greedy(tm, list(range(2, 37)), 6)


def test_shared_prefix_cow_isolation(tiny):
    _, _, tm = tiny
    eng = _engine(tm)
    shared = list(range(1, 17))
    a, b = shared + [20, 21], shared + [30]
    token_a, _ = eng.prefill(0, a)
    cows0 = eng.cow_copies
    token_b, _ = eng.prefill(1, b)
    assert eng.reused_tokens >= 16
    gen = {0: [token_a], 1: [token_b]}
    pos = {0: len(a), 1: len(b)}
    for _ in range(5):
        ids, _ = eng.decode([0, 1], [gen[0][-1], gen[1][-1]],
                            [pos[0], pos[1]])
        for s, t in zip((0, 1), ids):
            gen[s].append(t)
            pos[s] += 1
    assert eng.cow_copies > cows0
    assert gen[0] == _uncached_greedy(tm, a, 6)
    assert gen[1] == _uncached_greedy(tm, b, 6)


def test_exact_replay_zero_prefill_compute(tiny):
    _, _, tm = tiny
    eng = _engine(tm)
    prompt = list(range(3, 24))
    first = _gen(eng, 0, prompt, 4, [])
    computed = eng.computed_tokens
    repeat = _gen(eng, 1, prompt, 4, [])
    assert eng.exact_hits == 1
    assert eng.computed_tokens == computed
    assert repeat == first == _uncached_greedy(tm, prompt, 4)
    assert eng.prefix_hit_rate() > 0


def test_zero_steady_state_compiles_canary(tiny):
    _, _, tm = tiny
    eng = _engine(tm, slots=2)
    eng.prefill(0, [1] * 16)
    eng.prefill(0, list(range(2, 22)))
    eng.decode([0], [1], [20])
    warm = eng.compiles_total()
    shared = list(range(2, 18))
    for step in range(6):
        slot = step % 2
        eng.prefill(slot, shared + [25 + step])
        (t,), _ = eng.decode([slot], [3], [17])
        eng.decode([slot], [t], [18])
    eng.release_slot(0)
    eng.prefill(0, shared + [40])
    eng.decode([0, 1], [1, 2], [17, 19])
    assert eng.compiles_total() == warm
    assert eng.cow_copies > 0
    stats = eng.stats()
    assert stats["pages"]["prefix_hit_rate"] > 0
    assert stats["compiles"]["page_copy"] == 1
    # the step's static table keeps its storage: the graph's address
    ptr = eng.step.table.data_ptr()
    eng.decode([0], [1], [18])
    assert eng.step.table.data_ptr() == ptr


def test_exhaustion_rolls_back_and_recovers(tiny):
    _, _, tm = tiny
    eng = _engine(tm, slots=2, pool_pages=4)
    eng.prefill(0, list(range(1, 34)))
    assert eng.pool.free_count() == 0
    with pytest.raises(PagePoolExhausted):
        eng.prefill(1, list(range(40, 57)))
    assert eng.pool.free_count() == 0
    assert eng._tables[1] == []
    eng.release_slot(0)
    token, _ = eng.prefill(1, list(range(40, 57)))
    assert isinstance(token, int)
    assert eng.page_stats()["request_held"] >= 2


def test_release_all_reclaims_every_request_page(tiny):
    _, _, tm = tiny
    eng = _engine(tm, slots=3)
    for slot, n in ((0, 5), (1, 20), (2, 33)):
        _gen(eng, slot, list(range(1, n + 1)), 3, [])
    assert eng.page_stats()["request_held"] > 0
    eng.release_all()
    stats = eng.page_stats()
    assert stats["request_held"] == 0
    assert stats["free"] + len(eng.prefix.held_pages()) \
        == eng.pool.allocatable


def test_paged_pool_bytes_in_memory_ledger(tiny):
    _, _, tm = tiny
    eng = _engine(tm)
    assert "kv_pages" in memory.DEVICE_SUBSYSTEMS
    assert paging.total_pool_bytes() >= eng.cache_bytes() > 0
    # 12 pages x 16 tokens x 32 wide x (k, v) x 2 layers x 4 bytes
    assert eng.cache_bytes() == 12 * 16 * 32 * 2 * 2 * 4
    ledger = memory.tracker().ledger()
    assert ledger["subsystems"]["kv_pages"]["bytes"] >= eng.cache_bytes()


def test_paged_serving_path_is_the_jax_decode_branch(tiny):
    """The model's paged path against the JAX paged decode clone: a batch-2
    prefill (row 1's prompt padded past its one mapped page, onto the
    scratch column), then a step at each row's position; logits at the
    real positions and the whole pool within 1e-6 of the norm."""
    jm, params, tm = tiny
    pages, T = 8, 16
    width = -(-TINY["max_seq"] // T) + 1
    table = np.zeros((2, width), np.int32)
    table[0, :2] = [3, 5]
    table[1, :1] = [6]
    toks = np.arange(1, 41, dtype=np.int32).reshape(2, 20) % 61
    lens = [20, 9]
    toks[1, 9:] = 0
    jdec = jm.clone(decode=True, paged=True, num_pages=pages, page_tokens=T)
    apply = jax.jit(lambda v, t, pos: jdec.apply(
        v, t, positions=pos, page_table=table, train=False,
        mutable=["cache"]))
    logits, state = apply({"params": params}, toks, np.zeros(2, np.int32))
    step = np.array([[11], [12]], np.int32)
    logits2, state = apply({"params": params, **state}, step,
                           np.array(lens, np.int32))
    cache = ttr.KVCache.paged(tm, pages, T)
    tt = torch.from_numpy(table).long()
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long(),
                 positions=torch.zeros(2, dtype=torch.long), cache=cache,
                 page_table=tt)
        got2 = tm(torch.from_numpy(step).long(),
                  positions=torch.tensor(lens), cache=cache, page_table=tt)
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
            # the scratch page 0 takes the padded garbage in an order
            # neither side fixes; every real page must agree
            want = np.asarray(jcache[f"layer_{i}"]["attention"][name])[1:]
            assert np.abs(ours[1:].numpy() - want).max() <= \
                1e-6 * np.linalg.norm(want)


def test_policy_paged_knobs_from_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_PAGED", "1")
    monkeypatch.setenv("HOROVOD_SERVE_PAGE_TOKENS", "32")
    monkeypatch.setenv("HOROVOD_SERVE_PAGE_POOL", "64")
    monkeypatch.setenv("HOROVOD_SERVE_PREFIX_CACHE", "9")
    policy = ServePolicy.from_env()
    assert policy.paged and policy.page_tokens == 32
    assert policy.page_pool == 64 and policy.prefix_cache == 9
    assert not ServePolicy.from_env(paged=False).paged


def test_non_power_of_two_page_tokens_rejected(tiny):
    with pytest.raises(ValueError, match="power of two"):
        _engine(tiny[2], page_tokens=12)


def test_pool_too_small_for_max_seq_rejected(tiny):
    with pytest.raises(ValueError, match="max_seq"):
        _engine(tiny[2], pool_pages=3)


# ------------------------------------------------------------ e2e serve

def test_preempted_request_completes_full_budget(tiny):
    """Under pool pressure the newest request goes back to the queue front
    and, once pages free, completes with its full budget: the tokens of a
    run that was never preempted."""
    _, _, tm = tiny
    handle = hvd_serve(tm, replicas=1, paged=True, page_tokens=16,
                       page_pool=5, prefix_cache=16, slots=4,
                       max_new_tokens=32, admission_ms=5.0, decode_block=4,
                       max_batch_tokens=4096, quarantine=False)
    try:
        shared = list(range(1, 17))
        prompts = [shared + [17 + i] for i in range(3)]
        uids = [handle.submit(p) for p in prompts]
        outs = [handle.result(u, timeout=120.0) for u in uids]
        assert all(len(o.tokens) == 32 for o in outs)
        assert all(o.finish == "length" for o in outs)
        replica = handle._replicas[0]
        assert replica.engine.preemptions >= 1
        assert sum(o.requeues for o in outs) >= 1
        assert replica.stats()["pages"]["request_held"] == 0
        for p, o in zip(prompts, outs):
            assert o.tokens == _uncached_greedy(tm, p, len(o.tokens))
    finally:
        handle.close()


def test_chaos_replica_death_reclaims_pages(tiny):
    _, _, tm = tiny
    handle = hvd_serve(tm, replicas=2, paged=True, page_tokens=16, slots=4,
                       max_new_tokens=4, admission_ms=5.0, decode_block=4,
                       max_batch_tokens=4096, quarantine=True)
    try:
        victim = handle._replicas[0]

        def killed_decode(slots, tokens, positions):
            raise RuntimeError("chaos: replica killed mid-decode")

        victim.engine.decode = killed_decode
        uids, deadline = [], time.monotonic() + 30.0
        while not victim.quarantined and time.monotonic() < deadline:
            uids.append(handle.submit(list(range(1, 9)) + [len(uids) % 50]))
            time.sleep(0.02)
        assert victim.quarantined, "victim replica never pulled work"
        outs = [handle.result(u, timeout=120.0) for u in uids]
        assert all(len(o.tokens) == 4 for o in outs)
        assert all(o.rank == 1 for o in outs if o.requeues)
        assert victim.engine.page_stats()["request_held"] == 0
    finally:
        handle.close()
