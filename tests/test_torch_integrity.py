"""The port's integrity digests, silent-corruption faults and rollback
(mirrors tests/test_integrity.py's digest, inject and rollback units).

Parity with the JAX package is bit-equal: ``checksum``,
``nonfinite_count``, ``vote`` and ``verify`` on the same seeded float32,
bfloat16 and int32 arrays; ``parse_clause`` gives the same spec or the
same rejection. The executor's digests run in a one-rank world: a ``nan``
input is convicted on the allreduce and the reduce-scatter lanes, and a
ZeRO-1 ``sharded_adamw`` run under ``@hvd.elastic.run`` rolls back to its
checkpoint cut and replays onto the clean run's bits."""

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import exceptions as jexc
from horovod_tpu.integrity import digest as jdigest
from horovod_tpu.integrity import inject as jinject
from horovod_tpu_torch import exceptions
from horovod_tpu_torch.integrity import digest, guards, inject, rollback


@pytest.fixture(autouse=True)
def _fresh_integrity_state():
    for mod in (digest, inject, guards, rollback, jdigest, jinject):
        mod.reset()
    yield
    for mod in (digest, inject, guards, rollback, jdigest, jinject):
        mod.reset()


@pytest.fixture
def world1():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _arrays(seed):
    """(numpy, torch) pairs: float32 and bfloat16 with NaN/Inf planted,
    int32."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(64).astype(np.float32)
    f[[3, 17]] = [np.nan, np.inf]
    b = rng.standard_normal(33).astype(ml_dtypes.bfloat16)
    b[5] = -np.inf
    i = rng.integers(-1000, 1000, 40).astype(np.int32)
    return [(f, torch.from_numpy(f.copy())),
            (b, torch.from_numpy(b.view(np.int16).copy()).view(
                torch.bfloat16)),
            (i, torch.from_numpy(i.copy())),
            (np.zeros(4, np.float32), torch.zeros(4)),
            (np.array([-0.0], np.float32), torch.tensor([-0.0]))]


# ---------------------------------------------------------------------------
# digest primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_checksum_and_nonfinite_count_are_the_jax_packages(seed):
    for a, t in _arrays(seed):
        assert digest.checksum(t) == jdigest.checksum(a)
        assert digest.checksum(a) == jdigest.checksum(a)
        assert digest.nonfinite_count(t) == jdigest.nonfinite_count(a)
        assert int(digest.nonfinite_count_tensor(t)) == \
            jdigest.nonfinite_count(a)
    assert digest.checksum(torch.tensor([0.0])) != \
        digest.checksum(torch.tensor([-0.0]))


def test_corruptors_match_the_jax_bytes():
    for a, t in _arrays(4)[:2]:
        a, t = a.copy(), t.clone()
        jinject.corrupt_nan(a)
        inject.corrupt_nan(t)
        assert digest.checksum(t) == jdigest.checksum(a)
        assert digest.nonfinite_count(t) == jdigest.nonfinite_count(a)
        jinject.corrupt_bitflip(a)
        inject.corrupt_bitflip(t)
        assert digest.checksum(t) == jdigest.checksum(a)


_VOTES = [[7, 7, 7], [7, 9, 7], [9, 7, 7, 7], [7, 9], [7, 7, 9, 9, 7],
          [7, 7, 9, 5], [1], [], [3, 3, 3, 4, 3, 3]]


@pytest.mark.parametrize("crcs", _VOTES)
def test_vote_is_the_jax_packages(crcs):
    assert digest.vote(crcs) == jdigest.vote(crcs)


_RECORDS = [
    [(0, 42), (0, 42), (0, 42)],
    [(0, 1), (3, 1), (0, 1)],
    [(2, 1), (0, 9), (0, 9)],
    [(0, 7), (0, 7), (0, 9)],
    [(0, 7), (0, 9)],
    [(0, 5), (1, 5)],
]


def _verdict(verify, excs, records):
    try:
        verify(records, bucket="fused[8]", tensor="grad/w")
    except excs.NumericalError as exc:
        return (type(exc).__name__, exc.suspect_rank, exc.bucket,
                exc.tensor)
    return None


@pytest.mark.parametrize("records", _RECORDS)
def test_verify_is_the_jax_packages(records):
    assert _verdict(digest.verify, exceptions, records) == \
        _verdict(jdigest.verify, jexc, records)


def test_verify_local_and_cadence(monkeypatch):
    digest.verify_local(0, bucket="b")
    with pytest.raises(exceptions.NumericalError) as ei:
        digest.verify_local(4, bucket="zero.grads", tensor="leaf[1]",
                            suspect_rank=5)
    assert ei.value.suspect_rank == 5
    monkeypatch.setenv("HOROVOD_INTEGRITY", "1")
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "3")
    hits = [digest.cadence_due("lane") for _ in range(7)]
    assert hits == [jdigest.cadence_due("lane") for _ in range(7)] == \
        [True, False, False, True, False, False, True]
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "0")
    assert not digest.cadence_due("lane")
    monkeypatch.delenv("HOROVOD_INTEGRITY")
    assert hvd.integrity.interval() == 0
    monkeypatch.delenv("HOROVOD_INTEGRITY_INTERVAL")
    assert hvd.integrity.interval() == 32


# ---------------------------------------------------------------------------
# fault-injection grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clause", [
    "bitflip:1", " nan : 3 : after=5 ", "nan:0:after=0", "bitflip:-1",
    "bitflip", "nan:0:steps=2", "melt:0", "nan:x", "nan:1:after=",
])
def test_parse_clause_is_the_jax_packages(clause):
    try:
        want = jinject.parse_clause(clause)
    except ValueError:
        with pytest.raises(ValueError):
            inject.parse_clause(clause)
        return
    got = inject.parse_clause(clause)
    assert (got.action, got.rank, got.after, got.fired) == \
        (want.action, want.rank, want.after, want.fired)


def test_composes_with_process_fault_grammar(monkeypatch):
    from horovod_tpu_torch.elastic import fault_inject

    monkeypatch.setenv("HOROVOD_FAULT_INJECT",
                       "kill:rank=1:step=3:code=17;bitflip:0:after=2")
    spec = fault_inject.spec_from_env()
    assert spec is not None and spec.action == "kill"
    specs = inject.specs_from_env()
    assert len(specs) == 1 and specs[0].action == "bitflip"


def test_after_countdown_and_one_shot(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_INJECT", "nan:5:after=2")
    assert [inject.plan_dispatch_any() for _ in range(4)] == \
        [jinject.plan_dispatch_any() for _ in range(4)] == \
        [None, None, ("nan", 5), None]


def test_plan_dispatch_filters_by_launch_rank(monkeypatch):
    from horovod_tpu_torch.elastic import fault_inject

    monkeypatch.setenv("HOROVOD_FAULT_INJECT", "bitflip:1")
    monkeypatch.setattr(fault_inject, "_initial_rank", 0)
    assert inject.plan_dispatch() is None
    monkeypatch.setattr(fault_inject, "_initial_rank", 1)
    inject.reset()
    assert inject.plan_dispatch() == "bitflip"


# ---------------------------------------------------------------------------
# rollback
# ---------------------------------------------------------------------------

class _FakeState:
    def __init__(self, ckpt_dir=""):
        self._ckpt_dir = ckpt_dir
        self.step = 7
        self.waited = self.loaded = False
        self.resets = 0

    def checkpoint_wait(self):
        self.waited = True

    def load_latest(self):
        self.loaded = True
        self.step = 3
        return 3

    def on_reset(self):
        self.resets += 1
        self.step = 5


def _exc(suspect=1):
    return exceptions.CollectiveIntegrityError(
        "boom", bucket="fused[8]", suspect_rank=suspect)


def test_rollback_prefers_checkpoint_cut(monkeypatch, tmp_path):
    monkeypatch.setenv("HOROVOD_ROLLBACK_BUDGET", "2")
    st = _FakeState(ckpt_dir=str(tmp_path))
    assert rollback.handle_failure(st, _exc()) == 3
    assert st.waited and st.loaded and st.resets == 0
    assert rollback.replays() == 1


def test_rollback_memory_snapshot_fallback():
    st = _FakeState(ckpt_dir="")
    assert rollback.handle_failure(st, _exc()) == 5
    assert st.resets == 1 and not st.loaded


def test_rollback_budget_exhaustion_reraises(monkeypatch):
    monkeypatch.setenv("HOROVOD_ROLLBACK_BUDGET", "1")
    st = _FakeState()
    rollback.handle_failure(st, _exc())
    with pytest.raises(exceptions.CollectiveIntegrityError):
        rollback.handle_failure(st, _exc())
    assert rollback.replays() == 1


def test_quarantine_gating(monkeypatch):
    from horovod_tpu_torch.elastic import fault_inject

    monkeypatch.setattr(fault_inject, "_initial_rank", 1)
    assert not rollback.should_quarantine(_exc(suspect=1))
    monkeypatch.setenv("HOROVOD_INTEGRITY_QUARANTINE", "1")
    assert rollback.should_quarantine(_exc(suspect=1))
    assert not rollback.should_quarantine(_exc(suspect=0))
    assert not rollback.should_quarantine(_exc(suspect=None))


def test_memory_rollback_restores_bit_identical():
    from horovod_tpu_torch.elastic.state import ArrayState

    golden = torch.arange(4, dtype=torch.float32) * 0.1
    st = ArrayState(params={"w": golden.clone()}, optimizer=None, step=3)
    live = st.params["w"]
    st.params["w"].mul_(float("nan"))
    st.step = 9
    assert rollback.handle_failure(st, _exc()) == 3
    assert st.step == 3 and st.params["w"] is live
    assert torch.equal(st.params["w"], golden)


# ---------------------------------------------------------------------------
# the executor's digests (one rank)
# ---------------------------------------------------------------------------

@pytest.fixture
def integrity_on(monkeypatch):
    monkeypatch.setenv("HOROVOD_INTEGRITY", "1")
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "1")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_fused_digest_passes_clean_payloads(world1, integrity_on, dtype):
    x = (torch.arange(12) - 5).to(dtype)
    handles = [hvd.allreduce_async(x.clone(), name=f"clean.{i}",
                                   op=hvd.Sum) for i in range(3)]
    outs = [hvd.synchronize(h) for h in handles]
    for out in outs:
        assert torch.equal(out, x)
    from horovod_tpu_torch.core import state as state_mod

    ex = state_mod.global_state().runtime.executor
    assert ex.digest_checks >= 1 and ex.integrity_failure is None


def test_fused_nan_injection_is_convicted(world1, integrity_on,
                                          monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_INJECT", "nan:0:after=1")
    x = torch.ones(8)
    assert torch.equal(hvd.allreduce(x, name="nan.0", op=hvd.Sum), x)
    with pytest.raises(exceptions.NumericalError) as ei:
        hvd.allreduce(x, name="nan.1", op=hvd.Sum)
    assert ei.value.suspect_rank == 0
    assert not isinstance(ei.value, exceptions.CollectiveIntegrityError)
    # the runtime survives the verdict
    assert torch.equal(hvd.allreduce(x, name="nan.2", op=hvd.Sum), x)


def test_reducescatter_digest_convicts_a_poisoned_gradient(
        world1, integrity_on, monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_INJECT", "nan:0")
    g = torch.arange(6, dtype=torch.float32)
    with pytest.raises(exceptions.NumericalError, match="rs\\[1\\]"):
        hvd.reducescatter(g, op=hvd.Sum, name="zero.g0")
    assert torch.equal(g, torch.arange(6, dtype=torch.float32))


def test_a_bitflip_waits_for_an_allreduce(world1, monkeypatch):
    """A reduce-scatter has no replicated result to flip: it leaves a
    ``bitflip`` clause armed, and the next allreduce's result carries the
    flipped bit (one rank: no vote can see it)."""
    monkeypatch.setenv("HOROVOD_FAULT_INJECT", "bitflip:0")
    g = torch.arange(6, dtype=torch.float32)
    assert torch.equal(hvd.reducescatter(g, op=hvd.Sum, name="rs.flip"), g)
    x = torch.full((4,), 3.0)
    out = hvd.allreduce(x, op=hvd.Sum, name="ar.flip")
    flipped = (out.view(torch.int32) ^ x.view(torch.int32)).tolist()
    assert flipped == [1, 0, 0, 0]


def test_digests_off_by_default(world1, monkeypatch):
    monkeypatch.delenv("HOROVOD_INTEGRITY", raising=False)
    monkeypatch.setenv("HOROVOD_FAULT_INJECT", "nan:0")
    out = hvd.allreduce(torch.ones(4), name="off", op=hvd.Sum)
    assert torch.isnan(out).any()  # undetected corruption corrupts


def _zero_run(tmp_path, monkeypatch, fault):
    """Six steps of ZeRO-1 sharded_adamw under @elastic.run, a commit a
    step to a checkpoint directory; returns the final state's bytes."""
    from horovod_tpu_torch.parallel import zero

    monkeypatch.setenv("HOROVOD_FAULT_INJECT", fault)
    inject.reset()
    hvd.init(device="cpu")
    try:
        params = {"a": torch.linspace(-1, 1, 15).reshape(5, 3),
                  "b": torch.linspace(0, 2, 7)}
        tx = hvd.sharded_adamw(1e-2)
        state = hvd.elastic.ArrayState(params, tx.init(params), step=0,
                                       ckpt_dir=str(tmp_path))

        @hvd.elastic.run
        def train(state):
            while state.step < 6:
                grads = {k: torch.sin(v * (state.step + 1))
                         for k, v in state.params.items()}
                _, state.optimizer = tx.apply(state.params, state.optimizer,
                                              grads)
                state.step += 1
                state.commit()

        train(state)
        state.checkpoint_wait()
        exp = zero.export_shard_arrays(state.optimizer)
        return ([t.numpy().tobytes() for c in ("master", "mu", "nu")
                 for t in exp[c]]
                + [v.numpy().tobytes() for v in state.params.values()],
                state.slab_allocations)
    finally:
        hvd.shutdown()


def test_zero_rollback_in_place_replays_onto_the_clean_bits(
        tmp_path, monkeypatch):
    """The chip phase's 12b on the CPU: a NaN in step 4's reduce-scatter
    input is convicted; the state goes back to step 3's checkpoint cut and
    the replayed steps end on the clean run's bits."""
    monkeypatch.setenv("HOROVOD_INTEGRITY", "1")
    monkeypatch.setenv("HOROVOD_INTEGRITY_INTERVAL", "1")
    clean, _ = _zero_run(tmp_path / "clean", monkeypatch, "")
    hurt, slabs = _zero_run(tmp_path / "nan", monkeypatch, "nan:0:after=3")
    assert rollback.replays() == 1
    assert hurt == clean
    assert slabs == 2  # the constructor's set and the first commit's


def test_metric_families_registered():
    names = set(hvd.metrics())
    for m in ("horovod_integrity_checks_total",
              "horovod_integrity_violations_total",
              "horovod_integrity_rollbacks_total",
              "horovod_integrity_skipped_steps_total"):
        assert m in names, m
