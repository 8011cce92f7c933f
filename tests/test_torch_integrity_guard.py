"""The port's integrity step guard (``horovod_tpu_torch/integrity/``)
against the JAX package's, mirroring ``tests/test_integrity.py``'s guard
cases.

* The same value streams (seeded numpy: drifting losses, spikes, drops,
  NaN and inf) through both ``StepGuard`` classes give the same accept,
  skip and raise sequence and the same EWMA state after every value.
* ``guard_gradients`` observes the norm the JAX function observes (1e-12
  relative: float64 sums in other orders), flags a bad tensor in a dict or
  a list, skips integer tensors and reads a sparse one's values.
* A 2-rank gloo world (``tests/torch_integrity_worker.py``) with a NaN in
  one rank's gradient: both ranks skip the same steps, their parameters
  and SGD momentum bit-equal before and after each skipped step, the
  skipped-steps counter moves once a step; after the budget both raise
  ``NumericalError`` on the same step.
* ``make_train_step``'s loss guard and ``DistributedOptimizer``'s gradient
  guard at world 1, and neither wrapper nor hook when the knob is off.
"""

import math

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import exceptions as jexc
from horovod_tpu.integrity import guards as jguards
from horovod_tpu_torch import exceptions as texc
from horovod_tpu_torch.integrity import guards as tguards
from horovod_tpu_torch.training import make_train_round, make_train_step

import torch_integrity_worker as worker


def _stream(seed: int, n: int = 60) -> list:
    rng = np.random.RandomState(seed)
    vals = list(2.0 + np.cumsum(rng.normal(scale=0.05, size=n)))
    for i in rng.choice(np.arange(6, n), size=6, replace=False):
        vals[i] = float(rng.choice([vals[i] * 50.0, float("nan"),
                                    float("inf"), vals[i] * 1e-3]))
    return [float(v) for v in vals]


def _run(guard, stream):
    """The guard's answer to each value (True, False or 'raise') and its
    state after each."""
    out = []
    for v in stream:
        try:
            verdict = guard.observe(v)
        except (jexc.NumericalError, texc.NumericalError) as exc:
            verdict = ("raise", exc.tensor)
        out.append((verdict, guard.mean, guard.var, guard.n,
                    guard.consecutive_skips))
    return out


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(sigma=3.0, skip_budget=1, warmup=3)),
    (2, dict(sigma=2.0, skip_budget=10, warmup=5, decay=0.5)),
    (3, dict(skip_budget=0, name="grad_norm"))])
def test_guards_decide_alike_on_the_same_stream(seed, kw):
    stream = _stream(seed)
    want = _run(jguards.StepGuard(**kw), stream)
    got = _run(tguards.StepGuard(**kw), stream)
    assert got == want
    # the streams do reach the skip (or, at budget 0, the raise) path
    assert any(v[0] is not True for v in got)


def test_knobs_set_sigma_and_budget(monkeypatch):
    monkeypatch.setenv("HOROVOD_INTEGRITY_SPIKE_SIGMA", "2.5")
    monkeypatch.setenv("HOROVOD_INTEGRITY_SKIP_STEPS", "7")
    g, j = tguards.StepGuard(), jguards.StepGuard()
    assert (g.sigma, g.skip_budget) == (j.sigma, j.skip_budget) == (2.5, 7)
    monkeypatch.delenv("HOROVOD_INTEGRITY_SPIKE_SIGMA")
    monkeypatch.delenv("HOROVOD_INTEGRITY_SKIP_STEPS")
    g = tguards.StepGuard()
    assert (g.sigma, g.skip_budget) == (tguards.DEFAULT_SPIKE_SIGMA,
                                        tguards.DEFAULT_SKIP_STEPS) == (6.0, 3)


def test_skip_budget_exhaustion_raises_and_counts():
    g = tguards.StepGuard(skip_budget=2, name="loss")
    before = tguards._SKIPPED.value
    assert not g.observe(float("nan"))
    assert not g.observe(float("inf"))
    with pytest.raises(texc.NumericalError) as ei:
        g.observe(float("nan"))
    assert ei.value.tensor == "loss" and ei.value.suspect_rank is None
    assert tguards._SKIPPED.value == before + 3
    assert isinstance(ei.value, texc.HorovodInternalError)


def test_guard_gradients_observes_the_jax_norm_and_flags_bad_tensors():
    rng = np.random.RandomState(4)
    arrays = {"a": rng.normal(size=(7, 5)).astype(np.float32),
              "b": rng.normal(size=(33,)).astype(np.float32),
              "c": np.arange(4, dtype=np.int32)}
    tguards.reset()
    jguards.reset()
    assert tguards.guard_gradients({k: torch.from_numpy(v)
                                    for k, v in arrays.items()})
    assert jguards.guard_gradients(arrays)
    want = jguards.default_guard().mean
    assert tguards.default_guard().mean == pytest.approx(want, rel=1e-12)
    # a list, bf16, and a sparse gradient (its values) give the same norm
    sparse = torch.sparse_coo_tensor(torch.tensor([[0, 2]]),
                                     torch.tensor([3.0, 4.0]), (5,))
    assert tguards.global_norm([sparse]) == 5.0
    assert tguards.global_norm([torch.tensor([3.0, 4.0],
                                             dtype=torch.bfloat16)]) == 5.0
    assert tguards.global_norm([]) == 0.0
    for bad in (float("nan"), float("inf")):
        tguards.reset()
        grads = [torch.ones(3), torch.tensor([1.0, bad])]
        assert not tguards.guard_gradients(grads)
        assert not math.isfinite(tguards.global_norm(grads))
    tguards.reset()
    jguards.reset()


def test_two_ranks_skip_the_same_nan_steps_then_raise(tmp_path):
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, 2, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for out in ranks:
        # the budget's skips, then the raise, on both ranks
        assert int(out["raised_at"]) == worker.BUDGET
        assert str(out["raised_tensor"]) == "grad_norm"
        for i in range(worker.BUDGET):
            assert int(out[f"moved{i}"]) == 1
            assert bool(out[f"params_equal{i}"])
            assert bool(out[f"momentum_equal{i}"])
    assert np.array_equal(ranks[0]["param"], ranks[1]["param"])


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("HOROVOD_INTEGRITY", "1")
    monkeypatch.setenv("HOROVOD_INTEGRITY_SKIP_STEPS", "1")
    hvd.shutdown()
    hvd.init(device="cpu")
    tguards.reset()
    yield
    tguards.reset()
    hvd.shutdown()


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 3))


@pytest.mark.parametrize("build", [make_train_step, make_train_round])
def test_loss_guard_watches_the_returned_loss(armed, build):
    """A NaN loss (from a NaN input) is flagged by the step's own loss
    guard, the gradient guard skips its update, and the second
    consecutive one raises; a clean step returns the loss."""
    model = _mlp()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = build(model, hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters()))
    guard = step.__integrity_guard__
    x, y = torch.ones(5, 4), torch.zeros(5, dtype=torch.long)
    loss = step(x, y)
    assert torch.isfinite(loss) and guard.n == 1
    before = [p.detach().clone() for p in model.parameters()]
    bad = torch.full((5, 4), float("nan"))
    assert torch.isnan(step(bad, y))
    assert guard.consecutive_skips == 1
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 model.parameters()))
    with pytest.raises(texc.NumericalError):
        step(bad, y)


def test_distributed_optimizer_skip_leaves_state_and_step_count(armed):
    """A skipped step leaves the parameters, AdamW's moments and its step
    count as they were."""
    model = _mlp()
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    x, y = torch.ones(5, 4), torch.zeros(5, dtype=torch.long)
    torch.nn.functional.cross_entropy(model(x), y).backward()
    opt.step()
    opt.zero_grad()
    state = {k: v.clone() for p in model.parameters()
             for k, v in opt.state[p].items()}
    before = [p.detach().clone() for p in model.parameters()]
    torch.nn.functional.cross_entropy(model(x), y).backward()
    model[0].weight.grad[0, 0] = float("inf")
    skipped = tguards._SKIPPED.value
    assert opt.step() is None
    assert tguards._SKIPPED.value == skipped + 1
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 model.parameters()))
    after = {k: v for p in model.parameters()
             for k, v in opt.state[p].items()}
    assert all(torch.equal(state[k], after[k]) for k in state)


def test_off_by_default_neither_wrapper_nor_hook(monkeypatch):
    monkeypatch.delenv("HOROVOD_INTEGRITY", raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        tguards.reset()
        model = _mlp()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        step = make_train_step(model, opt)
        assert not hasattr(step, "__integrity_guard__")
        x, y = torch.ones(5, 4), torch.zeros(5, dtype=torch.long)
        step(x, y)
        assert tguards._default_guard is None
    finally:
        hvd.shutdown()
