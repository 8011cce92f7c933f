"""The port's callbacks and warmup schedule (``horovod_tpu_torch/
callbacks.py``) against the JAX package's, mirroring
``tests/test_optimizer.py``'s ``TestCallbacks``.

* ``warmup_scaled_schedule``, without and with an ``after`` multiplier and
  an ``initial_lr``, and both learning-rate callbacks equal the JAX ones
  within 1e-6 relative over steps (or epochs) 0-200: JAX computes the
  schedule in float32, the port in Python floats.
* The schedule drives ``torch.optim.lr_scheduler.LambdaLR`` as its
  docstring shows.
* In a 2-rank gloo world (``tests/torch_callbacks_worker.py``): the
  broadcast callback makes a module's parameters and buffers, and a dict's
  tensors, the root rank's, bit for bit; the metric callback and
  ``average_metrics`` give both ranks the mean; the warmup callback scales
  by the world's size. And at world 1, each as the JAX package's.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import callbacks as jcb
from horovod_tpu_torch import callbacks as tcb

import torch_callbacks_worker as worker

STEPS = range(201)
AFTERS = {"none": None, "staircase": lambda e: 0.1 ** (e // 30),
          "smooth": lambda e: 1.0 / (1.0 + 0.05 * e)}


def _close(got, want, rel=1e-6):
    assert abs(got - want) <= rel * abs(want), (got, want)


@pytest.mark.parametrize("after", list(AFTERS))
@pytest.mark.parametrize("kw", [
    dict(base_lr=0.1, warmup_epochs=2, steps_per_epoch=10, size=8),
    dict(base_lr=0.0125, warmup_epochs=0.5, steps_per_epoch=7, size=3,
         initial_lr=0.001)])
def test_warmup_schedule_equals_the_jax_schedule(kw, after):
    ours = tcb.warmup_scaled_schedule(after=AFTERS[after], **kw)
    theirs = jcb.warmup_scaled_schedule(after=AFTERS[after], **kw)
    for step in STEPS:
        got = ours(step)
        assert isinstance(got, float)
        _close(got, float(theirs(step)))


def test_warmup_schedule_reference_values():
    sched = tcb.warmup_scaled_schedule(base_lr=0.1, warmup_epochs=2,
                                       steps_per_epoch=10, size=8)
    assert [sched(s) for s in (0, 10, 20, 100)] == pytest.approx(
        [0.1, 0.45, 0.8, 0.8], rel=1e-12)
    after = tcb.warmup_scaled_schedule(
        base_lr=0.1, warmup_epochs=1, steps_per_epoch=10, size=8,
        after=lambda e: 0.1 ** (e // 30))
    assert after(10) == pytest.approx(0.8) and \
        after(10 + 300) == pytest.approx(0.08)


def test_lambda_lr_follows_the_schedule():
    base = 0.1
    sched = tcb.warmup_scaled_schedule(base, warmup_epochs=1,
                                       steps_per_epoch=4, size=4)
    w = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.SGD([w], lr=base)
    lr_sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: sched(step) / base)
    for step in range(8):
        assert opt.param_groups[0]["lr"] == pytest.approx(sched(step))
        opt.step()
        lr_sched.step()


def test_warmup_callback_equals_the_jax_callback():
    ours = tcb.LearningRateWarmupCallback(0.05, warmup_epochs=3,
                                          steps_per_epoch=20, size=4)
    theirs = jcb.LearningRateWarmupCallback(0.05, warmup_epochs=3,
                                            steps_per_epoch=20, size=4)
    _close(ours.lr, theirs.lr)
    for b in STEPS:
        assert ours.on_batch_begin(b, "s") == "s"
        theirs.on_batch_begin(b, "s")
        _close(ours.lr, theirs.lr)


@pytest.mark.parametrize("staircase", [True, False])
def test_schedule_callback_equals_the_jax_callback(staircase):
    kw = dict(base_lr=1.0, multiplier=lambda e: 0.1 ** (e // 2),
              start_epoch=3, end_epoch=150, staircase=staircase)
    ours, theirs = tcb.LearningRateScheduleCallback(**kw), \
        jcb.LearningRateScheduleCallback(**kw)
    for epoch in np.arange(0, 200, 0.5):
        ours.on_epoch_begin(epoch, None)
        theirs.on_epoch_begin(epoch, None)
        _close(ours.lr, theirs.lr)
    cb = tcb.LearningRateScheduleCallback(
        base_lr=1.0, multiplier=lambda e: 0.1 ** (e // 2))
    cb.on_epoch_begin(0, None)
    assert cb.lr == pytest.approx(1.0)
    cb.on_epoch_begin(2, None)
    assert cb.lr == pytest.approx(0.1)


@pytest.fixture
def world1():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_callbacks_at_world_one(world1):
    m = tcb.average_metrics({"loss": 2.0, "t": torch.tensor([1.0, 3.0])})
    assert float(m["loss"]) == 2.0 and m["t"].tolist() == [1.0, 3.0]
    state = {"w": torch.ones(2)}
    assert tcb.BroadcastGlobalVariablesCallback().on_train_begin(state) \
        is state
    assert state["w"].tolist() == [1.0, 1.0]
    assert tcb.MetricAverageCallback().on_epoch_end(0, "s", None) == \
        ("s", None)
    base = tcb.Callback()
    assert base.on_train_begin(1) == 1 and base.on_epoch_begin(0, 1) == 1
    assert base.on_epoch_end(0, 1, {"a": 1}) == (1, {"a": 1})
    warm = tcb.LearningRateWarmupCallback(0.1, warmup_epochs=1,
                                          steps_per_epoch=2)
    assert warm.lr == 0.1  # size 1: no scaling


def test_callbacks_in_a_two_rank_world(tmp_path):
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
    torch.manual_seed(1)  # the root rank's module
    root = torch.nn.Sequential(torch.nn.Linear(3, 4),
                               torch.nn.BatchNorm1d(4))
    for out in ranks:
        for k, v in root.state_dict().items():
            np.testing.assert_array_equal(out[f"model.{k}"], v.numpy())
        np.testing.assert_array_equal(out["dict.w"], [2.0, 2.0])
        np.testing.assert_allclose(out["avg.loss"], 1.5)
        np.testing.assert_allclose(out["avg.acc"], 0.25)
        np.testing.assert_allclose(out["fn.n"], [0.5, 3.0])
        want = jcb.warmup_scaled_schedule(0.1, 1, 2, size=2)
        np.testing.assert_allclose(out["lrs"],
                                   [float(want(s)) for s in range(4)],
                                   rtol=1e-6)
