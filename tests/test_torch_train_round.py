"""The port's ``create_train_state`` and ``make_train_round``
(``horovod_tpu_torch/training.py``) against the JAX package's, mirroring
``tests/test_optimizer.py`` and ``tests/test_torch_train_step.py``.

* World 1: the tiny ResNet (stage sizes (1, 1, 1, 1), 8 filters, 10
  classes, batch 8 at 32 x 32) through the JAX ``create_train_state`` +
  ``make_train_round(steps=3)`` (jitted over the 8-device CPU mesh) and
  through the port's, with ``DistributedOptimizer(SGD(0.01, momentum
  0.9))`` against ``optax.sgd(0.01, momentum=0.9)``, the weights carried by
  ``resnet_from_flax``. Two rounds; ``tests/test_torch_resnet.py``'s step
  limits: each round's loss 1e-5 relative, the parameters 1e-3 of each
  leaf's norm, the running statistics 1e-5.
* A 2-rank gloo world (``tests/torch_train_round_worker.py``):
  ``create_train_state`` replaces rank 1's other initial weights with rank
  0's, bit for bit; the MLP of ``test_torch_train_step.py`` through two
  rounds of three steps on half batches matches the JAX round on the whole
  batch within that file's limits (SGD 1e-5, AdamW 1e-4 of each leaf's
  norm); a round is one profiler record there.
* World 1: one round is one profiler record with ``DistributedOptimizer``
  inside (whose own boundary would make one a step), one
  ``make_train_step`` call one record, and a round inside an explicit
  ``hvd.profiler.step()`` adds none of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu import training as jtraining
from horovod_tpu.models import resnet as jres
from horovod_tpu_torch import profiler as tprof
from horovod_tpu_torch import training as ttraining
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.models.convert import (batch_stats_to_flax,
                                              resnet_from_flax,
                                              resnet_grads_to_flax)
from horovod_tpu_torch.utils import env

import test_torch_train_step as step_test
import torch_train_round_worker as worker

LR, MOMENTUM, BATCH, CLASSES = 0.01, 0.9, 8, 10


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _worst(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    return max((step_test._rel(got[k], want[k]), k) for k in want)


@pytest.fixture(autouse=True)
def _profiler_off(monkeypatch):
    monkeypatch.delenv(env.HOROVOD_PROFILE, raising=False)
    monkeypatch.setattr(tprof, "_profiler", tprof.StepProfiler())


@pytest.fixture
def world1():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_tiny_resnet_round_matches_the_jax_round(world1, monkeypatch):
    # the JAX create_train_state runs flax's init op by op on the CPU
    # backend (23 s here); a jitted init gives the variables in a fraction
    monkeypatch.setattr(jtraining, "init_on_host", lambda model, rng, shape,
                        dtype=jnp.float32: jax.jit(lambda x: model.init(
                            rng, x, train=False))(np.zeros(shape, dtype)))
    jm = jres.ResNet(stage_sizes=[1, 1, 1, 1],
                     block_cls=jres.BottleneckBlock, num_filters=8,
                     num_classes=CLASSES, dtype=jnp.float32)
    rng = np.random.RandomState(21)
    images = rng.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32)
    labels = rng.randint(0, CLASSES, (BATCH,)).astype(np.int32)
    tx = optax.sgd(LR, momentum=MOMENTUM)
    jhvd.shutdown()
    jhvd.init(mesh_shape=(1, 8))
    try:
        state = jtraining.create_train_state(jm, tx, (1, 32, 32, 3))
        variables = _np_tree({"params": state.params,
                              "batch_stats": state.batch_stats})
        round_fn, sharding = jtraining.make_train_round(jm, tx, steps=3,
                                                        donate=False)
        x, y = (jax.device_put(a, sharding) for a in (images, labels))
        p, st, opt = state.params, state.batch_stats, state.opt_state
        want = []
        for _ in range(2):
            loss, p, st, opt = round_fn(p, st, opt, x, y)
            want.append((float(loss), _np_tree(p), _np_tree(st)))
    finally:
        jhvd.shutdown()

    tm = tres.ResNet(stage_sizes=(1, 1, 1, 1),
                     block_cls=tres.BottleneckBlock, num_filters=8,
                     num_classes=CLASSES, dtype=torch.float32, device="cpu")
    tm.load_state_dict(resnet_from_flax(variables))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(tm.parameters(), lr=LR, momentum=MOMENTUM),
        named_parameters=tm.named_parameters())
    ts = ttraining.create_train_state(tm, opt)
    assert set(ts.params) == {k for k, _ in tm.named_parameters()}
    assert set(ts.batch_stats) == {k for k, _ in tm.named_buffers()}
    assert ts.opt_state == opt.state_dict() and ts.step == 0
    round_fn = ttraining.make_train_round(tm, opt, steps=3)
    xt, yt = torch.from_numpy(images), torch.from_numpy(labels)
    for i, (loss, params, stats) in enumerate(want):
        got = round_fn(xt, yt).item()
        assert abs(got - loss) <= 1e-5 * loss, (i, got, loss)
        err, leaf = _worst(resnet_grads_to_flax(
            dict(tm.named_parameters()), variables), params)
        assert err <= 1e-3, (i, leaf, err)
        err, leaf = _worst(batch_stats_to_flax(tm), stats)
        assert err <= 1e-5, (i, leaf, err)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The ranks' outputs and the JAX round's parameters after each
    round, per optax transformation."""
    tmp = tmp_path_factory.mktemp("train_round")
    params, x, y = step_test._inputs()
    np.savez(tmp / "inputs.npz", x=x, y=y,
             **{f"w.{k}": v for k, v in step_test._to_port(params).items()})
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, 2, str(tmp)))
             for r in range(2)]
    for p in procs:  # the world runs while JAX computes its side
        p.start()
    jhvd.shutdown()
    jhvd.init(mesh_shape=(1, 8))
    want = {}
    try:
        for name, tx in (("fused_adamw", optax.adamw(
                              step_test.worker.LR,
                              weight_decay=step_test.worker.WD)),
                         ("distributed_sgd",
                          optax.sgd(step_test.worker.LR))):
            round_fn, sharding = jtraining.make_train_round(
                step_test._JaxMLP(), tx, steps=worker.STEPS, donate=False)
            images = jax.device_put(x.reshape(8, 6), sharding)
            labels = jax.device_put(y.reshape(8).astype(np.int32), sharding)
            p, opt = params, tx.init(params)
            want[name] = []
            for _ in range(worker.ROUNDS):
                _, p, _, opt = round_fn(p, {}, opt, images, labels)
                want[name].append(step_test._to_port(_np_tree(p)))
    finally:
        jhvd.shutdown()
    for p in procs:
        p.join(timeout=240)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return ranks, want, step_test._to_port(params)


@pytest.mark.parametrize("name", worker.OPTIMIZERS)
def test_create_train_state_makes_rank_one_rank_zeros(world2, name):
    ranks, _, init = world2
    for k, w in init.items():
        for out in ranks:
            assert np.array_equal(out[f"{name}.init.{k}"], w), k
    step_level = name == "fused_adamw"
    assert str(ranks[0][f"{name}.opt_state_type"]) == (
        "ScaleByAdamState" if step_level else "dict")


@pytest.mark.parametrize("name", worker.OPTIMIZERS)
def test_two_rank_rounds_match_the_jax_round(world2, name):
    ranks, want, _ = world2
    tol = step_test.TOL[name]
    for i, leaves in enumerate(want[name]):
        for k, w in leaves.items():
            assert np.array_equal(ranks[0][f"{name}.round{i}.{k}"],
                                  ranks[1][f"{name}.round{i}.{k}"])
            err = step_test._rel(ranks[0][f"{name}.round{i}.{k}"], w)
            assert err <= tol, (i, k, err)
    for out in ranks:
        assert np.isfinite(out[f"{name}.losses"]).all()


@pytest.mark.parametrize("name", worker.OPTIMIZERS)
def test_a_two_rank_round_is_one_profiler_record(world2, name):
    """One record a round whatever the optimizer; the round's collectives
    (the optimizer's hooks, or the step's own average) land in it."""
    ranks, _, _ = world2
    for out in ranks:
        assert int(out[f"{name}.records"]) == worker.ROUNDS
        assert out[f"{name}.auto"].all()
        assert (out[f"{name}.dispatches"] > 0).all()
        hooked = name == "distributed_sgd"
        assert (out[f"{name}.optimizer_s"] > 0).all() == hooked


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 3))


def test_one_round_is_one_record_at_world_one(monkeypatch):
    monkeypatch.setenv(env.HOROVOD_PROFILE, "1")
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        model = _mlp()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        x, y = torch.ones(5, 4), torch.zeros(5, dtype=torch.long)
        round_fn = ttraining.make_train_round(model, opt, steps=4)
        assert round_fn.__wrapped__ is not None
        for _ in range(3):
            round_fn(x, y)
        tprof.profiler().dump()
        recs = hvd.profiler.history()
        assert len(recs) == 3 and all(r["auto"] for r in recs)
        assert all(r["phases"]["optimizer"] > 0 for r in recs)
        # each round carries its four steps' collectives
        assert [r["comm"]["dispatches"] >= 4 for r in recs] == [True] * 3
        step = ttraining.make_train_step(model, opt)
        for _ in range(2):
            step(x, y)
        tprof.profiler().dump()
        assert len(hvd.profiler.history()) == 5
        with hvd.profiler.step("explicit"):
            round_fn(x, y)
        recs = hvd.profiler.history()
        assert len(recs) == 6 and recs[-1]["name"] == "explicit"
        # the optimizer alone: its own boundary, one record a step
        for _ in range(2):
            opt.zero_grad()
            torch.nn.functional.cross_entropy(model(x), y).backward()
            opt.step()
        tprof.profiler().dump()
        assert len(hvd.profiler.history()) == 8
    finally:
        hvd.shutdown()


def test_round_takes_at_least_one_step():
    with pytest.raises(ValueError, match="at least one step"):
        ttraining.make_train_round(_mlp(), torch.optim.SGD(
            _mlp().parameters(), lr=0.1), steps=0)
