"""The port's eager ``make_train_step`` takes the global batch's gradient,
whatever the optimizer, as the JAX package's step does
(``horovod_tpu/training.py`` ``make_train_step``: the gradient averaging
falls out of the shardings).

A 2-rank gloo world (``tests/torch_train_step_worker.py``), each rank on
its half of one batch of 8, two steps of a small MLP without batch norm
(whose statistics are per rank) with each of: ``fused_adamw`` and
``torch.optim.SGD``, which exchange nothing themselves, so the step
averages their gradients; ``DistributedOptimizer(SGD)``,
``sharded_adamw`` and ``DistributedOptimizer(SGD,
shard_optimizer_states=True)``, which exchange their own.

* The ranks' parameters are bit-equal after each step.
* They match the JAX package's ``make_train_step`` (jitted over the
  8-device CPU mesh) on the concatenated batch, with ``optax.adamw`` and
  ``optax.sgd``. Limits, relative to each leaf's norm: 1e-5 for SGD (the
  same float32 gradient summed in other orders: the two halves' means
  averaged against XLA's mean over 8 rows; measured 3.6e-8); 1e-4 for
  AdamW, whose first steps divide each gradient element by its own
  magnitude, so an element whose gradient is near zero moves by up to lr
  on a difference of rounding, and optax rounds its update in another
  order than ``fused_adamw`` (measured 2.3e-6).
* The step adds no collective where the optimizer exchanges: one
  allreduce a gradient a step under ``DistributedOptimizer``, none beside
  the ZeRO optimizers; its own allreduces come from the response cache
  from the second step.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu import training as jtraining
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.training import make_train_step

import torch_train_step_worker as worker

N_LEAVES = 6
TOL = {"fused_adamw": 1e-4, "sgd": 1e-5, "distributed_sgd": 1e-5}


class _JaxMLP(nn.Module):
    """The worker's MLP in flax: ``Dense_i`` is the port's layer ``2i``."""

    @nn.compact
    def __call__(self, x, train: bool = True):
        x = jnp.tanh(nn.Dense(16)(x))
        x = jnp.tanh(nn.Dense(16)(x))
        return nn.Dense(3)(x)


def _inputs():
    rng = np.random.RandomState(3)
    params = {}
    for i, (n_in, n_out) in enumerate(((6, 16), (16, 16), (16, 3))):
        kernel = 0.5 * rng.normal(size=(n_in, n_out))
        bias = 0.1 * rng.normal(size=(n_out,))
        params[f"Dense_{i}"] = {"kernel": kernel.astype(np.float32),
                                "bias": bias.astype(np.float32)}
    x = rng.normal(size=(2, 4, 6)).astype(np.float32)
    y = rng.randint(0, 3, (2, 4)).astype(np.int64)
    return params, x, y


def _to_port(params) -> dict:
    """Flax's ``{Dense_i: {kernel, bias}}`` as the port's state dict."""
    out = {}
    for i in range(3):
        d = params[f"Dense_{i}"]
        out[f"{2 * i}.weight"] = np.ascontiguousarray(
            np.asarray(d["kernel"]).T)
        out[f"{2 * i}.bias"] = np.asarray(d["bias"])
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' outputs and the JAX step's parameters after each step,
    per optax transformation."""
    tmp = tmp_path_factory.mktemp("train_step")
    params, x, y = _inputs()
    np.savez(tmp / "inputs.npz", x=x, y=y,
             **{f"w.{k}": v for k, v in _to_port(params).items()})
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, 2, str(tmp)))
             for r in range(2)]
    for p in procs:  # the world runs while JAX computes its side
        p.start()

    import horovod_tpu as jhvd

    jhvd.shutdown()
    jhvd.init(mesh_shape=(1, 8))
    want = {}
    try:
        for name, tx in (("adamw", optax.adamw(worker.LR,
                                               weight_decay=worker.WD)),
                         ("sgd", optax.sgd(worker.LR))):
            step, sharding = jtraining.make_train_step(_JaxMLP(), tx,
                                                       donate=False)
            images = jax.device_put(x.reshape(8, 6), sharding)
            labels = jax.device_put(y.reshape(8).astype(np.int32), sharding)
            p, opt = params, tx.init(params)
            want[name] = []
            for _ in range(worker.STEPS):
                _, p, _, opt = step(p, {}, opt, images, labels)
                want[name].append(_to_port(jax.tree_util.tree_map(
                    np.asarray, p)))
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
    return ranks, want


@pytest.mark.parametrize("name", worker.OPTIMIZERS)
def test_ranks_hold_bit_equal_parameters(world, name):
    ranks, _ = world
    keys = [k for k in ranks[0] if k.startswith(f"{name}.step")]
    assert len(keys) == worker.STEPS * N_LEAVES
    for k in keys:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k


@pytest.mark.parametrize("name,jax_tx", [("fused_adamw", "adamw"),
                                         ("sgd", "sgd"),
                                         ("distributed_sgd", "sgd")])
def test_steps_match_the_jax_step_on_the_whole_batch(world, name, jax_tx):
    ranks, want = world
    for i, leaves in enumerate(want[jax_tx]):
        for k, w in leaves.items():
            for out in ranks:
                err = _rel(out[f"{name}.step{i}.{k}"], w)
                assert err <= TOL[name], (i, k, err)


def test_no_exchanging_optimizer_gets_a_second_exchange(world):
    """Collectives requested a step (allreduce, reduce-scatter,
    allgather): the step's own allreduce for the optimizers that exchange
    nothing, the optimizer's alone for the rest."""
    ranks, _ = world
    want = {"fused_adamw": [N_LEAVES, 0, 0], "sgd": [N_LEAVES, 0, 0],
            "distributed_sgd": [N_LEAVES, 0, 0],
            "sharded_adamw": [0, 1, 1], "sharded_update": [0, 1, 1]}
    for out in ranks:
        for name, counts in want.items():
            np.testing.assert_array_equal(out[f"{name}.counts"],
                                          [counts] * worker.STEPS, name)


@pytest.mark.parametrize("name", ["fused_adamw", "sgd"])
def test_step_allreduces_come_from_the_cache(world, name):
    """The step's names are the same every step (no step number)."""
    ranks, _ = world
    for out in ranks:
        assert list(out[f"{name}.hits"][1:]) == [N_LEAVES] * (
            worker.STEPS - 1)


@pytest.fixture
def world1():
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


@pytest.mark.parametrize("initialized", [False, True])
def test_one_rank_steps_issue_no_collective(request, initialized):
    """At world 1 (and before ``init()``) the step exchanges nothing, so
    its parameters are those of the optimizer alone on the same
    gradients."""
    if initialized:
        request.getfixturevalue("world1")
    params, x, y = _inputs()
    models = [worker.model_from(_to_port(params)) for _ in range(2)]
    sgd = torch.optim.SGD(models[0].parameters(), lr=worker.LR)
    step = make_train_step(models[0], sgd)
    collectives.reset_counts()
    xt, yt = torch.from_numpy(x[0]), torch.from_numpy(y[0])
    step(xt, yt)
    assert collectives.COUNTS["allreduce"] == 0
    ref = torch.optim.SGD(models[1].parameters(), lr=worker.LR)
    torch.nn.functional.cross_entropy(models[1](xt), yt).backward()
    ref.step()
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)
