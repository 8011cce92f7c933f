"""The port's pipeline parallelism (``horovod_tpu_torch/parallel/pp.py``)
against the sequential stack, mirroring ``tests/test_pp.py:40-126``, in a
3-rank gloo world, one stage a rank (``tests/torch_model_parallel_worker.py``,
mode ``pp``). The stage is the JAX test's ``tanh(x @ w + b)`` (width 8, 6
microbatches of 2), its parameters drawn from one ``RandomState``; the
sequential stack is the JAX package's composition of the same stages.

* Forward: ``last_stage_value`` of ``pipeline_apply``'s outputs on every
  rank within 1e-6 of the stack's (the JAX test's limit; float32, the same
  products).
* Gradients of ``mean((out - target)**2)`` through ``last_stage_value``:
  each rank's stage within 1e-5 of the stack's ``jax.grad`` for that stage
  (the JAX test's limit), the loss within 1e-6.
* Convergence: 150 Adam(3e-3) steps end below 0.3 of the first loss, the
  JAX test's criterion, on every rank.
"""

import numpy as np
import pytest

import torch_model_parallel_worker as worker

N_STAGES = 3


@pytest.fixture(scope="module")
def pp_world(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    tmp = tmp_path_factory.mktemp("pp")
    rng = np.random.RandomState(0)
    dim, micro, mb = worker.PP_DIM, worker.PP_MICRO, worker.PP_MB
    stages = [{"w": (rng.randn(dim, dim) * 0.5).astype(np.float32),
               "b": (rng.randn(dim) * 0.1).astype(np.float32)}
              for _ in range(N_STAGES)]
    x = rng.randn(micro, mb, dim).astype(np.float32)
    target = rng.randn(micro, mb, dim).astype(np.float32)
    goal = np.tanh(rng.randn(micro, mb, dim)).astype(np.float32)
    inp = dict(x=x, target=target, goal=goal)
    for i, p in enumerate(stages):
        inp.update({f"w{i}": p["w"], f"b{i}": p["b"]})
    np.savez(tmp / "inputs.npz", **inp)
    procs = worker.start(tmp, N_STAGES, "pp")

    def sequential(per_stage, x):
        for p in per_stage:
            x = jnp.tanh(x @ p["w"] + p["b"])
        return x

    def loss(per_stage):
        out = sequential(per_stage, x.reshape(-1, dim)).reshape(x.shape)
        return jnp.mean((out - target) ** 2)

    out = np.asarray(sequential(stages, x.reshape(-1, dim))).reshape(x.shape)
    want = dict(out=out, loss=np.asarray(loss(stages)),
                grads=jax.tree_util.tree_map(np.asarray,
                                             jax.grad(loss)(stages)))
    return worker.join(procs, tmp), want


def test_forward_matches_sequential(pp_world):
    got, want = pp_world
    for r, out in enumerate(got):
        np.testing.assert_allclose(out["pp.out"], want["out"], rtol=0,
                                   atol=1e-6, err_msg=f"rank {r}")


def test_gradients_match_sequential(pp_world):
    got, want = pp_world
    for r, out in enumerate(got):
        np.testing.assert_allclose(out["pp.loss"], want["loss"], rtol=0,
                                   atol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(out[f"pp.g{k}"], want["grads"][r][k],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"stage {r} d{k}")


def test_pipeline_training_converges(pp_world):
    got, _ = pp_world
    for out in got:
        losses = out["pp.losses"]
        assert len(losses) == worker.PP_STEPS
        assert losses[-1] < 0.3 * losses[0], (losses[0], losses[-1])
        np.testing.assert_array_equal(losses, got[0]["pp.losses"])
