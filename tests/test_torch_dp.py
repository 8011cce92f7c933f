"""The port's lifecycle, collectives and DistributedOptimizer against the
JAX package.

* The lifecycle probes of the JAX package (API before init raises, double
  shutdown is safe, ``average=`` with ``op=`` and a bad ``root_rank`` are
  rejected).
* A real 2-rank gloo world (``torch.multiprocessing``, spawn, a
  ``FileStore`` under the test's tmp dir): ``allreduce(average=True)`` of
  per-rank numpy gradients equals ``horovod_tpu``'s
  ``hvd.allreduce(hvd.stack_per_worker(...))`` on its CPU mesh, and one
  ``DistributedOptimizer(AdamW)`` step leaves both ranks with the same
  parameters, equal to ``optax.adamw(1e-4)`` applied to the mean gradient.
* Two tiny-BERT training steps at world 1: the JAX ``value_and_grad`` +
  ``optax.adamw`` step against the port's step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
import torch_dp_worker
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import grads_to_flax, params_from_flax


@pytest.fixture
def world1():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_api_before_init_raises():
    hvd.shutdown()
    for fn in (hvd.rank, hvd.size, hvd.local_rank, hvd.cross_size,
               hvd.device):
        with pytest.raises(RuntimeError, match="not been initialized"):
            fn()
    with pytest.raises(RuntimeError, match="not been initialized"):
        hvd.allreduce(torch.ones(2))


def test_double_shutdown_is_safe(world1):
    assert hvd.is_initialized() and hvd.size() == 1
    hvd.shutdown()
    hvd.shutdown()
    assert not hvd.is_initialized()


def test_average_with_op_rejected(world1):
    with pytest.raises(ValueError, match="either average or op"):
        hvd.allreduce(torch.ones(2), average=True, op=hvd.Sum)


def test_bad_root_rank_rejected(world1):
    for root in (-1, 1):
        with pytest.raises(ValueError, match="root_rank"):
            hvd.broadcast(torch.ones(2), root)
        with pytest.raises(ValueError, match="root_rank"):
            hvd.broadcast_parameters({"w": torch.ones(2)}, root_rank=root)


def test_world1_issues_collectives(world1):
    """At size 1 the optimizer's hooks still issue one allreduce per
    parameter, as the JAX package runs them on a one-device mesh."""
    from horovod_tpu_torch.ops import collectives

    lin = torch.nn.Linear(4, 3)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                   named_parameters=lin.named_parameters())
    collectives.reset_counts()
    lin(torch.ones(2, 4)).sum().backward()
    with pytest.raises(AssertionError, match="zero_grad"):
        opt.zero_grad()
    opt.step()
    assert collectives.COUNTS == {"allreduce": 2, "broadcast": 0,
                                  "reducescatter": 0, "allgather": 0,
                                  "alltoall": 0}


def test_dropped_optimizer_frees_its_model(world1):
    """The per-parameter hooks live in C++, out of the garbage collector's
    sight: they must not keep the optimizer, the parameters, their
    gradients or the optimizer state alive once the caller drops them."""
    import gc
    import weakref

    lin = torch.nn.Linear(4, 3)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(lin.parameters()),
                                   named_parameters=lin.named_parameters())
    lin(torch.ones(2, 4)).sum().backward()
    opt.step()
    refs = [weakref.ref(x) for x in (opt, lin.weight, lin.weight.grad,
                                     opt.state[lin.weight]["exp_avg"])]
    del lin, opt
    gc.collect()
    assert [r() is None for r in refs] == [True] * 4


def test_backward_passes_per_step_and_skip_synchronize(world1):
    """Two backward passes accumulate locally before one allreduce per
    parameter; ``synchronize()`` then ``step()`` under
    ``skip_synchronize()`` reduces once, and probes report the transports."""
    from horovod_tpu_torch.ops import collectives

    assert hvd.gloo_built()
    lin = torch.nn.Linear(4, 3)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                   named_parameters=lin.named_parameters(),
                                   backward_passes_per_step=2)
    collectives.reset_counts()
    for _ in range(2):
        lin(torch.ones(2, 4)).sum().backward()
    assert collectives.COUNTS["allreduce"] == 2
    np.testing.assert_allclose(lin.bias.grad.numpy(), [4.0, 4.0, 4.0])
    opt.synchronize()
    with opt.skip_synchronize():
        opt.step()
    assert collectives.COUNTS["allreduce"] == 2
    with pytest.raises(ValueError, match="unique"):
        hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                 named_parameters=[("w", lin.weight),
                                                   ("w", lin.bias)])


def test_two_rank_gloo_world_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    grads = rng.normal(size=(2, 6, 5)).astype(np.float32)
    params = rng.normal(size=(6, 5)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", grads=grads, params=params)

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dp_worker.run,
                         args=(r, 2, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]

    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2], mesh_shape=(1, 2))
    try:
        mean = np.asarray(jhvd.allreduce(jhvd.stack_per_worker(
            [grads[0], grads[1]]), average=True))
    finally:
        jhvd.shutdown()

    # optax.adamw(1e-4) on rank 0's weights and the mean gradient
    opt = optax.adamw(1e-4)
    state = opt.init(jnp.asarray(params))
    upd, _ = opt.update(jnp.asarray(mean), state, jnp.asarray(params))
    want_w = np.asarray(optax.apply_updates(jnp.asarray(params), upd))

    for r, out in enumerate(got):
        np.testing.assert_array_equal(out["counts"], [2, r])
        np.testing.assert_allclose(out["mean"], mean, rtol=1e-6, atol=0)
        np.testing.assert_allclose(out["sum_fp16"], grads.sum(0),
                                   rtol=2e-2, atol=2e-2)  # fp16 wire
        np.testing.assert_array_equal(out["max"], grads.max(0))
        np.testing.assert_array_equal(out["g_untouched"], grads[r])
        np.testing.assert_array_equal(out["mean_inplace"], out["mean"])
        np.testing.assert_allclose(out["grouped"], 2 * mean, rtol=1e-6)
        np.testing.assert_array_equal(out["bcast"], [1.0, 1.0, 1.0])
        np.testing.assert_array_equal(out["w_init"], params)
        np.testing.assert_allclose(out["w_step"], want_w, rtol=0, atol=1e-6)
        assert float(out["step"]) == 1.0
    np.testing.assert_array_equal(got[0]["w_step"], got[1]["w_step"])
    np.testing.assert_array_equal(got[0]["exp_avg"], got[1]["exp_avg"])
    np.testing.assert_allclose(got[0]["exp_avg"], 0.1 * mean, rtol=1e-6)


def test_bert_two_steps_match_jax_adamw(world1):
    """Two training steps of a tiny BERT (float32): the JAX package's
    value_and_grad + optax.adamw(1e-4) against the port's forward,
    backward, allreduce hooks and AdamW(weight_decay=1e-4). Parameters
    after each step agree within 1e-6 abs: each step moves a weight by
    about lr = 1e-4 (AdamW normalises the gradient), and the gradients
    agree to ~1e-6 relative, so the moves agree to ~1e-10; the bound is
    float32 rounding of the weights themselves (|w| < 1). The key bias,
    whose true gradient is 0, is the exception stated below."""
    kw = dict(vocab_size=64, d_model=64, num_layers=2, num_heads=4,
              d_ff=128, max_seq=32)
    jm = jtr.BertBase(dtype=jnp.float32, **kw)
    tokens = np.random.RandomState(0).randint(0, 64, (2, 32)).astype(np.int32)
    pos = jtr.sample_masked_positions(np.random.default_rng(0), 2, 32, 5)
    labels = np.take_along_axis(tokens, pos, axis=1)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), tokens[:1], train=False))

    def jloss(p):
        hidden = jm.apply(p, tokens, output="hidden")
        return jtr.masked_lm_loss_gathered(
            hidden, p["params"]["token_embed"]["embedding"], pos, labels)

    tx = optax.adamw(1e-4)
    jstate = tx.init(params)
    jparams = params

    tm = ttr.BertBase(dtype=torch.float32, device="cpu", **kw)
    tm.load_state_dict(params_from_flax(params))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(tm.parameters(), lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=tm.named_parameters())
    hvd.broadcast_parameters(tm.state_dict(), root_rank=0)
    toks, tpos, tlab = map(torch.from_numpy, (tokens, pos, labels))

    for step in (1, 2):
        jl, g = jax.value_and_grad(jloss)(jparams)
        upd, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)

        opt.zero_grad()
        tl = ttr.masked_lm_loss_gathered(tm(toks, output="hidden"),
                                         tm.token_embed, tpos, tlab)
        tl.backward()
        opt.step()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
        got = dict(jax.tree_util.tree_leaves_with_path(grads_to_flax(
            dict(tm.named_parameters()), params)))
        for path, want in jax.tree_util.tree_leaves_with_path(
                jparams["params"]):
            name = jax.tree_util.keystr(path)
            # The key bias shifts every score of a row equally, which the
            # softmax ignores: its true gradient is 0 and both sides hold
            # only rounding noise (~1e-9), which AdamW scales up to moves
            # of +-lr. Those weights are held to 2 * lr per step.
            tol = 2e-4 * step if "['key']['bias']" in name else 1e-6
            np.testing.assert_allclose(got[path], np.asarray(want), rtol=0,
                                       atol=tol, err_msg=name)
