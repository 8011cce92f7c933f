"""The port's AdamW kernels' plain paths against the JAX package.

* ``fused_adamw`` (multi-tensor kernel B9; its plain version on the CPU)
  against the JAX ``fused_adamw``, whose Pallas kernel runs in interpret
  mode on the CPU as ``tests/test_optimizer.py`` runs it: leaves of 32,768
  and 256 x 128 elements take the kernel there, a 7-element leaf the jnp
  path.
* ``flat_adamw_shard`` (flat kernel B8) against the JAX one with its Pallas
  kernel forced on in interpret mode.
* The optax <-> port AdamW state converters, and the fused AdamW step on a
  tiny BERT against the JAX package's ``value_and_grad`` + ``fused_adamw``.

Limits: rtol 2e-6 / atol 1e-7. Both sides compute the same float32
operations in the same order; the bias corrections ``1/(1-b^t)`` come from
XLA's float32 power on one side and numpy's on the other, which may differ
in the last bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as jtr
from horovod_tpu.ops.pallas import fused_optimizer as jfused_opt
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import (adam_state_from_optax,
                                              adam_state_to_optax,
                                              grads_to_flax, params_from_flax)
from horovod_tpu_torch.ops import fused_adamw as tfa
from horovod_tpu_torch.ops import fused_optimizer as tfo

# the package re-exports the function under the module's name
jfused_adamw = importlib.import_module("horovod_tpu.ops.pallas.fused_adamw")
RTOL, ATOL = 2e-6, 1e-7


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"big": rng.randn(16384 * 2).astype(np.float32),
            "mat": rng.randn(256, 128).astype(np.float32),
            "small": rng.randn(7).astype(np.float32)}


def test_fused_adamw_matches_jax_four_steps():
    lr, wd = 1e-2, 1e-3
    params = _tree(0)
    jopt = jfused_adamw.fused_adamw(lr, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    topt = tfa.fused_adamw(lr, weight_decay=wd)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    for step in range(4):
        grads = _tree(10 + step)
        jp, js = jopt.apply(jp, js, {k: jnp.asarray(v)
                                     for k, v in grads.items()})
        out, ts = topt.apply(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in grads.items()})
        assert out is tp  # updated in place
        for k in params:
            for got, want in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]),
                              (ts.nu[k], js.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"step {step} {k}")
    assert ts.count == int(js.count) == 4


def test_fused_adamw_mixed_dtypes_follow_the_plain_leaf():
    """A bf16 parameter with f32 moments and a bf16 gradient: p, m and v
    keep their dtypes, the math runs in f32 (``_jnp_leaf``), as the JAX
    package's jnp path computes it."""
    rng = np.random.RandomState(3)
    p = rng.randn(300).astype(np.float32)
    g = rng.randn(300).astype(np.float32)
    p16 = torch.from_numpy(p).to(torch.bfloat16)
    tp = {"w": p16.clone()}
    opt = tfa.fused_adamw(1e-2)
    st = opt.init(tp)
    st = st._replace(mu={"w": torch.zeros(300)}, nu={"w": torch.zeros(300)})
    tg = {"w": torch.from_numpy(g).to(torch.bfloat16)}
    _, st = opt.apply(tp, st, tg)
    jp = jnp.asarray(p16.float().numpy()).astype(jnp.bfloat16)
    sc = jnp.asarray(tfa.adamw_scalars(1, 0.9, 0.999, 1e-2, 1e-4))
    want = jfused_adamw._jnp_leaf(jp, jnp.zeros(300), jnp.zeros(300),
                                  jnp.asarray(g).astype(jnp.bfloat16), sc,
                                  1e-8)
    assert tp["w"].dtype == torch.bfloat16 and st.mu["w"].dtype == torch.float32
    np.testing.assert_array_equal(tp["w"].float().numpy(),
                                  np.asarray(want[0]).astype(np.float32))
    np.testing.assert_allclose(st.mu["w"].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.nu["w"].numpy(), np.asarray(want[2]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_flat_adamw_shard_matches_jax_kernel(monkeypatch, out_dtype):
    monkeypatch.setenv("HOROVOD_SHARDED_FUSED_KERNEL", "1")
    monkeypatch.setenv("HOROVOD_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(5)
    n = 16384 * 2
    master = rng.randn(n).astype(np.float32)
    mu = (1e-2 * rng.randn(n)).astype(np.float32)
    nu = (1e-4 * rng.rand(n)).astype(np.float32)
    grad = rng.randn(n).astype(np.float32)
    sc = tfa.adamw_scalars(3, 0.9, 0.999, 1e-2, 1e-3)
    want = jfused_opt.flat_adamw_shard(
        *map(jnp.asarray, (master, mu, nu, grad)), jnp.asarray(sc), eps=1e-8,
        out_dtype=getattr(jnp, out_dtype))
    tw, tm, tv = (torch.from_numpy(a.copy()) for a in (master, mu, nu))
    got = tfo.flat_adamw_shard(tw, tm, tv, torch.from_numpy(grad), sc,
                               eps=1e-8, out_dtype=getattr(torch, out_dtype))
    assert got[1] is tw and got[2] is tm and got[3] is tv  # in place
    assert got[0].dtype == getattr(torch, out_dtype)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w).astype(np.float32),
                                   rtol=RTOL, atol=ATOL)


def test_flat_adamw_rejects_bad_shards():
    z = torch.zeros(8)
    with pytest.raises(ValueError, match="1-D float32"):
        tfo.flat_adamw_shard(z.double(), z, z, z, np.zeros(6, np.float32),
                             eps=1e-8, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="lengths differ"):
        tfo.flat_adamw_shard(z, z, z, torch.zeros(4), np.zeros(6, np.float32),
                             eps=1e-8, out_dtype=torch.float32)


def _tiny_bert():
    kw = dict(vocab_size=64, d_model=64, num_layers=2, num_heads=4,
              d_ff=128, max_seq=32)
    jm = jtr.BertBase(dtype=jnp.float32, **kw)
    tokens = np.random.RandomState(0).randint(0, 64, (2, 32)).astype(np.int32)
    pos = jtr.sample_masked_positions(np.random.default_rng(0), 2, 32, 5)
    labels = np.take_along_axis(tokens, pos, axis=1)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), tokens[:1], train=False))
    return kw, jm, tokens, pos, labels, params


def test_adam_state_converters_round_trip():
    """optax's ScaleByAdamState (a flax-shaped mu/nu) -> the port's state
    (torch layouts) -> back gives the same arrays; the port's layouts are
    those of the weights."""
    _, _, _, _, _, params = _tiny_bert()
    rng = np.random.RandomState(1)
    mu = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(
        lambda a: rng.rand(*a.shape).astype(np.float32), params)
    st = adam_state_from_optax(np.int32(7), mu, nu)
    assert st.count == 7
    tw = params_from_flax(mu)
    assert st.mu.keys() == tw.keys()
    for k in tw:
        np.testing.assert_array_equal(st.mu[k].numpy(), tw[k].numpy())
    count, mu2, nu2 = adam_state_to_optax(st, params)
    assert count == 7 and count.dtype == np.int32
    for a, b in ((mu, mu2), (nu, nu2)):
        assert jax.tree_util.tree_structure(a) \
            == jax.tree_util.tree_structure(b)
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(x, y)


def test_bert_two_steps_fused_adamw_match_jax():
    """P1 at world 1 on a tiny BERT: the port's forward, backward,
    ``allreduce_gradients`` and ``fused_adamw`` against the JAX
    ``value_and_grad`` + ``fused_adamw``, held to the limits of
    ``test_torch_dp.py``'s AdamW steps (parameters 1e-6 abs; the key bias,
    whose true gradient is 0, 2 * lr per step)."""
    kw, jm, tokens, pos, labels, params = _tiny_bert()

    def jloss(p):
        hidden = jm.apply(p, tokens, output="hidden")
        return jtr.masked_lm_loss_gathered(
            hidden, p["params"]["token_embed"]["embedding"], pos, labels)

    jopt = jfused_adamw.fused_adamw(1e-4)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)

    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        tm = ttr.BertBase(dtype=torch.float32, device="cpu", **kw)
        tm.load_state_dict(params_from_flax(params))
        tp = dict(tm.named_parameters())
        topt = tfa.fused_adamw(1e-4)
        tstate = topt.init(tp)
        toks, tpos, tlab = map(torch.from_numpy, (tokens, pos, labels))
        for step in (1, 2):
            jl, g = jax.value_and_grad(jloss)(jparams)
            jparams, jstate = jopt.apply(jparams, jstate, g)
            tm.zero_grad(set_to_none=True)
            tl = ttr.masked_lm_loss_gathered(tm(toks, output="hidden"),
                                             tm.token_embed, tpos, tlab)
            tl.backward()
            grads = hvd.allreduce_gradients(
                {k: p.grad for k, p in tp.items()}, average=True)
            _, tstate = topt.apply(tp, tstate, grads)
            np.testing.assert_allclose(float(tl.detach()), float(jl),
                                       rtol=1e-5)
            got = dict(jax.tree_util.tree_leaves_with_path(
                grads_to_flax(tp, params)))
            for path, want in jax.tree_util.tree_leaves_with_path(
                    jparams["params"]):
                name = jax.tree_util.keystr(path)
                tol = 2e-4 * step if "['key']['bias']" in name else 1e-6
                np.testing.assert_allclose(got[path], np.asarray(want),
                                           rtol=0, atol=tol, err_msg=name)
    finally:
        hvd.shutdown()
