"""The port's fused BN + ReLU (``ops/conv_bn_act.py``) against the JAX
package's (``horovod_tpu/ops/pallas/conv_bn_act.py``), on the CPU.

The same numpy inputs go through both; the port's tensors are NCHW in
channels-last memory (the permutation of the JAX side's NHWC arrays), so
both sides hold the channel axis innermost. The port's CPU tensors take
the plain version of kernel B10; the JAX side takes its Pallas kernel in
interpret mode where the shape passes the TPU's lane gating
(``HOROVOD_FUSED_BN_ACT=1``), and jnp elsewhere.

Tolerances: ``scale_bias_act`` is one multiply, one add and a max in
float32 on both sides, so 1e-6 abs. ``FusedBatchNormAct`` uses the JAX
package's own limits for the module (``tests/test_models.py``): outputs
and running statistics 1e-5 rel / 1e-6 abs (batch sums taken in another
order), gradients 1e-4 rel / 1e-5 abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas import conv_bn_act as jcba
from horovod_tpu_torch.ops import conv_bn_act as tcba


def _nchw(a: np.ndarray) -> torch.Tensor:
    """An NHWC numpy array as the port holds it: NCHW, channels-last."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2, 2, shape).astype(np.float32)
    s = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, shape[-1]).astype(np.float32)
    return x, s, b


@pytest.mark.parametrize("shape,pallas", [
    ((2, 16, 16, 64), True),    # 128 % C == 0: lanes tile 2 channel groups
    ((1, 8, 16, 128), True),    # C % 128 == 0
    ((2, 16, 16, 48), False),   # C = 48 packs no lanes: jnp
])
def test_scale_bias_act_matches_jax(shape, pallas, monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSED_BN_ACT", "1")
    took = []
    real = jcba._sba_pallas

    def spy(*args):
        out = real(*args)
        took.append(out is not None)
        return out

    monkeypatch.setattr(jcba, "_sba_pallas", spy)
    x, s, b = _inputs(shape, seed=shape[-1])
    want = np.asarray(jcba.scale_bias_act(jnp.asarray(x), jnp.asarray(s),
                                          jnp.asarray(b)))
    assert took == [pallas]
    got = tcba.scale_bias_act(_nchw(x), torch.from_numpy(s),
                              torch.from_numpy(b))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-6)


def test_scale_bias_act_gradients_match_jax():
    x, s, b = _inputs((2, 5, 5, 24), seed=3)
    g = np.random.RandomState(4).normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(jcba.scale_bias_act, jnp.asarray(x), jnp.asarray(s),
                     jnp.asarray(b))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    xt, st, bt = (t.requires_grad_() for t in
                  (_nchw(x), torch.from_numpy(s), torch.from_numpy(b)))
    tcba.scale_bias_act(xt, st, bt).backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(xt.grad), want[0], rtol=0, atol=1e-6)
    for got, w in ((st.grad, want[1]), (bt.grad, want[2])):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5)


def test_scale_bias_act_checks_its_vectors():
    x = torch.zeros(2, 4, 3, 3)
    with pytest.raises(ValueError, match="shape"):
        tcba.scale_bias_act(x, torch.ones(3), torch.zeros(4))
    with pytest.raises(ValueError, match="float32"):
        tcba.scale_bias_act(x, torch.ones(4, dtype=torch.float64),
                            torch.zeros(4))


def _bn_variables(c, seed):
    """Non-trivial scale, bias and running statistics."""
    rng = np.random.RandomState(seed)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.uniform(-0.5, 0.5, c).astype(np.float32)}
    stats = {"mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return params, stats


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_act_matches_jax(train):
    """Output, updated running statistics and the gradients of x, scale
    and bias."""
    x, _, _ = _inputs((4, 9, 9, 16), seed=11)
    g = np.random.RandomState(12).normal(size=x.shape).astype(np.float32)
    params, stats = _bn_variables(16, seed=13)
    jbn = jcba.FusedBatchNormAct(momentum=0.9, epsilon=1e-3,
                                 dtype=jnp.float32)

    def jax_out(p, xj):
        return jbn.apply({"params": p, "batch_stats": stats}, xj,
                         use_running_average=not train,
                         mutable=["batch_stats"])

    (out, upd), vjp = jax.vjp(jax_out, params, jnp.asarray(x))
    dparams, dx = vjp((jnp.asarray(g), jax.tree_util.tree_map(
        jnp.zeros_like, upd)))

    bn = tcba.FusedBatchNormAct(16, device="cpu").train(train)
    bn.load_state_dict({k: torch.from_numpy(v.copy())
                        for k, v in {**params, **stats}.items()})
    xt = _nchw(x).requires_grad_()
    y = bn(xt)
    y.backward(_nchw(g))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_nhwc(y), np.asarray(out), **tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(upd["batch_stats"][k]), **tol)
    if not train:
        np.testing.assert_array_equal(bn.mean.numpy(), stats["mean"])
    gtol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), **gtol)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(bn, k).grad.numpy(),
                                   np.asarray(dparams[k]), **gtol)


def test_batch_norm_act_has_flax_variables_only():
    bn = tcba.FusedBatchNormAct(8, device="cpu")
    assert sorted(bn.state_dict()) == ["bias", "mean", "scale", "var"]
    assert all(t.dtype == torch.float32 for t in bn.state_dict().values())


def test_bn_stats_matches_jax():
    x, _, _ = _inputs((3, 7, 5, 12), seed=21)
    jm, jv = jcba.bn_stats(jnp.asarray(x))
    tm, tv = tcba.bn_stats(_nchw(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
