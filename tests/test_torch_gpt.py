"""The port's GPT path against the JAX package: a tiny GPT trained under
the fused attention backward, the chunked causal loss, and the GPT-2
constructors.

The tiny GPT (2 layers, d 128, 2 heads, S 64, vocab 512) runs with
``FLASH_FUSED_BWD=1`` on both sides: the JAX package's attention backward
is its fused Pallas kernel in interpret mode, the port's is the fused
kernel's plain version (CPU tensors). Flax initialises the parameters and
``params_from_flax`` carries them across; the same numpy tokens go
through both. Tolerance 1e-4 (abs and rel) in float32, as
``tests/test_torch_transformer.py``: the same float32 math in other orders,
amplified through two layers of LayerNorm and softmax.

``causal_lm_loss_chunked`` is held against the JAX version and the port's
full-logits loss, value and gradients, at 1e-5: float32 sums of 63 x 2
cross-entropies in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import grads_to_flax, params_from_flax
from horovod_tpu_torch.ops import flash_attention as tfa

VOCAB, D, LAYERS, HEADS, FF, SEQ, BATCH = 512, 128, 2, 2, 256, 64, 2
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def _tiny_gpt():
    kw = dict(vocab_size=VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
              d_ff=FF, max_seq=SEQ, causal=True)
    jm = jtr.Transformer(dtype=jnp.float32, **kw)
    tokens = np.random.RandomState(4).randint(0, VOCAB, (BATCH, SEQ)) \
        .astype(np.int32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), tokens[:1], train=False))
    tm = ttr.Transformer(dtype=torch.float32, device="cpu", **kw)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm, tokens


def test_tiny_gpt_under_the_fused_backward_matches_jax(monkeypatch):
    """Loss and every parameter gradient of a tiny GPT, both sides on their
    fused attention backward (the port's counted at its wrapper: once per
    layer)."""
    monkeypatch.setenv("FLASH_FUSED_BWD", "1")
    calls = [0]
    real = tfa.flash_bwd_fused

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    monkeypatch.setattr(tfa, "flash_bwd_fused", counted)
    jm, params, tm, tokens = _tiny_gpt()
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtr.causal_lm_loss(jm.apply(p, tokens), tokens))(params)
    toks = torch.from_numpy(tokens)
    tloss = ttr.causal_lm_loss(tm(toks), toks)
    tloss.backward()
    assert calls[0] == LAYERS
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(grads_to_flax(
        {n: p.grad for n, p in tm.named_parameters()}, params)))
    want = dict(jax.tree_util.tree_leaves_with_path(jgrads["params"]))
    assert want.keys() == got.keys()
    for path in want:
        np.testing.assert_allclose(got[path], np.asarray(want[path]),
                                   err_msg=jax.tree_util.keystr(path), **TOL)


def _loss_inputs(seed=6, b=2, s=64, d=32, vocab=96):
    rng = np.random.RandomState(seed)
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    embed = (0.1 * rng.normal(size=(vocab, d))).astype(np.float32)
    tokens = rng.randint(0, vocab, (b, s)).astype(np.int32)
    return hidden, embed, tokens


@pytest.mark.parametrize("chunk", [16, 64])
def test_causal_lm_loss_chunked_matches_jax_and_the_full_loss(chunk):
    hidden, embed, tokens = _loss_inputs()
    jloss, jgrads = jax.value_and_grad(
        lambda h, e: jtr.causal_lm_loss_chunked(h, e, tokens, chunk=chunk),
        argnums=(0, 1))(hidden, embed)
    h, e = (torch.from_numpy(x).requires_grad_() for x in (hidden, embed))
    toks = torch.from_numpy(tokens)
    loss = ttr.causal_lm_loss_chunked(h, e, toks, chunk=chunk)
    grads = torch.autograd.grad(loss, (h, e))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **LOSS_TOL)
    # the port's own full-logits loss: the same function
    full = ttr.causal_lm_loss((h @ e.T).float(), toks)
    full_grads = torch.autograd.grad(full, (h, e))
    np.testing.assert_allclose(float(loss.detach()), float(full.detach()),
                               **LOSS_TOL)
    for a, b in zip(grads, full_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LOSS_TOL)


def test_causal_lm_loss_chunked_refuses_a_chunk_that_does_not_divide():
    hidden, embed, tokens = map(torch.from_numpy, _loss_inputs(s=48))
    with pytest.raises(ValueError, match=r"chunk \(32\) must divide seq "
                                         r"\(48\)"):
        ttr.causal_lm_loss_chunked(hidden, embed, tokens, chunk=32)


@pytest.mark.parametrize("name", ["GPT2Small", "GPT2Medium"])
def test_gpt2_constructors_match_the_jax_parameter_counts(name):
    """At vocab 50257 on the meta device: the same number of parameter
    tensors and elements as the JAX model's ``jax.eval_shape`` init."""
    tm = getattr(ttr, name)(vocab_size=50257, device="meta")
    jm = getattr(jtr, name)(vocab_size=50257)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), train=False))
    leaves = jax.tree_util.tree_leaves(shapes["params"])
    params = list(tm.parameters())
    assert len(params) == len(leaves)
    assert sum(p.numel() for p in params) == sum(
        int(np.prod(x.shape)) for x in leaves)
    assert (len(tm.layers), tm.token_embed.shape[1], tm.max_seq) == (
        jm.num_layers, jm.d_model, jm.max_seq)
    assert tm.layers[0].attention.num_heads == jm.num_heads
    assert tm.layers[0].attention.causal
