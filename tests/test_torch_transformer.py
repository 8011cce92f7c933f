"""The port's Transformer against the JAX package's flax Transformer.

Tiny BERT and GPT configurations (vocab 128, d 64, 2 layers, 4 heads, seq
32). Flax initialises the parameters; ``params_from_flax`` carries them to
the port; the same numpy tokens go through both. The JAX model's attention
runs the Pallas flash kernels in interpret mode, the port's the plain
version of its Hopper kernels (CPU tensors).

Tolerance 1e-4 (abs and rel) in float32: both sides compute the same
float32 math, but in other orders (XLA's fused dots and softmax vs
PyTorch's), and gradients pass through 2 layers of LayerNorm and softmax,
which amplify the last-bit differences to ~1e-5 at these widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import grads_to_flax, params_from_flax

VOCAB, D, LAYERS, HEADS, FF, SEQ, BATCH = 128, 64, 2, 4, 128, 32, 2
N_PRED = 5
TOL = dict(rtol=1e-4, atol=1e-4)


def _models(causal, jdtype, tdtype):
    kw = dict(vocab_size=VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
              d_ff=FF, max_seq=SEQ, causal=causal)
    jm = jtr.Transformer(dtype=jdtype, **kw)
    tokens = np.random.RandomState(3).randint(0, VOCAB, (BATCH, SEQ)) \
        .astype(np.int32)
    params = jm.init(jax.random.PRNGKey(0), tokens[:1], train=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = ttr.Transformer(dtype=tdtype, device="cpu", **kw)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm, tokens


def _mlm_batch(tokens):
    pos = ttr.sample_masked_positions(np.random.default_rng(0), BATCH, SEQ,
                                      N_PRED)
    return pos, np.take_along_axis(tokens, pos, axis=1)


def _jax_loss(jm, causal, tokens, pos, labels):
    def loss(p):
        if causal:
            return jtr.causal_lm_loss(jm.apply(p, tokens), tokens)
        hidden = jm.apply(p, tokens, output="hidden")
        emb = p["params"]["token_embed"]["embedding"]
        return jtr.masked_lm_loss_gathered(hidden, emb, pos, labels)

    return loss


def _torch_loss(tm, causal, tokens, pos, labels):
    toks = torch.from_numpy(tokens)
    if causal:
        return ttr.causal_lm_loss(tm(toks), toks)
    hidden = tm(toks, output="hidden")
    return ttr.masked_lm_loss_gathered(hidden, tm.token_embed,
                                       torch.from_numpy(pos),
                                       torch.from_numpy(labels))


def test_params_from_flax_roundtrip():
    _, params, tm, _ = _models(False, jnp.float32, torch.float32)
    back = grads_to_flax(dict(tm.named_parameters()), params)
    flat_a = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == len(list(tm.parameters()))
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("causal", [False, True], ids=["bert", "gpt"])
def test_logits_and_hidden_match(causal):
    jm, params, tm, tokens = _models(causal, jnp.float32, torch.float32)
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        np.testing.assert_allclose(tm(toks).numpy(),
                                   np.asarray(jm.apply(params, tokens)), **TOL)
        np.testing.assert_allclose(
            tm(toks, output="hidden").numpy(),
            np.asarray(jm.apply(params, tokens, output="hidden")), **TOL)


def test_pos_offset_matches():
    """A sequence placed at a global offset reads the later position
    embeddings, as under sequence parallelism."""
    kw = dict(vocab_size=VOCAB, d_model=D, num_layers=1, num_heads=HEADS,
              d_ff=FF, max_seq=2 * SEQ, causal=True)
    jm = jtr.Transformer(dtype=jnp.float32, **kw)
    tokens = np.random.RandomState(5).randint(0, VOCAB, (1, SEQ)) \
        .astype(np.int32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), tokens, train=False))
    tm = ttr.Transformer(dtype=torch.float32, device="cpu", **kw)
    tm.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens), pos_offset=SEQ).numpy()
    want = np.asarray(jm.apply(params, tokens, pos_offset=SEQ))
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="max_seq"):
        tm(torch.from_numpy(tokens), pos_offset=SEQ + 1)


@pytest.mark.parametrize("causal", [False, True], ids=["bert", "gpt"])
def test_loss_and_every_gradient_match(causal):
    jm, params, tm, tokens = _models(causal, jnp.float32, torch.float32)
    pos, labels = _mlm_batch(tokens)
    jloss, jgrads = jax.value_and_grad(
        _jax_loss(jm, causal, tokens, pos, labels))(params)
    tloss = _torch_loss(tm, causal, tokens, pos, labels)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    tgrads = grads_to_flax({n: p.grad for n, p in tm.named_parameters()},
                           params)
    want = dict(jax.tree_util.tree_leaves_with_path(jgrads["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(tgrads))
    assert want.keys() == got.keys()
    for path in want:
        np.testing.assert_allclose(got[path], np.asarray(want[path]),
                                   err_msg=jax.tree_util.keystr(path), **TOL)


def test_masked_lm_loss_matches():
    jm, params, tm, tokens = _models(False, jnp.float32, torch.float32)
    mask = (np.random.RandomState(1).rand(BATCH, SEQ) < 0.15).astype(np.int32)
    want = jtr.masked_lm_loss(jm.apply(params, tokens), tokens, mask)
    with torch.no_grad():
        got = ttr.masked_lm_loss(tm(torch.from_numpy(tokens)),
                                 torch.from_numpy(tokens),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_bf16_compute_matches_loosely():
    """bf16 compute on both sides: both round activations to bf16 after
    every dense layer, but at different places inside LayerNorm, GELU and
    the softmax (XLA fuses, PyTorch rounds per op), so single values can
    differ by a few bf16 ulps. Logits (|x| ~ 1) are held to 5e-2 abs and
    the loss to 1e-2 relative."""
    jm, params, tm, tokens = _models(False, jnp.bfloat16, torch.bfloat16)
    pos, labels = _mlm_batch(tokens)
    with torch.no_grad():
        np.testing.assert_allclose(
            tm(torch.from_numpy(tokens)).numpy(),
            np.asarray(jm.apply(params, tokens), np.float32), atol=5e-2)
        tloss = _torch_loss(tm, False, tokens, pos, labels)
    jloss = _jax_loss(jm, False, tokens, pos, labels)(params)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-2)


def test_bert_large_shapes_and_mlm_data():
    """The constructors carry the JAX package's widths (checked on the
    meta device: no memory), and the MLM data helpers are the same
    numpy functions."""
    for jcls, tcls in ((jtr.BertLarge, ttr.BertLarge),
                       (jtr.BertBase, ttr.BertBase),
                       (jtr.GPT2Small, ttr.GPT2Small)):
        m = tcls(vocab_size=VOCAB, device="meta")
        ref = jcls(vocab_size=VOCAB)
        assert (len(m.layers), m.token_embed.shape[1], m.max_seq) == (
            ref.num_layers, ref.d_model, ref.max_seq)
        layer = m.layers[0]
        assert layer.attention.num_heads == ref.num_heads
        assert layer.mlp.wi.out_features == ref.d_ff
        assert layer.attention.causal == ref.causal
    a = jtr.sample_masked_positions(np.random.default_rng(0), 8, 512, 76)
    b = ttr.sample_masked_positions(np.random.default_rng(0), 8, 512, 76)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        jtr.random_tokens(np.random.default_rng(1), 2, 8, 50),
        ttr.random_tokens(np.random.default_rng(1), 2, 8, 50))


@pytest.mark.parametrize("causal", [False, True], ids=["bert", "gpt"])
def test_attention_fn_takes_the_same_weights(causal):
    """``attention_fn`` holds no parameters: the converted JAX weights load
    strictly into a model that has one, and it is called as
    ``attention_fn(q, k, v, causal=...)`` on (batch, heads, seq, head_dim)
    in every layer. With the plain attention on both sides the logits
    match the JAX model's given the JAX package's ``xla_attention``."""
    from horovod_tpu.parallel.tp import xla_attention as jattn
    from horovod_tpu_torch.parallel.tp import xla_attention

    _, params, tm, tokens = _models(causal, jnp.float32, torch.float32)
    seen = []

    def attn(q, k, v, causal):
        seen.append((tuple(q.shape), causal))
        return xla_attention(q, k, v, causal)

    kw = dict(vocab_size=VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
              d_ff=FF, max_seq=SEQ, causal=causal)
    twin = ttr.Transformer(dtype=torch.float32, device="cpu", **kw,
                           attention_fn=attn)
    twin.load_state_dict(params_from_flax(params))  # strict
    assert twin.state_dict().keys() == tm.state_dict().keys()
    jtwin = jtr.Transformer(dtype=jnp.float32, **kw, attention_fn=jattn)
    with torch.no_grad():
        got = twin(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtwin.apply(params, tokens)),
                               **TOL)
    assert seen == [((BATCH, HEADS, SEQ, D // HEADS), causal)] * LAYERS
