"""The port's transformer options ``fused_qkv`` and ``remat`` against the
JAX package's (``horovod_tpu/models/transformer.py:99, 118-126, 288,
374-375``), on the CPU.

Tiny BERT and GPT configurations (vocab 128, d 64, 2 layers, 4 heads, seq
32), float32, as ``tests/test_torch_transformer.py``: flax initialises,
``params_from_flax`` carries the tree across (the fused ``qkv`` kernel
``(d, 3, heads, head_dim)`` included), the same numpy tokens go through
both. Limits:

* against JAX, logits, the loss and every gradient 1e-4 (abs and rel), the
  limit of the unfused parity test (the same float32 math in other
  orders);
* within the port, a fused model built from an unfused one's weights
  (:func:`fuse_qkv_state`) gives bit-equal logits, loss and gradients (the
  unfused path multiplies by the same concatenated weights), and
  ``remat=True`` bit-equal gradients to ``remat=False`` (the recomputed
  forward is the same float32 program).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import grads_to_flax, params_from_flax
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops import flash_attention as tfa

VOCAB, D, LAYERS, HEADS, FF, SEQ, BATCH = 128, 64, 2, 4, 128, 32, 2
N_PRED = 5
TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(vocab_size=VOCAB, d_model=D, num_layers=LAYERS, num_heads=HEADS,
          d_ff=FF, max_seq=SEQ)


def _tokens():
    return np.random.RandomState(3).randint(0, VOCAB, (BATCH, SEQ)) \
        .astype(np.int32)


def _mlm(tokens):
    pos = ttr.sample_masked_positions(np.random.default_rng(0), BATCH, SEQ,
                                      N_PRED)
    return pos, np.take_along_axis(tokens, pos, axis=1)


def _jax_loss(jm, causal, tokens):
    pos, labels = _mlm(tokens)

    def loss(p):
        if causal:
            return jtr.causal_lm_loss(jm.apply(p, tokens), tokens)
        hidden = jm.apply(p, tokens, output="hidden")
        emb = p["params"]["token_embed"]["embedding"]
        return jtr.masked_lm_loss_gathered(hidden, emb, pos, labels)

    return loss


def _torch_loss(tm, causal, tokens):
    toks = torch.from_numpy(tokens)
    if causal:
        return ttr.causal_lm_loss(tm(toks), toks)
    pos, labels = _mlm(tokens)
    return ttr.masked_lm_loss_gathered(tm(toks, output="hidden"),
                                       tm.token_embed, torch.from_numpy(pos),
                                       torch.from_numpy(labels))


def _grads(tm):
    return {n: p.grad.clone() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("causal,remat", [(False, False), (True, True)],
                         ids=["bert", "gpt-remat"])
def test_fused_qkv_matches_jax(causal, remat):
    """The JAX model with ``fused_qkv=True`` (and, for GPT, ``remat=True``)
    against the port's with the same options: logits, the loss and every
    gradient."""
    jm = jtr.Transformer(dtype=jnp.float32, causal=causal, fused_qkv=True,
                         remat=remat, **KW)
    tokens = _tokens()
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jm.init(key, tokens[:1], train=False))(
        jax.random.PRNGKey(0)))
    assert "qkv" in params["params"]["layer_0"]["attention"]
    tm = ttr.Transformer(dtype=torch.float32, device="cpu", causal=causal,
                         fused_qkv=True, remat=remat, **KW)
    tm.load_state_dict(params_from_flax(params))
    assert tm.layers[0].attention.qkv.weight.shape == (3 * D, D)
    with torch.no_grad():
        np.testing.assert_allclose(
            tm(torch.from_numpy(tokens)).numpy(),
            np.asarray(jax.jit(lambda p: jm.apply(p, tokens))(params)), **TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        _jax_loss(jm, causal, tokens)))(params)
    tloss = _torch_loss(tm, causal, tokens)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(grads_to_flax(
        _grads(tm), params)))
    want = dict(jax.tree_util.tree_leaves_with_path(jgrads["params"]))
    assert got.keys() == want.keys() and len(want) == len(
        list(tm.parameters()))
    for path in want:
        np.testing.assert_allclose(got[path], np.asarray(want[path]),
                                   err_msg=jax.tree_util.keystr(path), **TOL)


def test_fused_qkv_roundtrips_through_the_flax_tree():
    jm = jtr.Transformer(dtype=jnp.float32, fused_qkv=True, **KW)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jm.init(key, _tokens()[:1], train=False))(
        jax.random.PRNGKey(1)))
    tm = ttr.Transformer(dtype=torch.float32, device="cpu", fused_qkv=True,
                         **KW)
    tm.load_state_dict(params_from_flax(params))
    back = dict(jax.tree_util.tree_leaves_with_path(grads_to_flax(
        dict(tm.named_parameters()), params)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"]):
        np.testing.assert_array_equal(back[path], leaf)


@pytest.mark.parametrize("causal", [False, True], ids=["bert", "gpt"])
def test_fused_equals_unfused_from_concatenated_weights(causal):
    """After ``tests/test_models.py``'s fused-vs-unfused case: the fused
    model built from the unfused one's weights is the same function, bit
    for bit, and its ``qkv`` gradient is the unfused three's, stacked."""
    unfused = ttr.Transformer(dtype=torch.float32, device="cpu",
                              causal=causal, seed=4, **KW)
    fused = ttr.Transformer(dtype=torch.float32, device="cpu", causal=causal,
                            fused_qkv=True, **KW)
    fused.load_state_dict(ttr.fuse_qkv_state(unfused.state_dict()))
    tokens = _tokens()
    losses = [_torch_loss(m, causal, tokens) for m in (unfused, fused)]
    assert torch.equal(losses[0], losses[1])
    for loss in losses:
        loss.backward()
    gu, gf = _grads(unfused), _grads(fused)
    for i in range(LAYERS):
        a = f"layers.{i}.attention"
        for leaf in ("weight", "bias"):
            assert torch.equal(gf.pop(f"{a}.qkv.{leaf}"), torch.cat(
                [gu.pop(f"{a}.{n}.{leaf}") for n in ("query", "key",
                                                    "value")]))
    assert gu.keys() == gf.keys()
    for k in gu:
        assert torch.equal(gu[k], gf[k]), k


@pytest.mark.parametrize("fused_qkv", [False, True], ids=["qkv", "fused"])
def test_remat_gradients_bit_equal_and_forward_runs_twice(monkeypatch,
                                                          fused_qkv):
    """``remat=True`` gives the same loss and gradients, bit for bit; its
    backward runs each layer's flash forward again (2 x layers forwards
    a step, one backward a layer)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_fwd, tfa.flash_bwd_dq

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(tfa, "flash_fwd", count_fwd)
    monkeypatch.setattr(tfa, "flash_bwd_dq", count_bwd)
    tokens = _tokens()
    out = {}
    for remat in (False, True):
        tm = ttr.Transformer(dtype=torch.float32, device="cpu", causal=False,
                             seed=2, remat=remat, fused_qkv=fused_qkv, **KW)
        calls.update(fwd=0, bwd=0)
        loss = _torch_loss(tm, False, tokens)
        loss.backward()
        out[remat] = (loss.detach(), _grads(tm), dict(calls))
    assert torch.equal(out[False][0], out[True][0])
    assert out[False][1].keys() == out[True][1].keys()
    for k, g in out[False][1].items():
        assert torch.equal(g, out[True][1][k]), k
    assert out[False][2] == {"fwd": LAYERS, "bwd": LAYERS}
    assert out[True][2] == {"fwd": 2 * LAYERS, "bwd": LAYERS}


def test_remat_keeps_one_allreduce_a_parameter_a_step(monkeypatch):
    """Under ``remat`` the ``DistributedOptimizer`` hooks still fire once a
    parameter a step (the recomputed forward accumulates no gradient), at
    world 1 on the CPU; no-grad forwards skip the checkpoint."""
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        tm = ttr.Transformer(dtype=torch.float32, device="cpu", causal=True,
                             remat=True, fused_qkv=True, **KW)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(tm.parameters(), lr=0.1),
            named_parameters=tm.named_parameters())
        toks = torch.from_numpy(_tokens())
        losses = []
        for _ in range(2):
            collectives.reset_counts()
            opt.zero_grad()
            loss = ttr.causal_lm_loss(tm(toks), toks)
            loss.backward()
            opt.step()
            losses.append(loss.item())
            assert collectives.COUNTS["allreduce"] == len(
                list(tm.parameters()))
        assert losses[1] < losses[0]
        with torch.no_grad():
            assert tm(toks).shape == (BATCH, SEQ, VOCAB)
    finally:
        hvd.shutdown()
