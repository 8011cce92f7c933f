"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the plain versions of its Hopper kernels
(CPU tensors); the JAX package's ``flash_attention`` runs its Pallas
kernels in interpret mode, as its own tests do. The same numpy inputs go to
both. Cases cover causal and not, head_dim 64 and 128, the JAX package's
single-block kernels (default blocks, S <= block) and its multi-block
kernels (blocks of 64), offsets q_offset != k_offset, q and k of different
lengths, and rows with every key masked.

Tolerance 2e-5 abs in float32: both sides compute the same float32
softmax and products, in other orders (base-2 online softmax over blocks
on the JAX side, one exp over the whole row here), which moves values of
magnitude ~1 by a few float32 ulps summed over <= 256 keys.

``tests/test_torch_kernels.py`` holds the CUDA kernels against the same
plain versions on the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa

# the package re-exports the function under the module's name
jfa = importlib.import_module("horovod_tpu.ops.pallas.flash_attention")

ATOL = 2e-5
SINGLE = {}  # the JAX defaults: every S here fits one block
MULTI = dict(block_q=64, block_k=64, bwd_block_q=64, bwd_block_k=64)


def _inputs(b, h, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    w = rng.normal(size=(b, h, sq, d)).astype(np.float32)  # cotangent
    return q, k, v, w


def _jax(q, k, v, w, blocks, **kw):
    fwd_blocks = {n: blocks[n] for n in ("block_q", "block_k") if n in blocks}
    o, lse = jfa.flash_attention_partial(q, k, v, **kw, **fwd_blocks)
    grads = jax.grad(
        lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v, **kw, **blocks)
                                * w), argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(x) for x in (o, lse, *grads)]


def _torch(q, k, v, w, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(qt, kt, vt, **kw)
    (o * torch.from_numpy(w)).sum().backward()
    with torch.no_grad():
        o2, lse = tfa.flash_attention_partial(qt, kt, vt, **kw)
    np.testing.assert_array_equal(o.detach().numpy(), o2.numpy())
    return [x.detach().numpy() for x in (o, lse, qt.grad, kt.grad, vt.grad)]


def _compare(got, want):
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("blocks", [SINGLE, MULTI], ids=["single", "multi"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_matches_jax_kernels(causal, d, blocks):
    q, k, v, w = _inputs(1, 2, 128, 128, d)
    _compare(_torch(q, k, v, w, causal=causal),
             _jax(q, k, v, w, blocks, causal=causal))


@pytest.mark.parametrize("offsets", [(128, 0), (16, 48), (0, 40)],
                         ids=["past-keys", "partial", "ragged-wedge"])
def test_offsets_match_jax_kernels(offsets):
    q_off, k_off = offsets
    q, k, v, w = _inputs(2, 2, 128, 128, 64, seed=1)
    kw = dict(causal=True, q_offset=q_off, k_offset=k_off)
    _compare(_torch(q, k, v, w, **kw), _jax(q, k, v, w, MULTI, **kw))


def test_unequal_lengths_and_scale_match_jax_kernels():
    """A query shard against a longer key extent (ring attention's shape),
    with an explicit softmax scale."""
    q, k, v, w = _inputs(1, 2, 64, 128, 64, seed=2)
    kw = dict(causal=True, q_offset=64, k_offset=0, sm_scale=0.3)
    _compare(_torch(q, k, v, w, **kw), _jax(q, k, v, w, MULTI, **kw))


def test_fully_masked_rows():
    """Queries before every key: o 0, lse -inf, finite zero gradients —
    and the same from the JAX kernels."""
    q, k, v, w = _inputs(1, 2, 128, 128, 64, seed=3)
    kw = dict(causal=True, q_offset=0, k_offset=64)
    got = _torch(q, k, v, w, **kw)
    o, lse, dq, dk, dv = got
    assert np.all(o[:, :, :64] == 0) and np.all(lse[:, :, :64] == -np.inf)
    assert all(np.isfinite(g).all() for g in (dq, dk, dv))
    assert np.all(dq[:, :, :64] == 0)
    _compare(got, _jax(q, k, v, w, MULTI, **kw))


def test_delta_and_backward_pieces_match_jax():
    """``compute_delta`` and the dq / dk-dv plain versions, one by one,
    against the JAX package's delta and gradients."""
    q, k, v, w = _inputs(1, 2, 64, 64, 64, seed=4)
    kw = dict(causal=True, sm_scale=0.125, q_offset=0, k_offset=0)
    o, lse = tfa.flash_fwd(*map(torch.from_numpy, (q, k, v)), **kw)
    do = torch.from_numpy(w)
    delta = tfa.compute_delta(o, do)
    np.testing.assert_allclose(
        delta.numpy(), np.asarray(jfa.compute_delta(o.numpy(), w))[..., 0],
        atol=ATOL)
    args = (*map(torch.from_numpy, (q, k, v)), do, lse, delta)
    dq = tfa.flash_bwd_dq(*args, **kw)
    dk, dv = tfa.flash_bwd_dkv(*args, **kw)
    want = _jax(q, k, v, w, SINGLE, causal=True)[2:]
    for a, b in zip((dq, dk, dv), want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL)


def test_rejects_bad_shapes():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        tfa.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError):
        tfa.flash_attention(q, torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q.to("meta"), q)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "layout"])
def test_kernel_input_checks(bad):
    """What the CUDA kernels refuse, checked before any launch."""
    q = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    if bad == "dtype":
        q = q.float()
    elif bad == "head_dim":
        q = torch.zeros(1, 2, 16, 32, dtype=torch.bfloat16)
    else:
        q = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        tfa._check_kernel_inputs(q, q, q)
